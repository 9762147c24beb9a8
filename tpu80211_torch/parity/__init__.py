"""The parity oracles (the counterpart of ``tpu80211/parity``): the 80-bit
numpy oracle (`oracle_np`) and the bindings to the native x87 oracle
(`oracle_native`), both independent of the estimators they check."""
