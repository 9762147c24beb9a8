"""The raw-stream receiver in two stages: detect and align, then the chain.

The counterpart of ``tpu80211/pipeline/raw.py``: lane-major (NS, B) raw
sample streams in, the fused chain's estimates and equalized blocks out.
Stage 1 (``detect_and_align``) finds each stream's frame and cuts its
160 + 1200 rows; stage 2 (``fused_rx_chain_txconst``) runs the
seven-estimator chain on them.  The aligned rows go through device memory
between the two; ``kernels/raw_chain.py`` does both in one kernel.

Undetected streams are cut at row 0 and processed like the others: gate
on ``detected`` before using their estimates.
"""

from __future__ import annotations

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels.detect_kernel import DEFAULT_THRESHOLD, detect_and_align
from tpu80211_torch.kernels.fused_chain import fused_rx_chain_txconst


def raw_rx_txconst(x: Cplx, lts_ref: Cplx, txs: Cplx, tpre: Cplx,
                   threshold: float | None = None, eps=0.0, serve: bool = False,
                   sync: bool = False, search: int = 192, advance: int = 4,
                   wiener_model: str | None = None, wiener_snr_db: float | None = None,
                   equalize_with: str = "h_linear") -> dict:
    """The raw-stream receiver for (NS, B) streams: ``lts_ref`` is the (64,)
    float32 LTS, ``txs``/``tpre`` the tx-constant spectra
    (``fused_chain.tx_spectra``).  Returns the fused chain's dict plus the
    detector's ``detected``, ``start`` and ``metric`` rows.  ``eps`` scales
    the samples inside the chain (detection is scale-free)."""
    thr = DEFAULT_THRESHOLD if threshold is None else threshold
    det, lp, pkt = detect_and_align(x, lts_ref, thr, search, advance)
    out = fused_rx_chain_txconst(txs, tpre, pkt, lp, eps=eps, serve=serve, sync=sync,
                                 wiener_model=wiener_model, wiener_snr_db=wiener_snr_db,
                                 equalize_with=equalize_with)
    out.update(detected=det["detected"], start=det["start"], metric=det["metric"])
    return out
