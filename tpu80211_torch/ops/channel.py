"""Channel-model power-delay profiles (the Wiener interpolator's prior).

The reference names channel models A–E (WiFi_RX.m:6), the ETSI BRAN
indoor models; each is an exponential power-delay profile with the ETSI
rms delay spread, sampled at the receiver rate.  ``model=None`` is the
legacy profile (rms 2.0 samples, 8 taps).
"""

from __future__ import annotations

import numpy as np

CHANNEL_MODELS = {
    "A": 50e-9,
    "B": 100e-9,
    "C": 150e-9,
    "D": 140e-9,
    "E": 250e-9,
}

LEGACY_RMS_SAMPLES = 2.0
LEGACY_N_TAPS = 8


def rms_samples(model: str | None, sample_rate_hz: float = 20e6) -> float:
    """RMS delay spread in samples at ``sample_rate_hz``."""
    if model is None:
        return LEGACY_RMS_SAMPLES
    return CHANNEL_MODELS[model.upper()] * sample_rate_hz


def n_taps_for(model: str | None, sample_rate_hz: float = 20e6) -> int:
    """FIR length covering ~5 rms spreads, clipped to [8, 16] (16 is the
    cyclic prefix, so no tap leaks across blocks)."""
    if model is None:
        return LEGACY_N_TAPS
    taps = int(np.ceil(5.0 * rms_samples(model, sample_rate_hz))) + 1
    return int(np.clip(taps, LEGACY_N_TAPS, 16))


def pdp(model: str | None = None, sample_rate_hz: float = 20e6,
        n_taps: int | None = None) -> np.ndarray:
    """Normalized exponential power-delay profile, shape (n_taps,)."""
    rms = rms_samples(model, sample_rate_hz)
    if n_taps is None:
        n_taps = n_taps_for(model, sample_rate_hz)
    p = np.exp(-np.arange(n_taps) / rms)
    return p / p.sum()
