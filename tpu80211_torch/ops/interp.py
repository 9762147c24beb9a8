"""Pilot-to-subcarrier interpolation as static (4, 53) matrices.

Every pilot-based LS estimator of the reference — linear
(WiFi_channel_estimation_PS_Linear.m), cubic divided differences
(..._PS_Cubic.m), sinc (..._PS_Sinc.m) and the csapi spline
(..._PS_Third.m) — is linear in the four pilot ratios, so each is one
matrix ``W`` with ``H = H_pilots @ W``.  The Wiener interpolator is the
MMSE-optimal map under a power-delay-profile prior.  Built once in
float64 numpy.
"""

from __future__ import annotations

import functools

import numpy as np

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode

_K = np.arange(C.N_SC, dtype=np.float64)  # 0-based subcarrier index 0..52
_P = np.asarray(C.PILOT_IDX, dtype=np.float64)  # 5, 19, 33, 47
_D = float(C.PILOT_DELTA)  # 14


def _linear_matrix() -> np.ndarray:
    """Piecewise-linear weights; the pilot-2→pilot-3 slope extends past
    the last pilot (..._PS_Linear.m:17-19, main.c:96-99)."""
    W = np.zeros((C.N_PILOTS, C.N_SC))
    seg = np.clip(((_K[None, :] >= _P[:3, None]).sum(0) - 1), 0, 2)  # 0,1,2
    alpha = (_K - _P[seg]) / _D
    for k in range(C.N_SC):
        s = seg[k]
        W[s, k] += 1.0 - alpha[k]
        W[s + 1, k] += alpha[k]
    return W


def _newton_cubic_matrix(uniform_denoms: bool) -> np.ndarray:
    """Newton divided-difference cubic through the 4 pilots.

    MATLAB divides by 14/14/14, 28/28, 42 (..._PS_Cubic.m:8-13); the C
    code by 14 throughout (main.c:113-118), ``uniform_denoms=True``."""
    if uniform_denoms:
        d01 = d12 = d23 = d012 = d123 = d0123 = _D
    else:
        d01 = d12 = d23 = _D
        d012 = d123 = 2 * _D
        d0123 = 3 * _D
    # rows of M express [f0, f01, f012, f0123] in terms of the pilots
    M = np.zeros((4, 4))
    M[0, 0] = 1.0
    f01 = np.array([-1.0, 1.0, 0.0, 0.0]) / d01
    f12 = np.array([0.0, -1.0, 1.0, 0.0]) / d12
    f23 = np.array([0.0, 0.0, -1.0, 1.0]) / d23
    M[1] = f01
    f012 = (f12 - f01) / d012
    f123 = (f23 - f12) / d123
    M[2] = f012
    M[3] = (f123 - f012) / d0123
    x1, x2, x3 = _K - _P[0], _K - _P[1], _K - _P[2]
    V = np.stack([np.ones_like(_K), x1, x1 * x2, x1 * x2 * x3], axis=1)  # (53,4)
    return (V @ M).T  # (4,53)


def _sinc_matrix() -> np.ndarray:
    """H(k) = Σ_p H_pilots[p]·sinc((k−P_p)/14) (..._PS_Sinc.m, main.c:135-144)."""
    x = (_K[None, :] - _P[:, None]) / _D
    return np.sinc(x)


def _spline_matrix() -> np.ndarray:
    """csapi's not-a-knot spline through exactly 4 knots is the cubic
    through them — the MATLAB Newton cubic (WiFi_RX.m:50)."""
    return _newton_cubic_matrix(uniform_denoms=False)


def _wiener_matrix(snr_db: float = 20.0, n_taps: int = 8,
                   rms_spread: float = 2.0,
                   pdp: tuple | None = None) -> np.ndarray:
    """MMSE-optimal (Wiener) pilot interpolator, complex (4, 53).

    W = (R_pp + σ²I)⁻ᵀ R_kpᵀ with frequency correlation
    r(m) = Σ_l p_l·exp(−2πi·m·l/64) and σ² = 10^(−snr/10).  ``pdp`` is an
    explicit normalized profile; None is the legacy exponential
    p_l ∝ exp(−l/rms_spread) over ``n_taps``."""
    if pdp is None:
        p = np.exp(-np.arange(n_taps, dtype=np.float64) / rms_spread)
    else:
        p = np.asarray(pdp, np.float64)
    p = p / p.sum()
    n_taps = p.shape[0]

    def r(m):
        m = np.asarray(m, np.float64)[..., None]
        l = np.arange(n_taps, dtype=np.float64)
        return (p * np.exp(-2j * np.pi * m * l / C.N_FFT)).sum(-1)

    r_pp = r(_P[:, None] - _P[None, :])          # (4, 4)   E[H_p H_q*]
    r_kp = r(_K[:, None] - _P[None, :])          # (53, 4)  E[H_k H_p*]
    s2 = 10.0 ** (-snr_db / 10.0)
    return np.linalg.solve((r_pp + s2 * np.eye(C.N_PILOTS)).T, r_kp.T)


@functools.lru_cache(maxsize=None)
def wiener_matrix_for(channel_model: str | None = None,
                      snr_db: float = 20.0) -> np.ndarray:
    """The Wiener matrix for a channel model's profile (ops/channel.py) at
    ``snr_db``; ``channel_model=None`` at 20 dB is the legacy matrix."""
    if channel_model is None and snr_db == 20.0:
        return _wiener_matrix()
    from tpu80211_torch.ops import channel

    return _wiener_matrix(
        snr_db=snr_db,
        pdp=tuple(float(v) for v in channel.pdp(channel_model)),
    )


@functools.lru_cache(maxsize=None)
def interp_matrix(kind: str, mode: EstimatorMode = EstimatorMode.MATH,
                  channel_model: str | None = None,
                  snr_db: float | None = None) -> np.ndarray:
    """The (4, 53) float64 interpolation matrix for ``kind`` ∈ {"linear",
    "cubic", "sinc", "spline", "wiener"}; "wiener" is complex and the only
    kind that reads ``channel_model``/``snr_db``."""
    if kind == "linear":
        return _linear_matrix()
    if kind == "cubic":
        return _newton_cubic_matrix(uniform_denoms=(mode == EstimatorMode.C_PARITY))
    if kind == "sinc":
        return _sinc_matrix()
    if kind == "spline":
        return _spline_matrix()
    if kind == "wiener":
        return wiener_matrix_for(channel_model,
                                 20.0 if snr_db is None else float(snr_db))
    raise ValueError(f"unknown interpolation kind: {kind!r}")
