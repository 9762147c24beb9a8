"""Quality metrics: channel-estimation MSE, EVM, hard-decision BER.

The counterpart of ``tpu80211/utils/metrics.py``, batched over frames.
Each takes complex tensors (any device), split planes (`Cplx`) or numpy
arrays, and computes on the host in numpy with the JAX package's
formulas, so both packages report the same numbers for the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx

_DATA = np.asarray(C.DATA_MASK)


def _as_complex(x) -> np.ndarray:
    if isinstance(x, Cplx):
        x = x.to_complex()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cfr_mse(h_est, h_true, exclude_dc: bool = True) -> float:
    """Mean |H_est − H_true|² over data subcarriers (and frames)."""
    mask = _DATA if exclude_dc else np.ones(C.N_SC, bool)
    d = (_as_complex(h_est) - _as_complex(h_true))[..., mask]
    return float(np.mean(np.abs(d) ** 2))


def cfr_nmse_db(h_est, h_true) -> float:
    """Normalized MSE in dB: 10·log10(Σ|ΔH|²/Σ|H|²) on data subcarriers."""
    a, b = _as_complex(h_est), _as_complex(h_true)
    d = (a - b)[..., _DATA]
    ref = b[..., _DATA]
    return float(10 * np.log10(np.sum(np.abs(d) ** 2) / np.sum(np.abs(ref) ** 2)))


def evm_rms(eq_symbols, tx_symbols) -> float:
    """RMS error-vector magnitude of equalized against transmitted symbols,
    over data subcarriers, as a fraction of the RMS tx power."""
    eq, tx = _as_complex(eq_symbols), _as_complex(tx_symbols)
    d = (eq - tx)[..., _DATA]
    ref = tx[..., _DATA]
    return float(np.sqrt(np.mean(np.abs(d) ** 2) / np.mean(np.abs(ref) ** 2)))


def qpsk_ber(eq_symbols, tx_symbols) -> float:
    """Hard-decision QPSK bit error rate on data subcarriers (valid when tx
    is QPSK, as the synthetic generator's frames are)."""
    eq = _as_complex(eq_symbols)[..., _DATA]
    tx = _as_complex(tx_symbols)[..., _DATA]
    errs = ((np.sign(eq.real) != np.sign(tx.real)).sum()
            + (np.sign(eq.imag) != np.sign(tx.imag)).sum())
    return float(errs) / (2 * eq.size)


# -- M-QAM (square, Gray-coded) -------------------------------------------------


def pam_levels(m: int) -> np.ndarray:
    """Per-axis PAM levels of square m-QAM at unit average symbol power;
    m ∈ {4, 16, 64} → 2, 4 or 8 levels per axis."""
    k = int(np.sqrt(m))
    if k * k != m or k not in (2, 4, 8):
        raise ValueError(f"m must be 4, 16 or 64, got {m}")
    lv = np.arange(-(k - 1), k, 2, dtype=np.float64)
    return lv / np.sqrt(np.mean(lv ** 2) * 2.0)


def _gray(idx: np.ndarray) -> np.ndarray:
    return idx ^ (idx >> 1)


def qam_ber(eq_symbols, tx_symbols, m: int = 16) -> float:
    """Hard-decision Gray-coded square-QAM bit error rate on data
    subcarriers: each axis is a Gray-coded PAM, and the bits in which the
    decided and the transmitted level's codes differ are counted."""
    if m == 4:
        return qpsk_ber(eq_symbols, tx_symbols)
    lv = pam_levels(m)
    bits_per_axis = int(np.log2(lv.size))
    edges = (lv[:-1] + lv[1:]) / 2.0
    eq = _as_complex(eq_symbols)[..., _DATA]
    tx = _as_complex(tx_symbols)[..., _DATA]
    errs = 0
    for comp in (np.real, np.imag):
        di = np.digitize(comp(eq), edges).astype(np.int64)
        ti = np.digitize(comp(tx), edges).astype(np.int64)
        x = _gray(di) ^ _gray(ti)
        for b in range(bits_per_axis):
            errs += int(((x >> b) & 1).sum())
    return errs / (2 * bits_per_axis * eq.size)
