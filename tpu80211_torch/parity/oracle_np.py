"""Extended-precision (80-bit long-double) NumPy oracle (the counterpart of
``tpu80211/parity/oracle_np.py``, the same code: it computes bit for bit
what that copy computes).

An *independent* scalar-loop re-implementation of the estimator math, used
as the parity reference for the port's estimators:

* MATLAB mode follows WiFi_channel_estimation_*.m / WiFi_RX.m semantics;
* C_PARITY mode follows the C sequential code main.c:66-212 including its
  quirks (SURVEY.md §2.5): real 'hermitian' (utils.c:6), addition bug
  Ryy = M1+M1 (utils.c:117), uniform cubic denominators (main.c:113-118),
  4-entry X4 (main.c:166-178), block-0-only processing (main.c:16).

It deliberately mirrors the reference's *structure* (per-subcarrier loops,
explicit matrices, explicit inverse) rather than the framework's batched
formulation, so agreement between the two is meaningful evidence.  It runs
at numpy ``clongdouble`` — the same 80-bit extended precision as the C
``long double complex`` — which lets parity tolerances for the complex64
and complex128 paths be attributed to dtype alone.  Nothing here is torch.
"""

from __future__ import annotations

import numpy as np

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode

LD = np.longdouble
CLD = np.clongdouble

P0, P1, P2, P3 = C.PILOT_IDX
DELTA = LD(C.PILOT_DELTA)


def dft_matrix_ld(n: int = C.N_SC) -> np.ndarray:
    f = np.zeros((n, n), dtype=CLD)
    for t in range(n):
        for k in range(n):
            ang = LD(-2.0) * np.pi * LD(t) * LD(k) / LD(n)
            f[t, k] = np.cos(ang, dtype=LD) + 1j * np.sin(ang, dtype=LD)
    return f


def inv_gauss_ld(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse with partial pivoting at clongdouble.

    Stand-in for the reference's cofactor-expansion inverse
    (utils.c:141-170) — mathematically identical, numerically comparable at
    80-bit precision.
    """
    n = a.shape[0]
    m = np.concatenate([a.astype(CLD).copy(), np.eye(n, dtype=CLD)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(np.abs(m[col:, col])))
        if piv != col:
            m[[col, piv]] = m[[piv, col]]
        m[col] = m[col] / m[col, col]
        for r in range(n):
            if r != col:
                m[r] = m[r] - m[r, col] * m[col]
    return m[:, n:]


def ifft_ld(x: np.ndarray) -> np.ndarray:
    """Direct O(n²) inverse DFT at clongdouble (numpy fft is double-only)."""
    n = x.shape[0]
    out = np.zeros(n, dtype=CLD)
    for t in range(n):
        acc = CLD(0)
        for k in range(n):
            ang = LD(2.0) * np.pi * LD(t) * LD(k) / LD(n)
            acc += x[k] * (np.cos(ang, dtype=LD) + 1j * np.sin(ang, dtype=LD))
        out[t] = acc / LD(n)
    return out


def lt_ls_oracle(tx_pre, rx_pre, mode: EstimatorMode) -> np.ndarray:
    tx = np.asarray(tx_pre, dtype=CLD)
    rx = np.asarray(rx_pre, dtype=CLD)
    h = np.zeros(C.N_SC, dtype=CLD)
    for i in range(C.N_SC):
        if i == C.DC_IDX:
            continue
        if mode == EstimatorMode.C_PARITY:
            conj = tx[i].real - tx[i].imag  # main.c:69-70
        else:
            conj = np.conj(tx[i])
        h[i] = (conj * rx[i]) / (conj * tx[i])
    return h


def _pilot_ratios(tx, rx):
    return np.array(
        [rx[p] / tx[p] for p in (P0, P1, P2, P3)], dtype=CLD
    )


def ps_linear_block(tx, rx) -> np.ndarray:
    hp = _pilot_ratios(tx, rx)
    h = np.zeros(C.N_SC, dtype=CLD)
    for k in range(C.N_SC):
        if k < P1:
            a = LD(k - P0) / DELTA
            h[k] = hp[0] + (hp[1] - hp[0]) * a
        elif k < P2:
            a = LD(k - P1) / DELTA
            h[k] = hp[1] + (hp[2] - hp[1]) * a
        else:  # both the P2≤k<P3 and k≥P3 branches use the same slope
            a = LD(k - P2) / DELTA
            h[k] = hp[2] + (hp[3] - hp[2]) * a
    return h


def ps_cubic_block(tx, rx, mode: EstimatorMode) -> np.ndarray:
    hp = _pilot_ratios(tx, rx)
    if mode == EstimatorMode.C_PARITY:
        d012 = d123 = d0123 = DELTA  # main.c:113-118
    else:
        d012 = d123 = 2 * DELTA
        d0123 = 3 * DELTA
    f0 = hp[0]
    f01 = (hp[1] - hp[0]) / DELTA
    f12 = (hp[2] - hp[1]) / DELTA
    f23 = (hp[3] - hp[2]) / DELTA
    f012 = (f12 - f01) / d012
    f123 = (f23 - f12) / d123
    f0123 = (f123 - f012) / d0123
    h = np.zeros(C.N_SC, dtype=CLD)
    for k in range(C.N_SC):
        h[k] = (
            f0
            + f01 * (k - P0)
            + f012 * (k - P0) * (k - P1)
            + f0123 * (k - P0) * (k - P1) * (k - P2)
        )
    return h


def _sinc_ld(x: np.longdouble) -> np.longdouble:
    if x == 0:
        return LD(1.0)
    px = np.pi * x
    return np.sin(px, dtype=LD) / px


def ps_sinc_block(tx, rx) -> np.ndarray:
    hp = _pilot_ratios(tx, rx)
    h = np.zeros(C.N_SC, dtype=CLD)
    for k in range(C.N_SC):
        h[k] = (
            hp[0] * _sinc_ld(LD(k - P0) / DELTA)
            + hp[1] * _sinc_ld(LD(k - P1) / DELTA)
            + hp[2] * _sinc_ld(LD(k - P2) / DELTA)
            + hp[3] * _sinc_ld(LD(k - P3) / DELTA)
        )
    return h


def ps_interp_oracle(tx_blocks, rx_blocks, kind, mode, avg_blocks=C.N_AVG_BLOCKS):
    """tx/rx (n_blocks, 53) → (53,) averaged estimate.

    spline == MATLAB cubic (csapi with 4 knots is the unique cubic,
    WiFi_RX.m:50); C-parity averages nothing — block 0 only.
    """
    tx_blocks = np.asarray(tx_blocks, dtype=CLD)
    rx_blocks = np.asarray(rx_blocks, dtype=CLD)
    if mode == EstimatorMode.C_PARITY:
        avg_blocks = 1
    acc = np.zeros(C.N_SC, dtype=CLD)
    for b in range(avg_blocks):
        tx, rx = tx_blocks[b], rx_blocks[b]
        if kind == "linear":
            acc += ps_linear_block(tx, rx)
        elif kind == "cubic":
            acc += ps_cubic_block(tx, rx, mode)
        elif kind == "sinc":
            acc += ps_sinc_block(tx, rx)
        elif kind == "spline":
            acc += ps_cubic_block(tx, rx, EstimatorMode.MATLAB)
        else:
            raise ValueError(kind)
    return acc / LD(avg_blocks)


def ps_mmse_oracle(
    tx_blocks, rx_blocks, ow2, h_lt, mode: EstimatorMode, avg_blocks=C.N_AVG_BLOCKS
) -> np.ndarray:
    """Dense-matrix MMSE at clongdouble, explicit inverse — no rank-1
    shortcut, so it independently checks the framework's Sherman-Morrison
    algebra."""
    tx_blocks = np.asarray(tx_blocks, dtype=CLD)
    rx_blocks = np.asarray(rx_blocks, dtype=CLD)
    h_lt = np.asarray(h_lt, dtype=CLD)
    ow2 = LD(ow2)
    f = dft_matrix_ld()
    n = C.N_SC

    if mode == EstimatorMode.C_PARITY:
        # main.c:148-212 with quirks
        tx, rx = tx_blocks[0], rx_blocks[0]
        x4 = np.zeros((n, n), dtype=CLD)
        for p in (P0, P1, P2, P3):
            x4[p, p] = tx[p]
        fh = (f.real - f.imag).T.astype(CLD)        # hermitian quirk (utils.c:6)
        inv_f = inv_gauss_ld(f)                      # stands in for utils.c:141
        t1 = inv_f @ h_lt
        t2 = (t1.real - t1.imag).astype(CLD)         # hermitian of a column
        rhh = np.outer(t1, t2)
        rhy = rhh @ fh @ x4
        inv_ryy = np.eye(n, dtype=CLD) / (2 * ow2)   # addition bug ⇒ Ryy = 2σ²I
        return f @ rhy @ inv_ryy @ rx

    h_t = ifft_ld(h_lt)
    rhh = np.outer(h_t, np.conj(h_t))
    acc = np.zeros(n, dtype=CLD)
    for b in range(avg_blocks):
        tx, rx = tx_blocks[b], rx_blocks[b]
        x4 = np.diag(tx).astype(CLD)
        if mode == EstimatorMode.MATLAB:
            rhy = rhh @ np.conj(f.T) @ x4          # ..._PS_MMSE.m:30 (X4 slip)
        else:  # MATH: true cross-covariance needs X4ᴴ
            rhy = rhh @ np.conj(f.T) @ np.conj(x4.T)
        ryy = x4 @ f @ rhh @ np.conj(f.T) @ np.conj(x4.T) + ow2 * np.eye(n, dtype=CLD)
        acc += f @ rhy @ inv_gauss_ld(ryy) @ rx
    return acc / LD(avg_blocks)


def equalize_oracle(rx_blocks, h_lt, h_ps) -> np.ndarray:
    """WiFi_Equalization.m:3-8 at clongdouble. rx (n_blocks, 53) → same."""
    rx_blocks = np.asarray(rx_blocks, dtype=CLD)
    h_lt = np.asarray(h_lt, dtype=CLD)
    h_ps = np.asarray(h_ps, dtype=CLD)
    nb = rx_blocks.shape[0]
    out = np.zeros_like(rx_blocks)
    for i in range(1, nb + 1):
        h_util = (LD(nb - i) / LD(nb)) * h_lt + (LD(i) / LD(nb)) * h_ps
        for k in range(C.N_SC):
            if k == C.DC_IDX:
                continue
            out[i - 1, k] = rx_blocks[i - 1, k] / h_util[k]
    return out
