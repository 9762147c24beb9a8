"""ctypes bindings to the native C++ 80-bit parity oracle (``native/oracle.cpp``;
the counterpart of ``tpu80211/parity/oracle_native.py``, over the same
library: ``native/build/liboracle80211.so``).

The reference's parity target is its compiled C sequential binary
(SURVEY.md §2.5); this module builds (once, as the data engine's bindings
do: ``datasets.native_engine.build_library``) and wraps the native
re-implementation of that binary's behavior, so tests can gate the port's
estimators against actual x87 long-double arithmetic, including the
cofactor/adjugate inverse the reference spends all its parallelization
effort on (utils.c:141-170).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.datasets.native_engine import build_library

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_SO = _NATIVE_DIR / "build" / "liboracle80211.so"

_D = ctypes.POINTER(ctypes.c_double)


def _planes(x, n=None):
    x = np.ascontiguousarray(np.asarray(x, np.complex128))
    if n is not None:
        assert x.size == n, (x.shape, n)
    re = np.ascontiguousarray(x.real)
    im = np.ascontiguousarray(x.imag)
    return re, im


def _ptr(a):
    return a.ctypes.data_as(_D)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(_SO.name)))
    lib.est_lt_ls.argtypes = [_D] * 6 + [ctypes.c_int]
    lib.est_ps_block.argtypes = [_D] * 6 + [ctypes.c_int] * 2
    lib.est_ps_frame.argtypes = [_D] * 6 + [ctypes.c_int] * 3
    lib.est_ps_mmse_block.argtypes = (
        [_D] * 6 + [ctypes.c_double] + [_D] * 2 + [ctypes.c_int] * 2
    )
    lib.equalize.argtypes = [_D] * 8
    lib.inverse_n.argtypes = [_D] * 4 + [ctypes.c_int] * 2
    lib.determinant_n.argtypes = [_D] * 2 + [ctypes.c_int] * 2 + [_D] * 2
    return lib


_KIND = {"linear": 0, "cubic": 1, "sinc": 2, "spline": 1}


def lt_ls(tx_pre, rx_pre, mode: EstimatorMode = EstimatorMode.MATH) -> np.ndarray:
    txr, txi = _planes(tx_pre, C.N_SC)
    rxr, rxi = _planes(rx_pre, C.N_SC)
    hr = np.zeros(C.N_SC)
    hi = np.zeros(C.N_SC)
    _lib().est_lt_ls(
        _ptr(txr), _ptr(txi), _ptr(rxr), _ptr(rxi), _ptr(hr), _ptr(hi),
        int(mode == EstimatorMode.C_PARITY),
    )
    return hr + 1j * hi


def ps_interp(
    tx_blocks, rx_blocks, kind: str,
    mode: EstimatorMode = EstimatorMode.MATH,
    avg_blocks: int = C.N_AVG_BLOCKS,
) -> np.ndarray:
    """(15, 53) blocks → (53,) averaged estimate.

    ``spline`` maps to the MATLAB cubic (csapi with 4 knots is the unique
    cubic — WiFi_RX.m:50), matching ops/interp.py.
    """
    txr, txi = _planes(tx_blocks, C.N_BLOCKS * C.N_SC)
    rxr, rxi = _planes(rx_blocks, C.N_BLOCKS * C.N_SC)
    hr = np.zeros(C.N_SC)
    hi = np.zeros(C.N_SC)
    cp = mode == EstimatorMode.C_PARITY
    k = _KIND[kind]
    if cp:
        avg_blocks = 1  # C processes block 0 only (main.c:16)
    if kind == "spline":
        cp = False  # spline keeps MATLAB cubic denominators in every mode
    _lib().est_ps_frame(
        _ptr(txr), _ptr(txi), _ptr(rxr), _ptr(rxi), _ptr(hr), _ptr(hi),
        k, int(cp), avg_blocks,
    )
    return hr + 1j * hi


def ps_mmse(
    tx_blocks, rx_blocks, ow2, h_lt,
    mode: EstimatorMode = EstimatorMode.MATH,
    avg_blocks: int = C.N_AVG_BLOCKS,
    use_cofactor: bool = False,
) -> np.ndarray:
    """Frame-level MMSE; C-parity processes only block 0 (main.c:16)."""
    tx = np.asarray(tx_blocks, np.complex128).reshape(C.N_BLOCKS, C.N_SC)
    rx = np.asarray(rx_blocks, np.complex128).reshape(C.N_BLOCKS, C.N_SC)
    hltr, hlti = _planes(h_lt, C.N_SC)
    md = {EstimatorMode.MATH: 0, EstimatorMode.MATLAB: 1, EstimatorMode.C_PARITY: 2}[mode]
    nb = 1 if mode == EstimatorMode.C_PARITY else avg_blocks
    acc = np.zeros(C.N_SC, np.complex128)
    for b in range(nb):
        txr, txi = _planes(tx[b])
        rxr, rxi = _planes(rx[b])
        hr = np.zeros(C.N_SC)
        hi = np.zeros(C.N_SC)
        _lib().est_ps_mmse_block(
            _ptr(txr), _ptr(txi), _ptr(rxr), _ptr(rxi), _ptr(hltr), _ptr(hlti),
            float(ow2), _ptr(hr), _ptr(hi), md, int(use_cofactor),
        )
        acc += hr + 1j * hi
    return acc / nb


def equalize(rx_blocks, h_lt, h_ps) -> np.ndarray:
    rxr, rxi = _planes(rx_blocks, C.N_BLOCKS * C.N_SC)
    hltr, hlti = _planes(h_lt, C.N_SC)
    hpsr, hpsi = _planes(h_ps, C.N_SC)
    outr = np.zeros(C.N_BLOCKS * C.N_SC)
    outi = np.zeros(C.N_BLOCKS * C.N_SC)
    _lib().equalize(
        _ptr(rxr), _ptr(rxi), _ptr(hltr), _ptr(hlti), _ptr(hpsr), _ptr(hpsi),
        _ptr(outr), _ptr(outi),
    )
    return (outr + 1j * outi).reshape(C.N_BLOCKS, C.N_SC)


def inverse(a, use_cofactor: bool = True) -> np.ndarray:
    """Native n×n inverse — cofactor/adjugate (the reference's hot kernel
    shape, utils.c:141-170) or Gauss-Jordan."""
    a = np.asarray(a, np.complex128)
    n = a.shape[0]
    ar, ai = _planes(a, n * n)
    yr = np.zeros(n * n)
    yi = np.zeros(n * n)
    _lib().inverse_n(_ptr(ar), _ptr(ai), _ptr(yr), _ptr(yi), n, int(use_cofactor))
    return (yr + 1j * yi).reshape(n, n)


def determinant(a, method: str = "condensation") -> complex:
    """Native n×n determinant.

    The reference ships three algorithms (utils.c:462/543/572); this
    exposes all of them for the cross-check its own commented scaffold
    intended (main_openmp.c:216-245).  method ∈ {"condensation",
    "elimination", "laplace"} (laplace: n ≤ 10).
    """
    a = np.asarray(a, np.complex128)
    n = a.shape[0]
    ar, ai = _planes(a, n * n)
    outr = np.zeros(1)
    outi = np.zeros(1)
    m = {"condensation": 0, "elimination": 1, "laplace": 2}[method]
    _lib().determinant_n(_ptr(ar), _ptr(ai), n, m, _ptr(outr), _ptr(outi))
    return complex(outr[0], outi[0])
