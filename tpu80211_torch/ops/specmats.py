"""Spectral matrices, built once in float64 numpy.

"CP strip → FFT64 → fftshift (circshift by 26) → keep 53 bins"
(WiFi_blocks_extraction.m:5-10) folds into one (64, 53) matrix, so the
front end is a single product per block.
"""

from __future__ import annotations

import functools

import numpy as np

from tpu80211_torch import constants as C


@functools.lru_cache(maxsize=None)
def block_dft() -> tuple[np.ndarray, np.ndarray]:
    """(64, 53) real/imag planes of the combined FFT64+fftshift+truncate.

    out[k] = Σ_n x[n]·exp(−2πi·n·(k−26)/64)."""
    n = np.arange(C.N_FFT)[:, None]
    k = np.arange(C.N_SC)[None, :] - C.FFT_SHIFT
    w = np.exp(-2j * np.pi * n * k / C.N_FFT)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


@functools.lru_cache(maxsize=None)
def dft53() -> tuple[np.ndarray, np.ndarray]:
    """(53, 53) DFT matrix F[t,f] = exp(−2πi·t·f/53) (main.c:22-26)."""
    t = np.arange(C.N_SC)
    w = np.exp(-2j * np.pi * np.outer(t, t) / C.N_SC)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


@functools.lru_cache(maxsize=None)
def idft53() -> tuple[np.ndarray, np.ndarray]:
    """(53, 53) inverse DFT = conj(F)/53."""
    re, im = dft53()
    return re / C.N_SC, -im / C.N_SC
