"""Complex linear-algebra helpers of the estimators (the counterpart of
``tpu80211/ops/linalg.py``).

The reference's cofactor-expansion inverse (utils.c:141-170) never exists
here: where the math needs ``inv(F)`` the unitary-DFT identity does
(``torch.fft.ifft``), and where it needs ``Ryy⁻¹·y`` the estimators take
the rank-1 closed form or a batched solve (``models/ps_mmse.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu80211_torch import constants as C


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int = C.N_SC) -> np.ndarray:
    """F[t, f] = exp(−2πi·t·f/n), a float64 numpy constant (main.c:22-26,
    WiFi_channel_estimation_PS_MMSE.m:16-22)."""
    t = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(t, t) / n)


def idft_apply(x: torch.Tensor, n: int = C.N_SC) -> torch.Tensor:
    """ifft along the last axis: F⁻¹·x without a cofactor inverse (replaces
    inverse(F) at main.c:186 and ifft at ..._PS_MMSE.m:26)."""
    return torch.fft.ifft(x, n=n, dim=-1)


def hermitian_quirk(m: torch.Tensor) -> torch.Tensor:
    """The reference's 'hermitian' (utils.c:3-7): res[c][r] = Re(M[r][c]) −
    Im(M[r][c]), a real transpose-like map, not the conjugate transpose.
    Kept for C-parity mode (SURVEY.md §2.5.1)."""
    return (m.real - m.imag).transpose(-1, -2).to(m.dtype)


def addition_quirk(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """The reference's 'addition' (utils.c:111-121) computes M1+M1 and
    ignores M2 (SURVEY.md §2.5.2).  Kept for C-parity mode."""
    del m2
    return m1 + m1
