"""Carrier-frequency-offset (CFO) estimation and correction, and pilot-based
common-phase-error (CPE) correction, on complex tensors.

The counterpart of ``tpu80211/ops/cfo.py``:

* **Moose estimate** from the two identical 64-sample LTS repeats of the
  long preamble: a CFO of ``eps`` cycles/sample rotates the second repeat
  by exp(2πi·eps·64) against the first, so the angle of their lag-64
  correlation gives eps (unambiguous for |eps| < 1/128).
* **Derotation** by exp(−2πi·eps·t) on one time base: the preamble starts
  at t = 0 and the packet follows it at t = 160.
* **CPE correction** after equalization: each block's common phase is read
  off the four pilots and removed, phase only.

Functions compute in the precision of their input (complex64 or
complex128); the angle is formed as ((−2π)·eps)·t, in that order.
"""

from __future__ import annotations

import math

import torch

from tpu80211_torch import constants as C

_TWO_PI = 2.0 * math.pi


def estimate_cfo(rx_lptot: torch.Tensor) -> torch.Tensor:
    """Moose CFO estimate from the (…, 160) long preamble [CP | LTS | LTS],
    (…,) real, in cycles/sample: the stream is rotated by exp(+2πi·eps·n)."""
    r1 = rx_lptot[..., -2 * C.N_FFT:-C.N_FFT]   # earlier repeat
    r2 = rx_lptot[..., -C.N_FFT:]               # later repeat
    c = (r1.conj() * r2).sum(-1)
    return torch.atan2(c.imag, c.real) / (_TWO_PI * C.N_FFT)


def derotate(x: torch.Tensor, eps: torch.Tensor, start: int = 0) -> torch.Tensor:
    """x[…, n] · exp(−2πi·eps·(start + n)).  ``start`` anchors the time
    base: 0 for the preamble, C.PREAMBLE_SAMPLES for the packet after it."""
    real = eps.dtype
    t = start + torch.arange(x.shape[-1], dtype=real, device=x.device)
    ang = ((-_TWO_PI) * eps)[..., None] * t
    return x * torch.polar(torch.ones_like(ang), ang).to(x.dtype)


def correct_cfo(rx_packet: torch.Tensor, rx_lptot: torch.Tensor,
                eps: torch.Tensor | None = None):
    """Estimate the CFO (unless given) and remove it from both rx streams.
    Returns (rx_packet', rx_lptot', eps)."""
    if eps is None:
        eps = estimate_cfo(rx_lptot)
    return (derotate(rx_packet, eps, start=C.PREAMBLE_SAMPLES),
            derotate(rx_lptot, eps, start=0), eps)


def cpe_correct(eq: torch.Tensor, tx_blocks: torch.Tensor) -> torch.Tensor:
    """Rotate each block of ``eq`` (…, 15, 53) by conj(g)/|g|, where
    g = Σ_p eq[p]·conj(tx[p]) over the four pilots.  A block with g = 0 is
    left as it is (|g| is taken as 1)."""
    p = list(C.PILOT_IDX)
    g = (eq[..., p] * tx_blocks[..., p].conj()).sum(-1)
    mag = g.abs()
    mag = torch.where(mag == 0, torch.ones_like(mag), mag)
    return eq * (g.conj() / mag)[..., None]
