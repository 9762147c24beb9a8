"""Time-domain → frequency-domain frame processing (the counterpart of
``tpu80211/ops/blocks.py``), on complex tensors.

The block DFT is one product against the (64, 53) matrix of
``ops/specmats.py`` (the FFT at 64 points, fftshift by 26 and the 53-bin
truncation of WiFi_RX.m:22-29 in one matrix); it computes in the dtype of
its input, ``torch.complex64`` or ``torch.complex128``.
"""

from __future__ import annotations

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.ops import specmats


def _block_dft(like: torch.Tensor) -> torch.Tensor:
    w_re, w_im = specmats.block_dft()
    return torch.as_tensor(w_re + 1j * w_im).to(device=like.device, dtype=like.dtype)


def extract_blocks(packet: torch.Tensor) -> torch.Tensor:
    """(…, 1200) time-domain packet → (…, 15, 53) frequency-domain blocks."""
    *lead, n = packet.shape
    assert n == C.PACKET_SAMPLES, packet.shape
    blocks = packet.reshape(*lead, C.N_BLOCKS, C.SAMP_PER_BLOCK)[..., C.N_CP:]
    return blocks @ _block_dft(packet)


def preamble_fft(lptot: torch.Tensor) -> torch.Tensor:
    """(…, 160) long preamble → (…, 53) averaged LTS spectrum (WiFi_RX.m:19-29)."""
    assert lptot.shape[-1] == C.PREAMBLE_SAMPLES, lptot.shape
    rep1 = lptot[..., -C.N_FFT:]
    rep2 = lptot[..., -2 * C.N_FFT:-C.N_FFT]
    return ((rep1 + rep2) * 0.5) @ _block_dft(lptot)


def noise_power_estimate(rx_lptot: torch.Tensor) -> torch.Tensor:
    """σ² from the LTS repeat difference (WiFi_RX.m:31); real (…,) tensor."""
    rep1 = rx_lptot[..., -C.N_FFT:]
    rep2 = rx_lptot[..., -2 * C.N_FFT:-C.N_FFT]
    return (rep2 - rep1).abs().square().sum(-1) / (2 * C.N_FFT)
