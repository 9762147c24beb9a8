"""Synthetic 802.11 frames in the frequency domain, and their time view.

The counterpart of ``tpu80211/datasets/synthetic.py``.  Random frames with
the capture's geometry: QPSK (or 16/64-QAM) data on the 48 data bins,
pilots +1, DC empty, per OFDM block; a known ±1 long-training symbol on the
used bins; an exponential-PDP FIR channel per frame (``channel_model`` ∈
{None, 'A'..'E'}); AWGN at ``snr_db``; optionally a carrier frequency
offset, modelled as its per-block common phase rotation.  The time view is
the exact inverse of the block extraction (zero-pad 53 → 64, inverse
shift, IDFT, cyclic prefix).

``generate`` draws with an explicit ``torch.Generator`` on its device
(``frame_draws``) and assembles from the draws (``assemble``), so a test
can feed the JAX package's own draws to the port's assembly.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.ops import channel
from tpu80211_torch.utils.metrics import pam_levels

MODULATIONS = ("qpsk", "qam16", "qam64")


class FrameBatch(NamedTuple):
    """A batch of synthetic frames, frequency-domain view, batch first."""

    tx_preamble_fft: torch.Tensor  # (B, 53)
    rx_preamble_fft: torch.Tensor  # (B, 53)
    tx_symb: torch.Tensor          # (B, 15, 53)
    rx_symb: torch.Tensor          # (B, 15, 53)
    ow2: torch.Tensor              # (B,) float32 noise power
    h_true: torch.Tensor           # (B, 53) the channel


@functools.lru_cache(maxsize=None)
def _lts_spectrum() -> np.ndarray:
    """A fixed ±1 long-training symbol on the 53 used bins, DC = 0."""
    rng = np.random.default_rng(0x80211)
    s = rng.integers(0, 2, C.N_SC).astype(np.float64) * 2 - 1
    s[C.DC_IDX] = 0.0
    return s


def _cfr_matrix(n_taps: int) -> np.ndarray:
    """(n_taps, 53): taps → CFR on the shifted 53-bin grid."""
    k = (np.arange(C.N_SC) - C.FFT_SHIFT) % C.N_FFT
    return np.exp(-2j * np.pi * np.outer(np.arange(n_taps), k) / C.N_FFT)


class FrameDraws(NamedTuple):
    """The random numbers of one batch, batch first, float32 unless noted."""

    taps_re: torch.Tensor   # (B, n_taps) unit normals
    taps_im: torch.Tensor
    data: torch.Tensor      # qpsk: (B, 15, 53, 2) bool bits; qam: (B, 15, 53, 2) int64 I/Q levels
    n1_re: torch.Tensor     # (B, 15, 53) unit normals, the block noise
    n1_im: torch.Tensor
    n2_re: torch.Tensor     # (B, 53) unit normals, the preamble noise
    n2_im: torch.Tensor


def frame_draws(gen: torch.Generator, batch: int, channel_model: str | None = None,
                modulation: str = "qpsk", sample_rate_hz: float = 20e6) -> FrameDraws:
    """Draw one batch's numbers on ``gen``'s device."""
    if modulation not in MODULATIONS:
        raise ValueError(f"modulation must be one of {MODULATIONS}, got {modulation!r}")
    dev = gen.device
    n_taps = channel.n_taps_for(channel_model, sample_rate_hz)

    def normals(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    taps = normals(batch, n_taps), normals(batch, n_taps)
    shape = (batch, C.N_BLOCKS, C.N_SC, 2)
    if modulation == "qpsk":
        data = torch.rand(shape, generator=gen, device=dev) < 0.5
    else:
        m = {"qam16": 16, "qam64": 64}[modulation]
        data = torch.randint(0, math.isqrt(m), shape, generator=gen, device=dev)
    n1 = normals(batch, C.N_BLOCKS, C.N_SC), normals(batch, C.N_BLOCKS, C.N_SC)
    n2 = normals(batch, C.N_SC), normals(batch, C.N_SC)
    return FrameDraws(*taps, data, *n1, *n2)


def assemble(draws: FrameDraws, snr_db: float = 40.0, dtype: torch.dtype = torch.complex64,
             fo_hz: float = 0.0, sample_rate_hz: float = 20e6,
             channel_model: str | None = None, modulation: str = "qpsk") -> FrameBatch:
    """A FrameBatch from given draws (`frame_draws`' layout)."""
    dev = draws.taps_re.device
    b = draws.taps_re.shape[0]
    p = channel.pdp(channel_model, sample_rate_hz)
    scale = torch.tensor(np.sqrt(p / 2.0), dtype=torch.float32, device=dev)
    taps = torch.complex(draws.taps_re * scale, draws.taps_im * scale)
    h = (taps @ torch.tensor(_cfr_matrix(p.size), device=dev).to(taps.dtype)).to(dtype)

    # tx data on every used bin, pilots +1, DC 0
    if modulation == "qpsk":
        bits = draws.data.to(torch.float32) * 2 - 1
        data = torch.complex(bits[..., 0], bits[..., 1]).to(dtype) / np.sqrt(2.0)
    else:
        lv = torch.tensor(pam_levels({"qam16": 16, "qam64": 64}[modulation]), device=dev)
        data = torch.complex(lv[draws.data[..., 0]], lv[draws.data[..., 1]]).to(dtype)
    pilot = torch.tensor(C.PILOT_MASK, device=dev)
    dc = torch.arange(C.N_SC, device=dev) == C.DC_IDX
    tx = torch.where(pilot, torch.ones((), dtype=dtype, device=dev), data)
    tx = torch.where(dc, torch.zeros((), dtype=dtype, device=dev), tx)
    tx_pre = torch.tensor(_lts_spectrum(), device=dev).to(dtype).expand(b, C.N_SC)

    # AWGN at the target SNR (signal power ≈ 1 per used bin)
    sigma2 = 10.0 ** (-snr_db / 10.0)
    nsc = np.sqrt(sigma2 / 2.0)
    rx = tx * h[:, None, :] + torch.complex(draws.n1_re, draws.n1_im).to(dtype) * nsc
    if fo_hz:
        ang = (2.0 * np.pi * fo_hz * C.SAMP_PER_BLOCK / sample_rate_hz) * np.arange(C.N_BLOCKS)
        rx = rx * torch.tensor(np.exp(1j * ang), device=dev).to(dtype)[None, :, None]
    rx_pre = tx_pre * h + torch.complex(draws.n2_re, draws.n2_im).to(dtype) * nsc
    ow2 = torch.full((b,), sigma2, dtype=torch.float32, device=dev)
    return FrameBatch(tx_pre, rx_pre, tx, rx, ow2, h)


def generate(gen: torch.Generator, batch: int, snr_db: float = 40.0,
             dtype: torch.dtype = torch.complex64, fo_hz: float = 0.0,
             sample_rate_hz: float = 20e6, channel_model: str | None = None,
             modulation: str = "qpsk") -> FrameBatch:
    """A FrameBatch of ``batch`` random frames at ``snr_db`` on ``gen``'s
    device.  ``fo_hz`` rotates block b by exp(2πi·fo·80·b/fs), the dominant
    term of a CFO in this frequency-domain view (its ICI is not modelled).
    ``modulation`` ∈ {"qpsk", "qam16", "qam64"} at unit average power."""
    draws = frame_draws(gen, batch, channel_model, modulation, sample_rate_hz)
    return assemble(draws, snr_db, dtype, fo_hz, sample_rate_hz, channel_model, modulation)


def _to_time(spec: torch.Tensor) -> torch.Tensor:
    """(…, 53) → (…, 64): zero-pad, inverse shift, IDFT."""
    full = torch.zeros((*spec.shape[:-1], C.N_FFT), dtype=spec.dtype, device=spec.device)
    full[..., :C.N_SC] = spec
    return torch.fft.ifft(torch.roll(full, -C.FFT_SHIFT, dims=-1), dim=-1)


def synthesize_preamble_time(pre_fft: torch.Tensor) -> torch.Tensor:
    """(…, 53) preamble spectrum → (…, 160) long preamble: the 64-sample
    LTS twice behind its last 32 samples (WiFi_RX.m:19-29 reads the repeats
    at offsets 32 and 96)."""
    if pre_fft.shape[-1] != C.N_SC:
        raise ValueError(f"want (..., {C.N_SC}), got {tuple(pre_fft.shape)}")
    t = _to_time(pre_fft)
    return torch.cat([t[..., -32:], t, t], dim=-1)


def synthesize_time(symb: torch.Tensor) -> torch.Tensor:
    """(…, 15, 53) blocks → (…, 1200) packet: each block's IDFT behind its
    16-sample cyclic prefix; the exact right-inverse of the extraction."""
    if tuple(symb.shape[-2:]) != (C.N_BLOCKS, C.N_SC):
        raise ValueError(f"want (..., {C.N_BLOCKS}, {C.N_SC}), got {tuple(symb.shape)}")
    t = _to_time(symb)
    with_cp = torch.cat([t[..., -C.N_CP:], t], dim=-1)
    return with_cp.reshape(*symb.shape[:-2], C.PACKET_SAMPLES)


def apply_time_cfo(x: torch.Tensor, eps: float, start: int = 0) -> torch.Tensor:
    """x[n] · exp(+2πi·eps·(start + n)) along the last axis (eps in
    cycles/sample)."""
    t = start + np.arange(x.shape[-1])
    return x * torch.tensor(np.exp(2j * np.pi * eps * t), device=x.device).to(x.dtype)
