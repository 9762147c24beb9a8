"""The seeded input generator: received 802.11a frames, made on the device.

Every frame carries the deployment's one transmit frame (``tx_frame.json``:
the long preamble and the 15-block packet).  Per frame the generator draws
a multipath channel, an exponential power-delay profile of the
configuration's rms delay spread over its taps (complex normal taps,
normalised to unit mean power), convolves the frame with it, turns it by the
carrier frequency offset, exp(2πi·cfo/fs·n) with n counted from the first
preamble sample (aligned frames) or from the first stream sample (raw
streams), and adds complex white noise of power P/10^(snr/10), P the mean
power of the transmit frame.

Aligned frames are packed as one (2720, B) tensor of rows [packet re (1200),
packet im (1200), preamble re (160), preamble im (160)]; raw streams as one
(2·NS, B) tensor [re (NS), im (NS)].  A row slice of either is a contiguous
(rows, B) plane, the lane-major layout that the receive chain reads.

All randomness comes from one ``torch.Generator`` on the device, in a few
large calls, so one seed gives the same inputs on the same card.  This
module imports nothing of the program under test.
"""

from __future__ import annotations

import functools
import json
import math
import pathlib

import numpy as np
import torch

PREAMBLE = 160
PACKET = 1200
FRAME = PREAMBLE + PACKET
PACKED_ROWS = 2 * PACKET + 2 * PREAMBLE

_TX = pathlib.Path(__file__).resolve().parent / "tx_frame.json"


@functools.lru_cache(maxsize=None)
def tx_frame() -> tuple[np.ndarray, np.ndarray]:
    """(preamble (160,), packet (1200,)) complex128: the transmit frame."""
    d = json.loads(_TX.read_text())
    lp = np.asarray(d["tx_lptot_re"]) + 1j * np.asarray(d["tx_lptot_im"])
    pkt = np.asarray(d["tx_packet_re"]) + 1j * np.asarray(d["tx_packet_im"])
    return lp, pkt


def pdp(rms_samples: float, n_taps: int) -> np.ndarray:
    """Exponential power-delay profile exp(−l/rms), l < n_taps, summing to 1."""
    p = np.exp(-np.arange(n_taps) / rms_samples)
    return p / p.sum()


def _channel(deploy: dict) -> np.ndarray:
    rms = deploy["rms_delay_spread_ns"] * 1e-9 * deploy["sample_rate_hz"]
    return pdp(rms, deploy["channel_taps"])


def noise_power(deploy: dict) -> float:
    """σ² of the complex noise per sample: the transmit frame's mean power
    over the linear SNR."""
    lp, pkt = tx_frame()
    p = float(np.mean(np.abs(np.concatenate([lp, pkt])) ** 2))
    return p / 10.0 ** (deploy["snr_db"] / 10.0)


def _faded(deploy: dict, gen: torch.Generator, batch: int, rows: int) -> torch.Tensor:
    """(rows, B) complex64: the transmit frame through a fresh channel per
    column, as the full linear convolution (rows ≥ 1360 + taps − 1 keeps
    the whole tail; fewer cut it)."""
    dev = gen.device
    p = _channel(deploy)
    taps = torch.randn((len(p), batch, 2), generator=gen, device=dev)
    taps = torch.view_as_complex(taps) * torch.tensor(np.sqrt(p / 2.0), dtype=torch.float32,
                                                      device=dev)[:, None]
    lp, pkt = tx_frame()
    x = np.concatenate([lp, pkt])
    # Toeplitz of the frame: t[n, l] = x[n − l] (0 outside the frame)
    idx = np.arange(rows)[:, None] - np.arange(len(p))[None, :]
    t = np.where((idx >= 0) & (idx < FRAME), x[np.clip(idx, 0, FRAME - 1)], 0.0)
    return torch.tensor(t, dtype=torch.complex64, device=dev) @ taps


def _rotation(deploy: dict, n: int, device) -> torch.Tensor:
    """(n, 1) complex64: exp(2πi·cfo/fs·k), the angle taken in float64."""
    eps = deploy["cfo_hz"] / deploy["sample_rate_hz"]
    ang = 2.0 * math.pi * eps * torch.arange(n, dtype=torch.float64, device=device)
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)[:, None]


def _noise(deploy: dict, gen: torch.Generator, rows: int, batch: int) -> torch.Tensor:
    z = torch.randn((rows, batch, 2), generator=gen, device=gen.device)
    return torch.view_as_complex(z) * math.sqrt(noise_power(deploy) / 2.0)


def aligned_batch(deploy: dict, gen: torch.Generator, batch: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """One batch of aligned frames, packed (2720, B) in ``dtype``: the
    received frame cut at the transmit frame's first sample, as a front end
    that has found the packet hands it on."""
    y = _faded(deploy, gen, batch, FRAME)
    y = y * _rotation(deploy, FRAME, y.device) + _noise(deploy, gen, FRAME, batch)
    lp, pkt = y[:PREAMBLE], y[PREAMBLE:]
    return torch.cat([pkt.real, pkt.imag, lp.real, lp.imag]).to(dtype).contiguous()


def raw_batch(deploy: dict, gen: torch.Generator, batch: int, dtype: torch.dtype,
              offsets: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch of raw streams, packed (2·NS, B) in ``dtype``, and the
    offsets (B,) int64: noise over each whole stream of NS samples, the
    received frame (with its channel tail) from a seeded offset in
    [offsets[0], offsets[1])."""
    ns = deploy["stream_samples"]
    dev = gen.device
    tail = FRAME + deploy["channel_taps"] - 1
    if not 0 <= offsets[0] < offsets[1] <= ns - tail + 1:
        raise ValueError(f"offsets {offsets} do not fit a {tail}-sample frame in {ns}")
    offs = torch.randint(offsets[0], offsets[1], (batch,), generator=gen, device=dev)
    y = _faded(deploy, gen, batch, tail)
    x = torch.zeros((ns, batch, 2), dtype=torch.float32, device=dev)
    rows = offs[None, :] + torch.arange(tail, device=dev)[:, None]
    x.scatter_(0, rows[:, :, None].expand(tail, batch, 2), torch.view_as_real(y))
    x = torch.view_as_complex(x) * _rotation(deploy, ns, dev) + _noise(deploy, gen, ns, batch)
    return torch.cat([x.real, x.imag]).to(dtype).contiguous(), offs


def generator(seed: int, device) -> torch.Generator:
    """The run's generator: any whole number is a seed (taken mod 2**64)."""
    return torch.Generator(device=device).manual_seed(seed % 2**64)
