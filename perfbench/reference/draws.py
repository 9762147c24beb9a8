"""The plain reference of the device stream's draws and synthesis, in plain
PyTorch.

A frozen copy of what the generative raw system draws and synthesises for
each stream of a batch under one 32-bit seed word, written apart from the
program: it imports nothing of it.  Streams lie on the last axis.

* The generator: Philox4x32-10 with Random123's constants, keyed by (seed
  word, 0), the counter (stream, draw index, purpose, 0).  Purposes: 0 the
  channel taps (index = tap), 3 the offset and the CFO (index 0: word 0
  the offset, word 1 the CFO), 4 the noise (index = row).
* Normals by Box-Muller from a word pair: u1 = (w0 >> 8)·2⁻²⁴ + 2⁻²⁵ and
  u2 = (w1 >> 8)·2⁻²⁴ in float32, r = sqrt(−2 ln u1) and θ = 2π·u2 in
  float64, (r cos θ, r sin θ) rounded to float32 once.
* The channel: taps of an exponential power-delay profile exp(−l/rms),
  summing to 1, ceil(5·rms) + 1 taps held to [8, 16]; a tap is a normal
  pair times sqrt(p_l/2) (both float32, the product float32); the CFR on the
  53 used bins (fftshifted, DC at 26) in float64, rounded to float32.
* The frame: the 16 symbol spectra (the LTS, then 15 blocks) times the CFR
  in float32, their 64-sample IDFTs in float64, rounded to float32 and then
  to the storage type; laid out as [last 32 | LTS | LTS], then
  [last 16 | 64] a block: 1,360 rows.
* The stream: the frame at 40 + (w0 & 0x7FFFFFFF) mod (NS − 1400), zeros
  elsewhere; with a CFO, eps = (2·u(w1) − 1)·cfo (cycles a sample, float32)
  turns row n by exp(2πi·eps·n), the angle (2π·eps)·n in float32, its cos
  and sin in float64 rounded to float32; then AWGN of per-plane scale
  sqrt(10^(−snr/10)/64/2), as a float32, over all NS rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_SC = 53
N_FFT = 64
N_CP = 16
N_BLOCKS = 15
FFT_SHIFT = 26
FRAME = 160 + N_BLOCKS * (N_FFT + N_CP)
MIN_OFFSET = 40
TAPS, OFFSET, NOISE = 0, 3, 4

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _mul32(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m·x, x 32-bit words in int64: m in two
    16-bit halves, so no product passes 2⁴⁹."""
    lo = x * (m & 0xFFFF)
    hi = x * (m >> 16)
    s = lo + ((hi & 0xFFFF) << 16)
    return ((hi >> 16) + (s >> 32)) & _MASK, s & _MASK


def philox(counter: list, key: int, device) -> list:
    """Philox4x32-10 of ``counter`` (four int64 tensors of words, which
    broadcast) under the key (``key``, 0)."""
    c = list(counter)
    k0 = torch.tensor(key & _MASK, dtype=torch.int64, device=device)
    k1 = torch.tensor(0, dtype=torch.int64, device=device)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mul32(_M0, c[0])
        hi1, lo1 = _mul32(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def words(key: int, streams: torch.Tensor, index: torch.Tensor, purpose: int) -> list:
    """The four words of each (index, stream): ``streams`` (B,), ``index``
    a column (n, 1) or 0-d, int64."""
    dev = streams.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return philox([streams, index, zero + purpose, zero], key, dev)


def uniform(w: torch.Tensor, open_low: bool = False) -> torch.Tensor:
    """(w >> 8)·2⁻²⁴ in float32, plus 2⁻²⁵ with ``open_low`` (then (0, 1])."""
    u = (w >> 8).to(torch.float32) * 2.0 ** -24
    return u + 2.0 ** -25 if open_low else u


def normals(w0: torch.Tensor, w1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Box-Muller: (re, im) float32 from a word pair."""
    r = torch.sqrt(-2.0 * torch.log(uniform(w0, True).to(torch.float64)))
    th = 2.0 * math.pi * uniform(w1).to(torch.float64)
    return (r * torch.cos(th)).to(torch.float32), (r * torch.sin(th)).to(torch.float32)


def n_taps(rms: float) -> int:
    return int(np.clip(int(np.ceil(5.0 * rms)) + 1, 8, 16))


def tap_scale(rms: float) -> np.ndarray:
    """(n_taps,) float32 sqrt(p_l/2) of the exponential profile."""
    p = np.exp(-np.arange(n_taps(rms)) / rms)
    return np.sqrt(p / p.sum() / 2.0).astype(np.float32)


def _bins() -> np.ndarray:
    return (np.arange(N_SC) - FFT_SHIFT) % N_FFT


def cfr_matrix(taps: int) -> tuple[np.ndarray, np.ndarray]:
    """(53, taps) float32 planes of exp(−2πi·k·l/64)."""
    w = np.exp(-2j * np.pi * np.outer(_bins(), np.arange(taps)) / N_FFT)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def idft_matrix() -> tuple[np.ndarray, np.ndarray]:
    """(64, 53) float32 planes of exp(2πi·n·k/64)/64."""
    v = np.exp(2j * np.pi * np.outer(np.arange(N_FFT), _bins()) / N_FFT) / N_FFT
    return v.real.astype(np.float32), v.imag.astype(np.float32)


def noise_scale(snr_db: float) -> float:
    return float(np.float32(np.sqrt(10.0 ** (-snr_db / 10.0) / N_FFT / 2.0)))


def cfo_scale(cfo_khz: float) -> float:
    """The largest |CFO| in cycles a sample at 20 MS/s, as a float32."""
    return float(np.float32(cfo_khz * 1e3 / 20e6))


class Draws:
    """One block of streams' draws: taps (re, im) (n_taps, B), offset and
    CFO words (B,), noise (re, im) (ns, B)."""

    def __init__(self, key: int, first: int, count: int, taps: int, ns: int, device):
        dev = torch.device(device)
        f = torch.arange(first, first + count, dtype=torch.int64, device=dev)
        col = torch.arange(taps, dtype=torch.int64, device=dev)[:, None]
        w = words(key, f, col, TAPS)
        self.taps = normals(w[0], w[1])
        w = words(key, f, torch.zeros((), dtype=torch.int64, device=dev), OFFSET)
        self.offset_word, self.cfo_word = w[0], w[1]
        w = words(key, f, torch.arange(ns, dtype=torch.int64, device=dev)[:, None], NOISE)
        self.noise = normals(w[0], w[1])


def synthesize(d: Draws, tx_blocks, tx_pre, rms: float, snr_db: float, cfo_khz: float,
               storage: torch.dtype = torch.bfloat16):
    """The streams of one block of draws.  ``tx_blocks`` (re, im) (53, ≥15)
    and ``tx_pre`` (re, im) (53, 1): the transmit spectra, float32.  Returns
    (field (re, im) (ns, B) float32, h_true (re, im) (53, B), offsets (B,)
    int64, eps (B,) float32)."""
    f32, f64 = torch.float32, torch.float64
    dev = d.noise[0].device
    ns, b = d.noise[0].shape
    ts = torch.tensor(tap_scale(rms), device=dev)[:, None]
    tr, ti = (d.taps[0] * ts).to(f64), (d.taps[1] * ts).to(f64)
    wr, wi = (torch.tensor(m, device=dev).to(f64) for m in cfr_matrix(ts.shape[0]))
    hr, hi = (wr @ tr - wi @ ti).to(f32), (wr @ ti + wi @ tr).to(f32)
    offs = MIN_OFFSET + (d.offset_word & 0x7FFFFFFF) % (ns - FRAME - MIN_OFFSET)

    sr = torch.cat([tx_pre[0], tx_blocks[0][:, :N_BLOCKS]], 1).T[:, :, None]   # (16, 53, 1)
    si = torch.cat([tx_pre[1], tx_blocks[1][:, :N_BLOCKS]], 1).T[:, :, None]
    xr, xi = sr * hr - si * hi, sr * hi + si * hr
    vr, vi = (torch.tensor(m, device=dev).to(f64) for m in idft_matrix())

    def rounded(t):
        return t.to(f32).to(storage).to(f32)

    sym = (rounded(vr @ xr.to(f64) - vi @ xi.to(f64)), rounded(vr @ xi.to(f64) + vi @ xr.to(f64)))

    def frame(s):
        parts = [s[0, 32:], s[0], s[0]]
        for blk in s[1:]:
            parts += [blk[N_FFT - N_CP:], blk]
        return torch.cat(parts)

    rows = offs[None, :] + torch.arange(FRAME, device=dev)[:, None]
    sig = [torch.zeros((ns, b), dtype=f32, device=dev).scatter_(0, rows, frame(s)) for s in sym]
    eps = torch.zeros(b, dtype=f32, device=dev)
    if cfo_khz > 0.0:
        eps = (2.0 * uniform(d.cfo_word) - 1.0) * cfo_scale(cfo_khz)
        ang = (_TWO_PI_F32 * eps)[None, :] * torch.arange(ns, dtype=f32, device=dev)[:, None]
        c, s = torch.cos(ang.to(f64)).to(f32), torch.sin(ang.to(f64)).to(f32)
        sig = [sig[0] * c - sig[1] * s, sig[0] * s + sig[1] * c]
    k = noise_scale(snr_db)
    field = (sig[0] + k * d.noise[0], sig[1] + k * d.noise[1])
    return field, (hr, hi), offs, eps
