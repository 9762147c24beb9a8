"""Lane-major split-complex frame generator on the device.

The counterpart of ``tpu80211/datasets/synthetic_sc.py``: the rx side of a
tx-constant frame stream synthesized on the device that runs the chain, in
the lane-major layout the chain kernels read, so a streamed step is

    draws → [assemble on the device] → [chain kernel] → summaries

with no per-frame host traffic.  Every frame carries the same known packet
(its spectra from ``kernels.fused_chain.tx_spectra``); per frame a fresh
channel (exponential-PDP FIR taps, CFR = W @ taps) and AWGN of variance
σ_t² = 10^(−snr/10)/64 per complex time sample, added in the time domain
(so the chain's σ̂² reads back σ_t²).

Each generator is split in two: ``*_draws`` draws the normals and offsets
with an explicit ``torch.Generator`` on the generator's device, and the
assembly turns given draws into frames.  A test can so feed the JAX
package's own draws to the port's assembly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.ops import channel, specmats

N_TAPS = channel.LEGACY_N_TAPS
RMS_SPREAD = channel.LEGACY_RMS_SAMPLES
FRAME = C.PREAMBLE_SAMPLES + C.PACKET_SAMPLES


@functools.lru_cache(maxsize=None)
def _synth_mats(n_taps: int = N_TAPS):
    """The (64, 53) IDFT, right-inverse of the block extraction, and the
    (n_taps, 53) taps→CFR evaluation matrix, as float32 numpy planes."""
    wre, wim = specmats.block_dft()          # spec = Wᵀ @ time
    a_re = np.asarray(wre, np.float32) / C.N_FFT   # time = conj(W) @ spec / 64
    a_im = -np.asarray(wim, np.float32) / C.N_FFT
    k = (np.arange(C.N_SC) - C.FFT_SHIFT) % C.N_FFT
    w = np.exp(-2j * np.pi * np.outer(np.arange(n_taps), k) / C.N_FFT)
    return (a_re, a_im, np.ascontiguousarray(w.real, np.float32),
            np.ascontiguousarray(w.imag, np.float32))


@functools.lru_cache(maxsize=None)
def _mats(n_taps: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """`_synth_mats` on ``device``, cached: an upload per call would block
    the host on the previous step's kernels."""
    return tuple(torch.tensor(a, device=device) for a in _synth_mats(n_taps))


@functools.lru_cache(maxsize=None)
def _tap_scale(channel_model: str | None, device: torch.device) -> torch.Tensor:
    p = channel.pdp(channel_model)
    return torch.tensor(np.sqrt(p / 2.0), dtype=torch.float32, device=device)[:, None]


def _idft_cols(spec: Cplx) -> Cplx:
    """(53, B) spectrum → (64, B) time samples (one OFDM symbol), float32."""
    a_re, a_im, _, _ = _mats(N_TAPS, spec.re.device)
    return Cplx(a_re @ spec.re - a_im @ spec.im, a_re @ spec.im + a_im @ spec.re)


def _normals(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def channel_draws(gen: torch.Generator, batch: int,
                  channel_model: str | None = None) -> Cplx:
    """(n_taps, B) unit normals of the channel taps, on ``gen``'s device."""
    n = channel.n_taps_for(channel_model)
    return Cplx(_normals(gen, n, batch), _normals(gen, n, batch))


def cfr_from_draws(z: Cplx, channel_model: str | None = None) -> Cplx:
    """(53, B) CFR of taps z·sqrt(p_l/2) (float32, as the JAX generator)."""
    scale = _tap_scale(channel_model, z.re.device)
    _, _, w_re, w_im = _mats(scale.shape[0], z.re.device)
    t_re, t_im = z.re * scale, z.im * scale
    return Cplx(w_re.T @ t_re - w_im.T @ t_im, w_re.T @ t_im + w_im.T @ t_re)


def channel_cfr(gen: torch.Generator, batch: int, channel_model: str | None = None) -> Cplx:
    """(53, B) per-frame CFR from exponential-PDP taps (lane-major).
    ``channel_model`` ∈ {None, 'A'..'E'} (ops/channel.py)."""
    return cfr_from_draws(channel_draws(gen, batch, channel_model), channel_model)


def noise_scale(snr_db: float) -> float:
    """Per-plane normal scale of a time sample's AWGN, sqrt(σ_t²/2), as a
    float32 value."""
    sigma_t2 = (10.0 ** (-snr_db / 10.0)) / C.N_FFT
    return float(np.float32(np.sqrt(sigma_t2 / 2.0)))


class RxDraws(NamedTuple):
    """Unit normals of one rx batch, frames on the last axis."""

    taps: Cplx               # (n_taps, B)
    pkt_noise: Cplx | None   # (1200, B)
    lp_noise: Cplx | None    # (160, B)


def rx_draws(gen: torch.Generator, batch: int, channel_model: str | None = None,
             noise: bool = True) -> RxDraws:
    taps = channel_draws(gen, batch, channel_model)
    if not noise:
        return RxDraws(taps, None, None)
    pkt = Cplx(_normals(gen, C.PACKET_SAMPLES, batch), _normals(gen, C.PACKET_SAMPLES, batch))
    lp = Cplx(_normals(gen, C.PREAMBLE_SAMPLES, batch), _normals(gen, C.PREAMBLE_SAMPLES, batch))
    return RxDraws(taps, pkt, lp)


def assemble_rx(draws: RxDraws, txs: Cplx, tpre: Cplx, snr_db: float = 20.0,
                dtype: torch.dtype = torch.bfloat16, channel_model: str | None = None):
    """One lane-major rx batch from given draws: (rx_pkt (1200, B), rx_lp
    (160, B)) in ``dtype`` and h (53, B) float32.  Each symbol is rounded
    to ``dtype`` before the noise, scaled in float32 and rounded to
    ``dtype`` too, is added (the JAX generator's rounding points)."""
    h = cfr_from_draws(draws.taps, channel_model)
    nsc = noise_scale(snr_db)

    def noisy(x: Cplx, n: Cplx | None) -> Cplx:
        if n is None:
            return x
        return Cplx(x.re + (n.re * nsc).to(dtype), x.im + (n.im * nsc).to(dtype))

    pieces = []
    for b in range(C.N_BLOCKS):
        spec = Cplx(txs.re[:, b:b + 1] * h.re - txs.im[:, b:b + 1] * h.im,
                    txs.re[:, b:b + 1] * h.im + txs.im[:, b:b + 1] * h.re)
        t = _idft_cols(spec).map(lambda v: v.to(dtype))
        pieces += [t.map(lambda v: v[-C.N_CP:]), t]
    pkt = noisy(Cplx(torch.cat([p.re for p in pieces]), torch.cat([p.im for p in pieces])),
                draws.pkt_noise)
    # long preamble: LTS·H → one 64-sample symbol, laid out [last 32 | LTS | LTS]
    t64 = _idft_cols(Cplx(tpre.re * h.re - tpre.im * h.im, tpre.re * h.im + tpre.im * h.re))
    t64 = t64.map(lambda v: v.to(dtype))
    lp = noisy(t64.map(lambda v: torch.cat([v[-32:], v, v])), draws.lp_noise)
    return pkt, lp, h


def generate_rx_lane_major(gen: torch.Generator, batch: int, txs: Cplx, tpre: Cplx,
                           snr_db: float = 20.0, dtype: torch.dtype = torch.bfloat16,
                           channel_model: str | None = None, noise: bool = True):
    """Synthesize one lane-major rx batch through a fresh channel, on
    ``gen``'s device (``txs``/``tpre`` lie there too).

    txs: (53, 16) tx block spectra (columns 0..14 used), tpre: (53, 1).
    Returns (rx_pkt (1200, B), rx_lp (160, B), h (53, B)): packet and
    preamble planes in ``dtype``, h in float32.  ``noise=False`` returns the
    clean channel-filtered frame."""
    return assemble_rx(rx_draws(gen, batch, channel_model, noise), txs, tpre, snr_db, dtype,
                       channel_model)


class RawStreamDraws(NamedTuple):
    """Draws of one batch of raw streams, streams on the last axis."""

    taps: Cplx            # (n_taps, B) unit normals
    offsets: torch.Tensor  # (B,) int32 in [min_off, ns − 1360)
    noise: Cplx           # (ns, B) unit normals


def raw_draws(gen: torch.Generator, batch: int, ns: int = 2048,
              channel_model: str | None = None, min_off: int = 40) -> RawStreamDraws:
    """One batch's draws; the offsets lie in [min_off, ns − 1360) by
    construction, so the placement needs no host-side check of them."""
    if min_off < 0:
        raise ValueError(f"min_off must be >= 0, got {min_off}")
    if ns < FRAME + min_off:
        raise ValueError(f"ns = {ns} is shorter than a {FRAME}-sample frame after {min_off}")
    taps = channel_draws(gen, batch, channel_model)
    offs = torch.randint(min_off, ns - FRAME, (batch,), generator=gen, device=gen.device,
                         dtype=torch.int32)
    return RawStreamDraws(taps, offs, Cplx(_normals(gen, ns, batch), _normals(gen, ns, batch)))


def assemble_raw(draws: RawStreamDraws, txs: Cplx, tpre: Cplx, snr_db: float = 20.0,
                 dtype: torch.dtype = torch.bfloat16, channel_model: str | None = None):
    """Raw streams from given draws: the clean frame at offset 0 of an
    (ns, B) zero field, placed at each stream's offset over the noise by
    ``place_streams`` (the placement kernel on a CUDA device).  Returns
    (x (ns, B) in ``dtype``, h (53, B) float32, offsets (B,) int32)."""
    from tpu80211_torch.kernels.detect_kernel import place_streams

    ns, b = draws.noise.re.shape
    pkt, lp, h = assemble_rx(RxDraws(draws.taps, None, None), txs, tpre, snr_db, dtype,
                             channel_model)
    pad = torch.zeros((ns - FRAME, b), dtype=dtype, device=pkt.re.device)
    sig = Cplx(torch.cat([lp.re, pkt.re, pad]), torch.cat([lp.im, pkt.im, pad]))
    nsc = noise_scale(snr_db)
    noise = draws.noise.map(lambda n: (n * nsc).to(dtype))
    return place_streams(sig, noise, draws.offsets), h, draws.offsets


def generate_raw_lane_major(gen: torch.Generator, batch: int, txs: Cplx, tpre: Cplx,
                            ns: int = 2048, snr_db: float = 20.0,
                            dtype: torch.dtype = torch.bfloat16,
                            channel_model: str | None = None, min_off: int = 40):
    """Synthesize lane-major raw sample streams on ``gen``'s device: each
    stream is ``ns`` samples of AWGN carrying one channel-filtered frame
    (preamble + packet) at a random offset in [min_off, ns − 1360).  The
    raw receiver's workload.  Returns (x (ns, B) Cplx in ``dtype``, h (53,
    B) float32, offsets (B,) int32)."""
    return assemble_raw(raw_draws(gen, batch, ns, channel_model, min_off), txs, tpre, snr_db,
                        dtype, channel_model)
