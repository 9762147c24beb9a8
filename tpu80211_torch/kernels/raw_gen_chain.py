"""The generative raw system: synthesize → detect → estimate in one kernel.

The counterpart of ``tpu80211/kernels/raw_gen_chain.py``.  One hand-written
CUDA kernel (``csrc/raw_gen_chain.cu``) does, per block of 32 streams:

1. the channel draw of ``gen_chain`` (Philox normals, exponential-PDP taps);
2. the time-domain frame by 16 IDFTs (`_idft_mats`), with the long
   preamble's [last 32 | LTS | LTS] layout and each block's cyclic prefix,
   rounded to bf16 as the TPU kernel places it;
3. a random offset per stream in [40, NS − 1360), an optional per-stream
   CFO (``cfo_khz``), and AWGN over all NS rows, into an (NS, B) float32
   scratch field, written once, row by row (the frame's 1,024 distinct
   samples go first to a compact (B, 1024) scratch of bf16 pairs);
4. the decimated detection of ``detect_kernel`` on that field, and the
   tx-constant chain of ``fused_chain`` on each stream's aligned rows
   rounded to bf16 (serve, no eq, per-stream Σ|eq − tx|², ``sync`` when
   there is a CFO).

``gen_raw_plain`` is the same function in plain PyTorch on the same draws
(`raw_draws`): the field agrees bit for bit, so the detection does too.
The wrapper ``gen_raw_system`` runs it for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.synthetic_sc import noise_scale
from tpu80211_torch.kernels import _ffi
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import gen_chain as G
from tpu80211_torch.kernels._ffi import DOUBLE, FLOAT, INT, INT_PTR, PTR
from tpu80211_torch.ops import channel
from tpu80211_torch.utils import spans

LANES = G.LANES
MIN_OFFSET = 40           # the earliest frame start in a stream
FRAME = D.FRAME           # 1360 rows: long preamble + packet
SEARCH, ADVANCE = 192, 4  # the detector's fine window and timing advance
N_DISTINCT = (1 + C.N_BLOCKS) * C.N_FFT  # a frame's distinct samples: LTS and blocks
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))
_count_call = spans.counter("call.gen_raw_system")
_count_launch = spans.counter("launch.raw_gen_chain")
LIB = _ffi.Library("raw_gen_chain", {
    "raw_gen_launch": (PTR, INT, INT, INT, INT, FLOAT, FLOAT, INT, DOUBLE, INT, INT, INT, PTR),
    "raw_gen_attributes": (INT, INT, INT, INT_PTR),
})


@functools.lru_cache(maxsize=None)
def _idft_mats() -> tuple[np.ndarray, np.ndarray]:
    """(64, 53) split-plane matrix t = V @ spec mapping the 53 used bins
    (fftshifted order, DC at index 26) to 64 time samples."""
    k = (np.arange(C.N_SC) - C.FFT_SHIFT) % C.N_FFT
    v = np.exp(2j * np.pi * np.outer(np.arange(C.N_FFT), k) / C.N_FFT) / C.N_FFT
    return (np.ascontiguousarray(v.real, np.float32),
            np.ascontiguousarray(v.imag, np.float32))


@functools.lru_cache(maxsize=None)
def _idft_consts(device: torch.device) -> Cplx:
    return Cplx(*(torch.tensor(a, device=device) for a in _idft_mats()))


def span_of(ns: int) -> int:
    """The number of offsets a frame can take in ``ns`` rows; raises unless
    positive (the TPU kernel takes a modulus by it unchecked)."""
    span = ns - FRAME - MIN_OFFSET
    if span <= 0:
        raise ValueError(f"ns = {ns} leaves no room for a {FRAME}-row frame after "
                         f"{MIN_OFFSET} rows: need ns > {FRAME + MIN_OFFSET}")
    return span


def cfo_scale(cfo_khz: float) -> float:
    """The largest |CFO| in cycles per sample at 20 MS/s, as a float32 value."""
    return float(np.float32(cfo_khz * 1e3 / 20e6))


# -- the draws and the plain version -------------------------------------------------------


class RawDraws(NamedTuple):
    """One batch's draws, streams on the last axis."""

    taps: Cplx            # (n_taps, B) unit normals
    offset_word: torch.Tensor  # (B,) int64, 32-bit words
    cfo_word: torch.Tensor     # (B,)
    noise: Cplx           # (ns, B) unit normals


def raw_draws(seed, batch: int, n_taps: int, ns: int, device="cuda") -> RawDraws:
    """The kernel's draws of streams 0..batch−1 under ``seed`` (csrc/gen.cuh's
    counters)."""
    dev = torch.device(device)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=dev)
    w = G.draw(seed, batch, ar(n_taps)[:, None], G.TAPS, device=dev)
    taps = G.normal_pair(w[0], w[1])
    wo = G.draw(seed, batch, 0, G.OFFSET, device=dev)
    w = G.draw(seed, batch, ar(ns)[:, None], G.NOISE, device=dev)
    return RawDraws(taps, wo[0], wo[1], G.normal_pair(w[0], w[1]))


def synthesize(draws: RawDraws, txs: Cplx, tpre: Cplx, snr_db: float = 20.0,
               channel_model: str | None = None, cfo_khz: float = 0.0):
    """The kernel's field from given draws: (x Cplx (ns, B) float32, h_true
    Cplx (53, B), offsets (B,) int32, cfo_true (B,) float32)."""
    dev = txs.re.device
    f32, f64 = torch.float32, torch.float64
    ns, b = draws.noise.re.shape
    h = G.channel_from_taps(draws.taps, G.channel_consts(dev, channel_model))
    offs = (MIN_OFFSET + (draws.offset_word & 0x7FFFFFFF) % span_of(ns)).to(torch.int32)

    # 16 symbol spectra tx_s·H in float32, then their IDFTs in float64,
    # rounded to float32 and to bf16
    tr = torch.cat([tpre.re, txs.re[:, :C.N_BLOCKS]], 1).T[:, :, None]   # (16, 53, 1)
    ti = torch.cat([tpre.im, txs.im[:, :C.N_BLOCKS]], 1).T[:, :, None]
    xr, xi = tr * h.re - ti * h.im, tr * h.im + ti * h.re
    v = _idft_consts(dev)
    vr, vi = v.re.to(f64), v.im.to(f64)

    def bf16(t):
        return t.to(f32).to(torch.bfloat16).to(f32)

    sym_r = bf16(vr @ xr.to(f64) - vi @ xi.to(f64))                     # (16, 64, B)
    sym_i = bf16(vr @ xi.to(f64) + vi @ xr.to(f64))

    def frame(sym):  # (16, 64, B) → (1360, B): [last 32 | LTS | LTS], then [CP | 64] × 15
        parts = [sym[0, 32:], sym[0], sym[0]]
        for s in sym[1:]:
            parts += [s[C.N_FFT - C.N_CP:], s]
        return torch.cat(parts)

    rows = offs.to(torch.int64)[None, :] + torch.arange(FRAME, device=dev)[:, None]
    sig = [torch.zeros((ns, b), dtype=f32, device=dev).scatter_(0, rows, frame(s))
           for s in (sym_r, sym_i)]
    eps = torch.zeros(b, dtype=f32, device=dev)
    if cfo_khz > 0.0:
        eps = (2.0 * G.uniform(draws.cfo_word) - 1.0) * cfo_scale(cfo_khz)
        ang = (_TWO_PI_F32 * eps)[None, :] * torch.arange(ns, dtype=f32, device=dev)[:, None]
        c, s = torch.cos(ang.to(f64)).to(f32), torch.sin(ang.to(f64)).to(f32)
        sig = [sig[0] * c - sig[1] * s, sig[0] * s + sig[1] * c]
    nsc = noise_scale(snr_db)
    x = Cplx(sig[0] + nsc * draws.noise.re, sig[1] + nsc * draws.noise.im)
    return x, h, offs, eps


def gen_raw_assemble(draws: RawDraws, txs: Cplx, tpre: Cplx, lts_ref: Cplx,
                     snr_db: float = 20.0, channel_model: str | None = None,
                     threshold: float = 0.5, equalize_with: str = "h_linear",
                     cfo_khz: float = 0.0, return_field: bool = False) -> dict:
    """The kernel's system from given draws: `synthesize`, the plain
    decimated detection on the float32 field, then the plain chain on each
    stream's aligned rows rounded to bf16.  The output dict of
    `gen_raw_system`."""
    x, h, offs, eps = synthesize(draws, txs, tpre, snr_db, channel_model, cfo_khz)
    det = D.detect_plain(x, lts_ref, threshold, SEARCH, ADVANCE, decimate=True)
    lp, pkt = D.extract_lane_major(x, torch.where(det.detected, det.start, 0))
    bf = lambda c: c.map(lambda t: t.to(torch.bfloat16))  # noqa: E731
    consts = F.chain_consts(x.re.device, channel_model, snr_db)
    out = F.fused_chain_plain(bf(pkt), bf(lp), F.TxConst(txs, tpre), consts, serve=True,
                              equalize_with=equalize_with, sync=cfo_khz > 0.0, evm_sums=True)
    out["eq"] = None
    out.update(detected=det.detected, start=det.start, metric=det.metric, offsets=offs,
               h_true=h, cfo_true=eps)
    if return_field:
        out["field"] = x
    return out


def gen_raw_plain(seed, batch: int, txs: Cplx, tpre: Cplx, lts_ref: Cplx, ns: int = 2048,
                  snr_db: float = 20.0, channel_model: str | None = None,
                  threshold: float = 0.5, equalize_with: str = "h_linear",
                  cfo_khz: float = 0.0, return_field: bool = False) -> dict:
    """`gen_raw_system` in plain PyTorch, on ``txs``' device."""
    _check(batch, ns, txs, tpre, lts_ref, equalize_with, cfo_khz)
    draws = raw_draws(seed, batch, channel.n_taps_for(channel_model), ns, txs.re.device)
    return gen_raw_assemble(draws, txs, tpre, lts_ref, snr_db, channel_model, threshold,
                            equalize_with, cfo_khz, return_field)


def _check(batch, ns, txs, tpre, lts_ref, equalize_with, cfo_khz) -> None:
    span_of(ns)
    D.check_length(ns)  # so the detection of the field takes it: ns >= 1408
    if cfo_khz < 0.0:
        raise ValueError(f"cfo_khz must be >= 0, got {cfo_khz}")
    G._check(batch, txs, tpre, torch.float32)
    F.check_equalize_with(equalize_with)
    D.check_lts_ref(lts_ref, txs.re.device)


# -- the kernel ------------------------------------------------------------------------------


def gen_raw_system(seed, batch: int, txs: Cplx, tpre: Cplx, lts_ref: Cplx, ns: int = 2048,
                   snr_db: float = 20.0, channel_model: str | None = None,
                   threshold: float = 0.5, equalize_with: str = "h_linear",
                   cfo_khz: float = 0.0, return_field: bool = False) -> dict:
    """Synthesize and receive one batch of ``batch`` raw streams of ``ns``
    samples, on ``txs``' device.

    ``seed``: an int or a 0-d int32 tensor.  ``txs``/``tpre``: the
    tx-constant spectra; ``lts_ref``: the detector's (64,) LTS.  Returns
    detected (B,) bool, start (B,) int32 (−1 where undetected), metric,
    offsets (B,) int32 (the truth), h_true (53, B) Cplx, h_wiener/h_mmse
    (53, B) Cplx (the other h planes and eq are None), evm_sums, ow2, cfo,
    cfo_true and checksum (B,).  ``return_field`` adds ``field``, the
    synthesized (ns, B) float32 streams the receiver ran on.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (seed, batch, txs, tpre, lts_ref, ns, snr_db, channel_model, threshold,
            equalize_with, cfo_khz, return_field)
    _count_call()
    with spans.span("entry.gen_raw_system"):
        if txs.re.device.type == "cpu":
            return gen_raw_plain(*args)
        return _launch(*args)


def kernel_attributes(sync: bool = False) -> dict:
    """`_ffi.attributes` of the kernel without (``sync`` False) or with a
    CFO (32 streams a block)."""
    return _ffi.attributes(LIB.raw_gen_attributes, sync, SEARCH, D.stride_of(True)[0])


def _launch(seed, batch, txs, tpre, lts_ref, ns, snr_db, channel_model, threshold,
            equalize_with, cfo_khz, return_field, lib=None) -> dict:
    """One launch; ``lib``: a card probe's build of the source (`Library.at`)."""
    spans.phase("check")
    _check(batch, ns, txs, tpre, lts_ref, equalize_with, cfo_khz)
    spans.phase()
    dev = txs.re.device
    stride, _ = D.stride_of(True)
    cc = G.channel_consts(dev, channel_model)
    consts = F.chain_consts(dev, channel_model, snr_db)
    spans.phase("outputs")
    field = [torch.empty((ns, batch), dtype=torch.float32, device=dev) for _ in range(2)]
    frame = torch.empty((batch, N_DISTINCT), dtype=torch.int32, device=dev)
    out, outs = F.chain_outputs(batch, dev, torch.bfloat16, True, False, True)
    det_rows = D.detection_rows(batch, dev)
    offs = torch.empty(batch, dtype=torch.int32, device=dev)
    h_true = Cplx(*(torch.empty((C.N_SC, batch), dtype=torch.float32, device=dev)
                    for _ in range(2)))
    cfo_true = torch.empty(batch, dtype=torch.float32, device=dev)
    spans.phase("launch")
    _ffi.launch((lib or LIB).raw_gen_launch,
                [*txs, *tpre, *consts, *lts_ref, *_idft_consts(dev), *cc.wc, cc.tscale,
                 G.seed_tensor(seed, dev), *field, frame, *outs, *det_rows, offs, *h_true,
                 cfo_true],
                batch, ns, cc.tscale.shape[0], noise_scale(snr_db), cfo_scale(cfo_khz),
                F.EQUALIZE_WITH.index(equalize_with), float(threshold), SEARCH, ADVANCE, stride,
                counter=_count_launch)
    spans.phase()
    det, _, start, metric = det_rows
    _ffi.count_torch()   # det != 0: one elementwise kernel
    out.update(detected=det != 0, start=start, metric=metric, offsets=offs, h_true=h_true,
               cfo_true=cfo_true)
    if return_field:
        out["field"] = Cplx(*field)
    return out
