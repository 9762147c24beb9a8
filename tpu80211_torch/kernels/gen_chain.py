"""The generative fused chain: frames drawn inside the chain kernel.

The counterpart of ``tpu80211/kernels/gen_chain.py``.  One hand-written CUDA
kernel (``csrc/gen_chain.cu``) draws, per frame, a channel (exponential-PDP
taps, CFR = W @ taps) and the noise of two preamble repeats and 15 block
spectra, then runs the chain in the frequency domain: σ̂² from the repeat
difference (with the 64/53 factor of noise on 53 bins only), LT-LS, the five
pilot interpolators, the rank-1 MMSE and the PS-Linear blend.  Only the
outputs touch device memory; the only input is a seed and a few constants.

The draws come from the counter-based generator of ``csrc/gen.cuh``:
Philox4x32-10 keyed by the seed, with (frame, draw index, purpose) in the
counter, so a frame's numbers depend on (seed, frame) alone, never on the
batch size or the order in which blocks run.  ``philox`` and
``normal_pair`` here compute the same words and the same normals in torch
int64 and float64, bit for bit; ``gen_chain_plain`` is the whole kernel in
plain PyTorch on them.  The wrapper ``fused_gen_chain`` runs the plain
version for CPU tensors only; a CUDA tensor launches the kernel or raises.

Where the TPU kernel and its CPU twin (``_gen_chain_jax``) differ, this
module follows the kernel: the noise is scaled at the kernel's rounding
points, and eq enters the checksum in float32, before its cast.  The TPU
kernel's ``probe`` knob (perf anatomy) and its polynomial ``_fast_log`` are
not ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import _build, require_cuda
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.ops import channel

LANES = 128  # the stream record's frames, and the batch granule
N_TAPS = channel.LEGACY_N_TAPS
RMS_SPREAD = channel.LEGACY_RMS_SAMPLES  # the legacy profile's rms delay spread, samples
INTERP_KINDS = F.INTERP_KINDS
_OUT_NAMES = F.OUT_NAMES
N_SUMS = len(_OUT_NAMES) + 1  # stream sums: 7 estimators' Σ|ĥ − h|², then Σ|h|²

# kernel launches since the count was last set to 0 (the plain version never
# counts)
launches = 0

# -- the counter-based generator (csrc/gen.cuh) ----------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 multipliers (Random123)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # key bumps
_MASK = 0xFFFFFFFF
# counter purposes (csrc/gen.cuh): which draw a counter's third word names
TAPS, PREAMBLE, BLOCK, OFFSET, NOISE = range(5)
_TWO_PI = 6.283185307179586


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m·x for words x in int64, with no product
    above 2⁴⁹: m is split in 16-bit halves."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (s >> 32)) & _MASK, s & _MASK


def philox(c0, c1, c2, c3, k0, k1=0) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1):
    four int64 tensors of 32-bit words, broadcast against each other."""
    c = [torch.as_tensor(v, dtype=torch.int64) if not isinstance(v, torch.Tensor) else v
         for v in (c0, c1, c2, c3)]
    k0 = torch.as_tensor(k0, dtype=torch.int64, device=c[0].device)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=c[0].device)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return tuple(c)


def seed_word(seed, device) -> torch.Tensor:
    """The key's first word: an int seed, or a 0-d int32 tensor, as its
    32-bit two's-complement word (int64 on ``device``)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64) & _MASK
    return torch.tensor(int(seed) & _MASK, dtype=torch.int64, device=device)


def draw(seed, frames: int, index, purpose: int, sub=0, device=None):
    """The Philox words of every frame 0..frames−1 (the last axis) at draw
    ``index`` (a tensor broadcasting against (1, frames), or an int)."""
    dev = torch.device(device) if device is not None else None
    f = torch.arange(frames, dtype=torch.int64, device=dev)
    index = torch.as_tensor(index, dtype=torch.int64, device=dev)
    sub = torch.as_tensor(sub, dtype=torch.int64, device=dev)
    return philox(f, index, torch.tensor(purpose, device=dev), sub, seed_word(seed, dev))


def uniform_open(w: torch.Tensor) -> torch.Tensor:
    """(0, 1] float32: (w >> 8)·2⁻²⁴ + 2⁻²⁵."""
    return (w >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25


def uniform(w: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32: (w >> 8)·2⁻²⁴."""
    return (w >> 8).to(torch.float32) * 2.0 ** -24


def normal_pair(a: torch.Tensor, b: torch.Tensor) -> Cplx:
    """Two standard normals per word pair (Box-Muller): the radius, the
    angle, its cos and sin and the products in float64, rounded to float32
    once (the kernel's rounding)."""
    r = torch.sqrt(-2.0 * torch.log(uniform_open(a).to(torch.float64)))
    th = _TWO_PI * uniform(b).to(torch.float64)
    return Cplx((r * torch.cos(th)).to(torch.float32), (r * torch.sin(th)).to(torch.float32))


# -- constants ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pdp_scale(model: str | None = None) -> np.ndarray:
    """(n_taps, 1) per-tap normal scale sqrt(p_l / 2), exponential PDP."""
    return np.sqrt(channel.pdp(model) / 2.0).astype(np.float32)[:, None]


@functools.lru_cache(maxsize=None)
def _cfr_mats(n_taps: int = N_TAPS) -> tuple[np.ndarray, np.ndarray]:
    """(53, n_taps) taps→CFR evaluation matrix, split planes (numpy)."""
    k = (np.arange(C.N_SC) - C.FFT_SHIFT) % C.N_FFT
    w = np.exp(-2j * np.pi * np.outer(k, np.arange(n_taps)) / C.N_FFT)
    return (np.ascontiguousarray(w.real, np.float32),
            np.ascontiguousarray(w.imag, np.float32))


class ChannelConsts(NamedTuple):
    """The channel draw's constants on one device, float32."""

    wc: Cplx               # (53, n_taps) taps → CFR
    tscale: torch.Tensor   # (n_taps,) per-tap normal scale


def channel_consts(device, model: str | None = None) -> ChannelConsts:
    """`_cfr_mats` and `_pdp_scale` of ``model`` on ``device`` (cached)."""
    return _channel_consts(torch.device(device), model)


@functools.lru_cache(maxsize=None)
def _channel_consts(device: torch.device, model) -> ChannelConsts:
    scale = _pdp_scale(model)
    wr, wi = _cfr_mats(scale.shape[0])
    t = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    return ChannelConsts(Cplx(t(wr), t(wi)), t(scale[:, 0]))


def freq_noise_scale(snr_db: float) -> float:
    """Per-plane normal scale of a bin's noise: sqrt(64·σ_t²/2) with
    σ_t² = 10^(−snr/10)/64, as a float32 value."""
    sigma_t2 = (10.0 ** (-snr_db / 10.0)) / C.N_FFT
    return float(np.float32(np.sqrt(C.N_FFT * sigma_t2 / 2.0)))


def channel_from_taps(z: Cplx, consts: ChannelConsts) -> Cplx:
    """(53, B) CFR from (n_taps, B) unit normals: taps z·tscale in float32,
    then W @ taps in float64, rounded to float32 once (the kernel's sum)."""
    f64 = torch.float64
    ts = consts.tscale[:, None]
    tr, ti = (z.re * ts).to(f64), (z.im * ts).to(f64)
    wr, wi = consts.wc.re.to(f64), consts.wc.im.to(f64)
    return Cplx((wr @ tr - wi @ ti).to(torch.float32), (wr @ ti + wi @ tr).to(torch.float32))


# -- the draws and the plain version -------------------------------------------------------


class GenDraws(NamedTuple):
    """One batch's unit normals, frames on the last axis."""

    taps: Cplx    # (n_taps, B)
    pre1: Cplx    # (53, B) preamble repeat 1
    pre2: Cplx    # (53, B) preamble repeat 2
    blocks: Cplx  # (15, 53, B)


def gen_draws(seed, batch: int, n_taps: int = N_TAPS, device="cuda") -> GenDraws:
    """The kernel's normals of frames 0..batch−1 under ``seed`` (an int or a
    0-d int32 tensor), drawn by `philox` with the counters of csrc/gen.cuh."""
    dev = torch.device(device)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=dev)
    w = draw(seed, batch, ar(n_taps)[:, None], TAPS, device=dev)
    taps = normal_pair(w[0], w[1])
    w = draw(seed, batch, ar(C.N_SC)[:, None], PREAMBLE, device=dev)
    pre1, pre2 = normal_pair(w[0], w[1]), normal_pair(w[2], w[3])
    w = draw(seed, batch, ar(C.N_SC)[None, :, None], BLOCK, ar(C.N_BLOCKS)[:, None, None],
             device=dev)
    return GenDraws(taps, pre1, pre2, normal_pair(w[0], w[1]))


def gen_assemble(draws: GenDraws, txs: Cplx, tpre: Cplx, snr_db: float = 20.0,
                 eq_dtype: torch.dtype = torch.bfloat16, channel_model: str | None = None,
                 stream_sums: bool = False) -> dict:
    """The kernel's frames and chain from given unit normals (`gen_draws`'
    layout): the output dict of `fused_gen_chain`.  Sums over bins run in
    another order than the kernel's; every rounding point of the synthesis
    (the channel, tpre·H, the scaled noise) is the kernel's."""
    dev = txs.re.device
    f32 = torch.float32
    b = draws.taps.re.shape[-1]
    nblk, nb = C.N_BLOCKS, C.N_AVG_BLOCKS
    h = channel_from_taps(draws.taps, channel_consts(dev, channel_model))
    nsc = freq_noise_scale(snr_db)
    half = nsc * 0.5

    # -- preamble: two noisy repeats, averaged; σ̂² from their difference --
    tpr, tpi = tpre.re, tpre.im                                  # (53, 1)
    cl_r, cl_i = tpr * h.re - tpi * h.im, tpr * h.im + tpi * h.re
    n1, n2 = draws.pre1, draws.pre2
    rpre_r = cl_r + half * (n1.re + n2.re)
    rpre_i = cl_i + half * (n1.im + n2.im)
    dr, di = nsc * (n2.re - n1.re), nsc * (n2.im - n1.im)
    ow2 = (dr * dr + di * di).sum(0) / (2.0 * C.N_FFT * C.N_SC)   # unbiased: 64/53

    dc = (torch.arange(C.N_SC, device=dev) == C.DC_IDX)[:, None]
    denom = torch.where(dc, 1.0, tpr * tpr + tpi * tpi)
    hlt_r = torch.where(dc, 0.0, (tpr * rpre_r + tpi * rpre_i) / denom)
    hlt_i = torch.where(dc, 0.0, (tpr * rpre_i - tpi * rpre_r) / denom)
    planes = {"h_lt": (hlt_r, hlt_i)}
    chk = ow2 + (hlt_r + hlt_i).sum(0)

    # -- rx block spectra tx·H + noise, pilot ratios of blocks 0..3 --
    tbr = txs.re[:, :nblk].T[:, :, None]                          # (15, 53, 1)
    tbi = txs.im[:, :nblk].T[:, :, None]
    rbr = (tbr * h.re - tbi * h.im) + nsc * draws.blocks.re
    rbi = (tbr * h.im + tbi * h.re) + nsc * draws.blocks.im

    def cdiv(ar, ai, br, bi):
        d = br * br + bi * bi
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d

    p = list(C.PILOT_IDX)
    hpr, hpi = cdiv(rbr[:nb, p], rbi[:nb, p], tbr[:nb, p], tbi[:nb, p])   # (4, 4, B)
    hsr, hsi = hpr.sum(0), hpi.sum(0)
    consts = F.chain_consts(dev, channel_model, snr_db)
    for idx, kind in enumerate(INTERP_KINDS):
        wr, wi = consts.win_re[idx], consts.win_im[idx]
        acc_r, acc_i = wr @ hsr, wr @ hsi
        if kind == "wiener":
            acc_r, acc_i = acc_r - wi @ hsi, acc_i + wi @ hsr
        planes[f"h_{kind}"] = (acc_r / nb, acc_i / nb)
        chk = chk + (acc_r / nb + acc_i / nb).sum(0)

    # -- MMSE, rank-1 closed form --
    acc_r, acc_i = torch.zeros_like(hlt_r), torch.zeros_like(hlt_i)
    for k in range(nb):
        ur, ui = tbr[k] * hlt_r - tbi[k] * hlt_i, tbr[k] * hlt_i + tbi[k] * hlt_r
        den = ow2 + (ur * ur + ui * ui).sum(0)
        sr = (ur * rbr[k] + ui * rbi[k]).sum(0) / den
        si = (ur * rbi[k] - ui * rbr[k]).sum(0) / den
        acc_r = acc_r + (hlt_r * sr - hlt_i * si)
        acc_i = acc_i + (hlt_r * si + hlt_i * sr)
    planes["h_mmse"] = (acc_r / nb, acc_i / nb)
    chk = chk + (acc_r / nb + acc_i / nb).sum(0)

    # -- equalize: the PS-Linear blend, DC to zero; eq summed before its cast --
    hl_r, hl_i = planes["h_linear"]
    w_ps = torch.arange(1, nblk + 1, dtype=f32, device=dev)[:, None, None] / nblk
    w_lt = torch.arange(nblk - 1, -1, -1, dtype=f32, device=dev)[:, None, None] / nblk
    hur = torch.where(dc, 1.0, w_lt * hlt_r + w_ps * hl_r)
    hui = torch.where(dc, 0.0, w_lt * hlt_i + w_ps * hl_i)
    er, ei = cdiv(rbr, rbi, hur, hui)
    er, ei = torch.where(dc, 0.0, er), torch.where(dc, 0.0, ei)
    chk = chk + (er + ei).sum((0, 1))

    out = {name: Cplx(*planes[name]) for name in _OUT_NAMES}
    out.update(eq=Cplx(er.to(eq_dtype), ei.to(eq_dtype)), ow2=ow2, h_true=h, checksum=chk)
    if not stream_sums:
        return out
    per_frame = torch.stack([((out[n].re - h.re) ** 2 + (out[n].im - h.im) ** 2).sum(0)
                             for n in _OUT_NAMES] + [(h.re * h.re + h.im * h.im).sum(0)])
    return _stream_record(out, per_frame, b)


def _stream_record(out: dict, per_frame: torch.Tensor, b: int) -> dict:
    """Stream mode: the (8, B) per-frame sums folded to (8, 128) lanes (row
    k sums frames f ≡ lane mod 128), and every plane but the checksum cut
    to frames [B − 128, B)."""
    res = {k: v if k == "checksum" else v.map(lambda t: t[..., -LANES:])
           if isinstance(v, Cplx) else v[..., -LANES:] for k, v in out.items()}
    res["sums"] = per_frame.view(N_SUMS, b // LANES, LANES).sum(1)
    return res


def gen_chain_plain(seed, batch: int, txs: Cplx, tpre: Cplx, snr_db: float = 20.0,
                    eq_dtype: torch.dtype = torch.bfloat16, channel_model: str | None = None,
                    stream_sums: bool = False) -> dict:
    """`fused_gen_chain` in plain PyTorch, on ``txs``' device: the same
    draws (`gen_draws`), then `gen_assemble`."""
    _check(batch, txs, tpre, eq_dtype)
    n_taps = channel_consts(txs.re.device, channel_model).tscale.shape[0]
    draws = gen_draws(seed, batch, n_taps, txs.re.device)
    return gen_assemble(draws, txs, tpre, snr_db, eq_dtype, channel_model, stream_sums)


def _check(batch: int, txs: Cplx, tpre: Cplx, eq_dtype: torch.dtype) -> None:
    if batch < LANES or batch % LANES:
        raise ValueError(f"batch must be a positive multiple of {LANES}, got {batch}")
    if eq_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"eq_dtype must be float32 or bfloat16, got {eq_dtype}")
    for name, c, shape in (("txs", txs, (C.N_SC, F.NB_PAD)), ("tpre", tpre, (C.N_SC, 1))):
        for t in c:
            if tuple(t.shape) != shape or t.dtype != torch.float32:
                raise ValueError(f"{name}: want {shape} float32, got {tuple(t.shape)} {t.dtype}")
            if t.device != txs.re.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {txs.re.device}")


# -- the kernel ------------------------------------------------------------------------------


def fused_gen_chain(seed, batch: int, txs: Cplx, tpre: Cplx, snr_db: float = 20.0,
                    eq_dtype: torch.dtype = torch.bfloat16, channel_model: str | None = None,
                    stream_sums: bool = False) -> dict:
    """Draw ``batch`` frames and run the chain on them, on ``txs``' device.

    ``seed``: an int or a 0-d int32 tensor (read on the device: a stream
    step can derive it there).  ``txs`` (53, 16), ``tpre`` (53, 1): the
    tx-constant spectra (`fused_chain.tx_spectra`).  ``channel_model`` ∈
    {None, 'A'..'E'} picks the power-delay profile and, with ``snr_db``, the
    Wiener interpolator's prior.  Returns h_* Cplx (53, B) float32, eq Cplx
    (15, 53, B) in ``eq_dtype``, ow2 (B,), h_true Cplx (53, B) and checksum
    (B,).

    ``stream_sums=True`` is the streaming configuration: ``sums`` (8, 128)
    holds, per lane, Σ over frames f ≡ lane (mod 128) of Σ|ĥ − h|² for each
    estimator and then of Σ|h|²; every other output but the checksum holds
    frames [B − 128, B) only.  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if txs.re.device.type == "cpu":
        return gen_chain_plain(seed, batch, txs, tpre, snr_db, eq_dtype, channel_model,
                               stream_sums)
    return _launch(seed, batch, txs, tpre, snr_db, eq_dtype, channel_model, stream_sums)


def seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` as a 0-d int32 tensor on ``device``: a tensor is moved (no
    copy if it is there already), an int is wrapped to 32 bits and filled
    in on the device (no host-to-device copy)."""
    if isinstance(seed, torch.Tensor):
        if seed.dim() != 0:
            raise ValueError(f"seed must be a 0-d tensor, got shape {tuple(seed.shape)}")
        return seed.to(device=device, dtype=torch.int32)
    return torch.full((), wrap_i32(int(seed)), dtype=torch.int32, device=device)


def wrap_i32(v):
    """An integer (or int64 tensor) as the int32 it wraps to."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def bind(lib):
    """(launch, error string) of a library built from csrc/gen_chain.cu (or
    from a variant of it), with the ctypes signatures of its functions set."""
    fn = lib.gen_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gen_chain_attributes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.gen_chain_attributes.restype = ctypes.c_int
    err_string = lib.gen_chain_error_string
    err_string.argtypes = [ctypes.c_int]
    err_string.restype = ctypes.c_char_p
    return fn, err_string


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return bind(_build.load("gen_chain"))


def kernel_attributes(eq_dtype: torch.dtype = torch.bfloat16, lib=None) -> dict:
    """The kernel that `fused_gen_chain` launches for eq in ``eq_dtype`` (the
    same in stream and full mode), on the current card: registers and local
    (spill) bytes a thread, shared bytes a block, and resident blocks per SM
    (32 frames a block).  ``lib``: another build of the source."""
    lib = lib or _build.load("gen_chain")
    _, err_string = bind(lib)
    out = (ctypes.c_int * 4)()
    F.raise_on_error(lib.gen_chain_attributes(int(eq_dtype == torch.bfloat16), out), "gen_chain",
                     err_string)
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))


def kernel_normals(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                              torch.Tensor, Cplx]:
    """The kernels' Box-Muller (csrc/gen.cuh::normal_pair) on the card, for
    word pairs (a, b): 1-d int64 CUDA tensors of 32-bit words.  Returns the
    radius, the angle's sin and cos (float64) and the normals (float32), to
    hold them against `normal_pair`; the generative kernels draw their own
    words and never call this."""
    require_cuda(a)
    if a.shape != b.shape or a.dim() != 1 or a.device != b.device:
        raise ValueError(f"want two 1-d word tensors on one device, got {a.shape}, {b.shape}")
    _, err_string = _kernel_fn()
    fn = _build.load("gen_chain").gen_normals_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev, n = a.device, a.shape[0]
    words = [wrap_i32(w).to(torch.int32).contiguous() for w in (a, b)]
    terms = [torch.empty(n, dtype=torch.float64, device=dev) for _ in range(3)]
    z = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ptrs = F.pointer_table([*words, *terms, z])
    with torch.cuda.device(dev):
        err = fn(ptrs, n, torch.cuda.current_stream(dev).cuda_stream)
    F.raise_on_error(err, "gen_chain normals", err_string)
    return (*terms, Cplx(z[:, 0], z[:, 1]))


def _launch(seed, batch, txs, tpre, snr_db, eq_dtype, channel_model, stream_sums,
            kernel=None) -> dict:
    """One launch; ``kernel`` = `bind` of another build of the source (the
    card probe's variants), else the package's own."""
    global launches
    _check(batch, txs, tpre, eq_dtype)
    require_cuda(txs.re)
    fn, err_string = kernel or _kernel_fn()
    dev = txs.re.device
    seed_t = seed_tensor(seed, dev)
    cc = channel_consts(dev, channel_model)
    consts = F.chain_consts(dev, channel_model, snr_db)
    cols = LANES if stream_sums else batch

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {name: Cplx(empty(C.N_SC, cols), empty(C.N_SC, cols)) for name in _OUT_NAMES}
    out["eq"] = Cplx(empty(C.N_BLOCKS, C.N_SC, cols, dtype=eq_dtype),
                     empty(C.N_BLOCKS, C.N_SC, cols, dtype=eq_dtype))
    out.update(ow2=empty(cols), h_true=Cplx(empty(C.N_SC, cols), empty(C.N_SC, cols)),
               checksum=empty(batch))
    per_frame = empty(N_SUMS, batch) if stream_sums else None
    outs = [t for name in (*_OUT_NAMES, "eq") for t in out[name]]
    outs += [out["ow2"], *out["h_true"], out["checksum"], per_frame]
    ptrs = F.pointer_table([*txs, *tpre, *cc.wc, cc.tscale, consts.win_re, consts.win_im,
                            seed_t, *outs])
    with torch.cuda.device(dev):
        err = fn(ptrs, len(ptrs), batch, cc.tscale.shape[0], freq_noise_scale(snr_db),
                 eq_dtype == torch.bfloat16, torch.cuda.current_stream(dev).cuda_stream)
    F.raise_on_error(err, "gen_chain", err_string)
    launches += 1
    if stream_sums:
        out["sums"] = per_frame.view(N_SUMS, batch // LANES, LANES).sum(1)
    return out
