"""The fused receive chain: packets in → estimates + equalized blocks out.

The counterpart of ``tpu80211/kernels/fused_chain.py``.  One hand-written
CUDA kernel (``csrc/fused_chain.cu``) runs the whole chain per frame —
preamble and block DFTs, σ², LT-LS, four pilot-LS interpolators and the
Wiener one, the rank-1 MMSE, and the blended equalizer — in tx-constant
mode (every frame carries one known packet, passed as precomputed
spectra) and in per-frame-tx mode.  ``fused_chain_plain`` is the same
function in plain PyTorch, with the same rounding points; the wrapper
``fused_chain`` runs it for CPU tensors only.  A CUDA tensor launches the
kernel or raises.

Layout is the JAX package's lane-major one: packets (1200, B), preambles
(160, B), h planes (53, B), eq (15, 53, B); the frame axis is last.
Unlike the TPU kernel, B need not be a multiple of 128: the kernel masks
the ragged tail itself.
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
from tpu80211_torch.ops import specmats
from tpu80211_torch.ops.interp import interp_matrix

INTERP_KINDS = ("linear", "cubic", "sinc", "spline", "wiener")
NB_PAD = 16  # tx-const spectra columns (15 blocks, padded as the JAX package)
OUT_NAMES = ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline",
             "h_wiener", "h_mmse")
# diagnostic planes that serving mode does not write (their keys are None)
SERVE_DROP = ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline")
EQUALIZE_WITH = ("h_linear", "h_wiener", "h_mmse")
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# kernel launches since the count was last set to 0 (the wrapper adds one
# per launch; the plain version never does)
launches = 0


class ChainConsts(NamedTuple):
    """The chain's constants on one device, all float32."""

    wre: torch.Tensor     # (64, 53) block DFT, real part
    wim: torch.Tensor     # (64, 53) imaginary part
    win_re: torch.Tensor  # (5, 53, 4) interpolators in INTERP_KINDS order
    win_im: torch.Tensor  # (5, 53, 4); nonzero for the Wiener map only


class TxConst(NamedTuple):
    """tx-constant mode: one known packet for every frame (see `tx_spectra`)."""

    txs: Cplx   # (53, 16) block spectra, columns 0..14 used
    tpre: Cplx  # (53, 1) preamble spectrum


class TxFrames(NamedTuple):
    """per-frame-tx mode: each frame's own transmit samples."""

    pkt: Cplx   # (1200, B)
    lp: Cplx    # (160, B)


@functools.lru_cache(maxsize=None)
def _consts_np(wiener_model: str | None, wiener_snr_db: float | None):
    wre, wim = specmats.block_dft()
    wstack = np.stack([
        interp_matrix(k, channel_model=wiener_model, snr_db=wiener_snr_db).T
        for k in INTERP_KINDS
    ]).astype(np.complex128)
    return wre, wim, wstack.real, wstack.imag


def chain_consts(device: torch.device | str, wiener_model: str | None = None,
                 wiener_snr_db: float | None = None) -> ChainConsts:
    """The block DFT and the interpolator stack as float32 tensors on
    ``device``; the Wiener entry carries the receiver's channel prior.

    Cached per device and prior, and shared by every caller (read-only):
    an upload per call would block the host on the previous step's kernel
    (a copy from pageable memory waits for the stream)."""
    return _chain_consts(torch.device(device), wiener_model, wiener_snr_db)


@functools.lru_cache(maxsize=None)
def _chain_consts(device: torch.device, wiener_model, wiener_snr_db) -> ChainConsts:
    return ChainConsts(*(torch.tensor(a, dtype=torch.float32, device=device)
                         for a in _consts_np(wiener_model, wiener_snr_db)))


def tx_spectra(tx_pkt: Cplx, tx_lp: Cplx) -> TxConst:
    """Precompute the tx-constant spectra from one packet (1200,) and its
    long preamble (160,): an f32 DFT, no bf16 rounding (the constants are
    read once per block of frames, so precision is free)."""
    dev = tx_pkt.re.device
    f32 = torch.float32
    wre, wim, _, _ = chain_consts(dev)
    pkt = tx_pkt.map(lambda x: x.to(f32))
    win = pkt.map(lambda x: x.view(C.N_BLOCKS, C.SAMP_PER_BLOCK)[:, C.N_CP:].T)  # (64, 15)
    br = wre.T @ win.re - wim.T @ win.im
    bi = wre.T @ win.im + wim.T @ win.re
    pad = torch.zeros((C.N_SC, NB_PAD - C.N_BLOCKS), dtype=f32, device=dev)
    lp = tx_lp.map(lambda x: x.to(f32))
    ar = (lp.re[32:96] + lp.re[96:160]) * 0.5
    ai = (lp.im[32:96] + lp.im[96:160]) * 0.5
    pr = wre.T @ ar - wim.T @ ai
    pi = wre.T @ ai + wim.T @ ar
    return TxConst(Cplx(torch.cat([br, pad], 1), torch.cat([bi, pad], 1)),
                   Cplx(pr[:, None], pi[:, None]))


def quantize_i8(x: Cplx, lsb=None) -> tuple[Cplx, torch.Tensor]:
    """Quantize split-complex samples to int8 ADC words.  ``lsb`` (the ADC
    step) defaults to maxabs/127 over the batch.  Returns (int8 planes,
    lsb as a float32 scalar tensor)."""
    re, im = x.re.to(torch.float32), x.im.to(torch.float32)
    if lsb is None:
        lsb = torch.maximum(re.abs().max(), im.abs().max()) / 127.0
    lsb = torch.as_tensor(lsb, dtype=torch.float32, device=re.device)
    q = Cplx(*(torch.clamp(torch.round(v / lsb), -127, 127).to(torch.int8)
               for v in (re, im)))
    return q, lsb


# -- validation ----------------------------------------------------------------


def _check(rx_pkt: Cplx, rx_lp: Cplx, tx: TxConst | TxFrames,
           consts: ChainConsts, equalize_with: str, sync: bool,
           evm_sums: bool) -> None:
    if sync or evm_sums:
        raise NotImplementedError(
            "the fused chain's sync (CFO/CPE) and evm_sums branches are not "
            "ported yet (ROADMAP A4)")
    if equalize_with not in EQUALIZE_WITH:
        raise ValueError(f"equalize_with must be one of {EQUALIZE_WITH}, "
                         f"got {equalize_with!r}")
    dtype, dev = rx_pkt.re.dtype, rx_pkt.re.device
    if dtype not in _STORAGE:
        raise TypeError(f"sample storage must be float32, bfloat16 or int8, got {dtype}")
    b = rx_pkt.re.shape[-1]
    if b < 1:
        raise ValueError("empty batch")

    def planes(name, c, shape, want_dtype):
        for t in c:
            if tuple(t.shape) != shape or t.dtype != want_dtype:
                raise ValueError(f"{name}: want {shape} {want_dtype}, "
                                 f"got {tuple(t.shape)} {t.dtype}")
            if t.device != dev:
                raise ValueError(f"{name} lies on {t.device}, rx on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

    planes("rx_pkt", rx_pkt, (C.PACKET_SAMPLES, b), dtype)
    planes("rx_lp", rx_lp, (C.PREAMBLE_SAMPLES, b), dtype)
    if isinstance(tx, TxConst):
        planes("txs", tx.txs, (C.N_SC, NB_PAD), torch.float32)
        planes("tpre", tx.tpre, (C.N_SC, 1), torch.float32)
    else:
        if dtype == torch.int8:
            raise TypeError("int8 ingestion is a tx-constant mode only")
        planes("tx_pkt", tx.pkt, (C.PACKET_SAMPLES, b), dtype)
        planes("tx_lp", tx.lp, (C.PREAMBLE_SAMPLES, b), dtype)
    planes("consts.w", consts[:2], (C.N_FFT, C.N_SC), torch.float32)
    planes("consts.win", consts[2:], (len(INTERP_KINDS), C.N_SC, C.N_PILOTS),
           torch.float32)


# -- the kernel and its plain version -----------------------------------------


def fused_chain(rx_pkt: Cplx, rx_lp: Cplx, tx: TxConst | TxFrames,
                consts: ChainConsts, eps: float = 0.0, lsb: float = 1.0,
                serve: bool = False, equalize_with: str = "h_linear",
                sync: bool = False, evm_sums: bool = False) -> dict:
    """Run the fused chain: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns a dict: h_* Cplx (53, B) float32
    (None for the SERVE_DROP planes when ``serve``), eq Cplx (15, 53, B) in
    the storage dtype (bfloat16 for int8), ow2/cfo/checksum (B,) float32.

    ``eps``, ``lsb``: the rx samples are scaled by (1+eps)·lsb inside the
    chain (the tx side too in per-frame-tx mode, never in tx-constant
    mode).  ``checksum`` sums, per frame, ow2 and every element of every h
    plane and of eq, before eq is cast to its storage dtype."""
    if rx_pkt.re.device.type == "cpu":
        return fused_chain_plain(rx_pkt, rx_lp, tx, consts, eps=eps, lsb=lsb, serve=serve,
                                 equalize_with=equalize_with, sync=sync, evm_sums=evm_sums)
    _check(rx_pkt, rx_lp, tx, consts, equalize_with, sync, evm_sums)
    require_cuda(rx_pkt.re)
    return _launch(rx_pkt, rx_lp, tx, consts, float(eps), float(lsb), serve,
                   equalize_with)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib = _build.load("fused_chain")
    fn = lib.fused_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_string = lib.fused_chain_error_string
    err_string.argtypes = [ctypes.c_int]
    err_string.restype = ctypes.c_char_p
    return fn, err_string


def _launch(rx_pkt: Cplx, rx_lp: Cplx, tx: TxConst | TxFrames,
            consts: ChainConsts, eps: float, lsb: float, serve: bool,
            equalize_with: str) -> dict:
    global launches
    fn, err_string = _kernel_fn()
    dev = rx_pkt.re.device
    b = rx_pkt.re.shape[-1]
    storage = rx_pkt.re.dtype
    eq_dtype = torch.bfloat16 if storage == torch.int8 else storage

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {name: None if serve and name in SERVE_DROP
           else Cplx(empty(C.N_SC, b), empty(C.N_SC, b)) for name in OUT_NAMES}
    eq = Cplx(empty(C.N_BLOCKS, C.N_SC, b, dtype=eq_dtype),
              empty(C.N_BLOCKS, C.N_SC, b, dtype=eq_dtype))
    ow2, chk = empty(b), empty(b)
    tx_a, tx_b = tx
    tensors = [*rx_pkt, *rx_lp, *tx_a, *tx_b, *consts]
    for name in OUT_NAMES:
        tensors += [None, None] if out[name] is None else list(out[name])
    tensors += [*eq, ow2, chk]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    with torch.cuda.device(dev):
        err = fn(ptrs, len(tensors), _STORAGE[storage], isinstance(tx, TxConst),
                 EQUALIZE_WITH.index(equalize_with), b, eps, lsb,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_chain kernel launch failed: CUDA error {err} "
                           f"({err_string(err).decode()})")
    launches += 1
    out.update(eq=eq, ow2=ow2, cfo=torch.zeros(b, dtype=torch.float32, device=dev),
               checksum=chk)
    return out


def fused_chain_plain(rx_pkt: Cplx, rx_lp: Cplx, tx: TxConst | TxFrames,
                      consts: ChainConsts, eps: float = 0.0, lsb: float = 1.0,
                      serve: bool = False, equalize_with: str = "h_linear",
                      sync: bool = False, evm_sums: bool = False) -> dict:
    """`fused_chain` in plain PyTorch, on any device, with the kernel's
    rounding points: with bf16 or int8 storage the DFT operands are rounded
    to bf16 (twiddles and the LTS average) and then multiplied in f32, so
    every product is exact and only the summation order differs."""
    _check(rx_pkt, rx_lp, tx, consts, equalize_with, sync, evm_sums)
    f32 = torch.float32
    dev = rx_pkt.re.device
    storage = rx_pkt.re.dtype
    eq_dtype = torch.bfloat16 if storage == torch.int8 else storage
    bf16_ops = storage != f32

    def ops(x):
        """The DFT operand rounding point (a no-op on bf16/int8 samples)."""
        x = x.to(f32)
        return x.to(torch.bfloat16).to(f32) if bf16_ops else x

    # (1+eps)·lsb in f32, as the kernel forms it
    scale = ((1.0 + torch.as_tensor(eps, dtype=f32, device=dev))
             * torch.as_tensor(lsb, dtype=f32, device=dev))
    wrT, wiT = ops(consts.wre).T, ops(consts.wim).T  # (53, 64)

    def dft(xr, xi):
        """(…, 64, B) operands → (…, 53, B) f32 spectrum."""
        return wrT @ xr - wiT @ xi, wrT @ xi + wiT @ xr

    def preamble(lp: Cplx):
        r = lp.map(lambda x: x.to(f32) * scale)
        avg = Cplx(ops((r.re[32:96] + r.re[96:160]) * 0.5),
                   ops((r.im[32:96] + r.im[96:160]) * 0.5))
        return r, dft(*avg)

    def blocks(pkt: Cplx, nblk: int):
        """Spectra of the first ``nblk`` blocks, (nblk, 53, B)."""
        win = pkt.map(lambda x: ops(
            x[:nblk * C.SAMP_PER_BLOCK].view(nblk, C.SAMP_PER_BLOCK, -1)[:, C.N_CP:]))
        yr, yi = dft(*win)
        return yr * scale, yi * scale

    lp, (rpre_r, rpre_i) = preamble(rx_lp)
    dr = lp.re[32:96] - lp.re[96:160]
    di = lp.im[32:96] - lp.im[96:160]
    ow2 = (dr * dr + di * di).sum(0) / (2.0 * C.N_FFT)
    rbr, rbi = blocks(rx_pkt, C.N_BLOCKS)
    if isinstance(tx, TxConst):
        tpr, tpi = tx.tpre
        tbr = tx.txs.re[:, :C.N_BLOCKS].T[:, :, None]   # (15, 53, 1)
        tbi = tx.txs.im[:, :C.N_BLOCKS].T[:, :, None]
    else:
        _, (tpr, tpi) = preamble(tx.lp)
        # only blocks 0..3 of the tx side feed the estimators
        tbr, tbi = blocks(tx.pkt, C.N_AVG_BLOCKS)
    dc = (torch.arange(C.N_SC, device=dev) == C.DC_IDX)[:, None]

    def cdiv(ar, ai, br, bi):
        d = br * br + bi * bi
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d

    # -- LT-LS --
    denom = torch.where(dc, 1.0, tpr * tpr + tpi * tpi)
    hlt_r = torch.where(dc, 0.0, (tpr * rpre_r + tpi * rpre_i) / denom)
    hlt_i = torch.where(dc, 0.0, (tpr * rpre_i - tpi * rpre_r) / denom)
    chk = ow2 + (hlt_r + hlt_i).sum(0)
    planes = {"h_lt": (hlt_r, hlt_i)}

    # -- pilot ratios of blocks 0..3, (4 blocks, 4 pilots, B) --
    p = list(C.PILOT_IDX)
    nb = C.N_AVG_BLOCKS
    hpr, hpi = cdiv(rbr[:nb, p], rbi[:nb, p], tbr[:nb, p], tbi[:nb, p])

    # -- interpolators: Σ_b W (53, 4) @ hp_b, / 4; the Wiener map is complex --
    for idx, kind in enumerate(INTERP_KINDS):
        wr, wi = consts.win_re[idx], consts.win_im[idx]
        acc_r = sum(wr @ hpr[b] for b in range(nb))
        acc_i = sum(wr @ hpi[b] for b in range(nb))
        if kind == "wiener":
            acc_r = acc_r - sum(wi @ hpi[b] for b in range(nb))
            acc_i = acc_i + sum(wi @ hpr[b] for b in range(nb))
        planes[f"h_{kind}"] = (acc_r / nb, acc_i / nb)
        chk = chk + (acc_r / nb + acc_i / nb).sum(0)

    # -- MMSE, rank-1 closed form --
    acc_r = torch.zeros_like(hlt_r)
    acc_i = torch.zeros_like(hlt_i)
    for b in range(nb):
        ur = tbr[b] * hlt_r - tbi[b] * hlt_i
        ui = tbr[b] * hlt_i + tbi[b] * hlt_r
        den = ow2 + (ur * ur + ui * ui).sum(0)
        sr = (ur * rbr[b] + ui * rbi[b]).sum(0) / den
        si = (ur * rbi[b] - ui * rbr[b]).sum(0) / den
        acc_r = acc_r + (hlt_r * sr - hlt_i * si)
        acc_i = acc_i + (hlt_r * si + hlt_i * sr)
    planes["h_mmse"] = (acc_r / nb, acc_i / nb)
    chk = chk + (acc_r + acc_i).sum(0) / nb

    # -- equalize: blend weights (b+1)/15 and (14−b)/15, DC to zero --
    hps_r, hps_i = planes[equalize_with]
    n = C.N_BLOCKS
    w_ps = torch.tensor([(b + 1) / n for b in range(n)], dtype=f32, device=dev)[:, None, None]
    w_lt = torch.tensor([(n - (b + 1)) / n for b in range(n)], dtype=f32, device=dev)[:, None, None]
    hur = torch.where(dc, 1.0, w_lt * hlt_r + w_ps * hps_r)
    hui = torch.where(dc, 0.0, w_lt * hlt_i + w_ps * hps_i)
    er, ei = cdiv(rbr, rbi, hur, hui)
    er = torch.where(dc, 0.0, er)
    ei = torch.where(dc, 0.0, ei)
    chk = chk + (er + ei).sum((0, 1))

    out = {name: None if serve and name in SERVE_DROP else Cplx(*planes[name])
           for name in OUT_NAMES}
    out.update(eq=Cplx(er.to(eq_dtype), ei.to(eq_dtype)), ow2=ow2,
               cfo=torch.zeros_like(ow2), checksum=chk)
    return out


# -- public entries (the JAX package's) ------------------------------------------


def fused_rx_chain_txconst(txs: Cplx, tpre: Cplx, rx_pkt: Cplx, rx_lp: Cplx,
                           eps=0.0, sync: bool = False, serve: bool = False,
                           wiener_model: str | None = None,
                           wiener_snr_db: float | None = None,
                           lsb=1.0, equalize_with: str = "h_linear") -> dict:
    """tx-constant lane-major entry: every frame carries one known packet,
    passed as precomputed spectra (`tx_spectra`).  txs (53, 16), tpre
    (53, 1), rx_pkt (1200, B), rx_lp (160, B).

    ``serve=True`` writes only the served outputs (h_wiener, h_mmse, eq,
    ow2, cfo, checksum); the diagnostic planes' keys are None, and the
    checksum still covers them.  ``lsb``: ADC step for int8 sample planes
    (`quantize_i8`); eq then comes out bfloat16."""
    consts = chain_consts(rx_pkt.re.device, wiener_model, wiener_snr_db)
    return fused_chain(rx_pkt, rx_lp, TxConst(txs, tpre), consts, eps=eps,
                       lsb=lsb, serve=serve, equalize_with=equalize_with,
                       sync=sync)


def fused_rx_chain_lane_major(tx_pkt: Cplx, rx_pkt: Cplx, tx_lp: Cplx,
                              rx_lp: Cplx, eps=0.0, sync: bool = False,
                              wiener_model: str | None = None,
                              wiener_snr_db: float | None = None) -> dict:
    """Per-frame-tx lane-major entry: packets (1200, B), preambles
    (160, B), float32 or bfloat16.  Returns h_* (53, B) Cplx, eq
    (15, 53, B) Cplx, ow2/cfo/checksum (B,)."""
    consts = chain_consts(rx_pkt.re.device, wiener_model, wiener_snr_db)
    return fused_chain(rx_pkt, rx_lp, TxFrames(tx_pkt, tx_lp), consts,
                       eps=eps, sync=sync)


def fused_rx_chain(tx_pkt: Cplx, rx_pkt: Cplx, tx_lp: Cplx, rx_lp: Cplx,
                   sync: bool = False) -> dict:
    """Batch-major entry: packets (B, 1200), preambles (B, 160).  Transposes
    at the boundary; outputs are batch-major: h_* (B, 53), eq (B, 15, 53),
    ow2/cfo/checksum (B,)."""
    def lane(x: Cplx) -> Cplx:
        return x.map(lambda t: t.T.contiguous())

    out = fused_rx_chain_lane_major(lane(tx_pkt), lane(rx_pkt), lane(tx_lp),
                                    lane(rx_lp), sync=sync)
    res = {}
    for k, v in out.items():
        if k in ("ow2", "cfo", "checksum"):
            res[k] = v
        elif k == "eq":
            res[k] = v.map(lambda t: t.permute(2, 0, 1))
        else:
            res[k] = v.map(lambda t: t.T)
    return res
