"""The plain reference of the receive chain, in plain PyTorch.

A frozen copy of the semantics of the port's plain chain, written apart
from it: it imports nothing of the program, and works out again everything
the program's set-up derives (the block DFT, the four pilot interpolators
and the Wiener one under the deployment's channel prior, the transmit
spectra, the LTS).  For one batch of aligned frames it gives the noise
power σ² (``ow2``), the Moose CFO estimate (``cfo``, cycles per sample), the
LT-LS estimate, the five pilot interpolations, the rank-1 MMSE, and the
equalized blocks (``eq``) after the per-block pilot CPE, as the upstream
receiver (WiFi_RX.m) computes them:

* the preamble spectrum is the DFT of the mean of the two LTS repeats,
  σ² = Σ|r1 − r2|²/(2·64);
* each block is derotated by the CFO before its DFT (``sync``);
* the pilot estimators average blocks 0..3; the MMSE is the rank-1 closed
  form per block, averaged;
* eq divides each block by the blend ((14 − b)·h_lt + (b + 1)·h_ps)/15, DC
  to 0, then turns each block by its pilots' common phase.

Precision: the configuration stores samples in bfloat16 and multiplies the
DFT operands on the tensor cores in bfloat16, so the DFT operands (the
twiddles, the averaged LTS, each derotated block) are rounded to bfloat16
and multiplied in float32, every product exact; everything else is float32,
the CFO correlation float64.  TF32 is off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_SC = 53
N_BLOCKS = 15
N_FFT = 64
N_CP = 16
SAMP = N_FFT + N_CP
PREAMBLE = 160
PACKET = N_BLOCKS * SAMP
FFT_SHIFT = 26
PILOTS = (5, 19, 33, 47)
DC = 26
N_AVG = 4
INTERP = ("linear", "cubic", "sinc", "spline", "wiener")
H_NAMES = ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline", "h_wiener", "h_mmse")
TWO_PI = 2.0 * math.pi


def no_tf32() -> None:
    """Full float32 products: the reference states and sets both flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the constants, worked out again ----------------------------------------------------


def block_dft() -> tuple[np.ndarray, np.ndarray]:
    """(64, 53): out[k] = Σ_n x[n]·exp(−2πi·n·(k − 26)/64), the FFT, the
    fftshift by 26 and the cut to 53 bins in one matrix."""
    n = np.arange(N_FFT)[:, None]
    k = np.arange(N_SC)[None, :] - FFT_SHIFT
    w = np.exp(-2j * np.pi * n * k / N_FFT)
    return w.real, w.imag


def _linear() -> np.ndarray:
    kk = np.arange(N_SC, dtype=np.float64)
    p = np.asarray(PILOTS, np.float64)
    w = np.zeros((4, N_SC))
    seg = np.clip((kk[None, :] >= p[:3, None]).sum(0) - 1, 0, 2)
    alpha = (kk - p[seg]) / 14.0
    for k in range(N_SC):
        w[seg[k], k] += 1.0 - alpha[k]
        w[seg[k] + 1, k] += alpha[k]
    return w


def _cubic() -> np.ndarray:
    """Newton divided differences, denominators 14, 14, 14, 28, 28, 42
    (the MATLAB PS-Cubic; csapi's not-a-knot spline through 4 knots is the
    same cubic)."""
    kk = np.arange(N_SC, dtype=np.float64)
    p = np.asarray(PILOTS, np.float64)
    e = np.eye(4)
    f01, f12, f23 = (e[1] - e[0]) / 14, (e[2] - e[1]) / 14, (e[3] - e[2]) / 14
    f012, f123 = (f12 - f01) / 28, (f23 - f12) / 28
    m = np.stack([e[0], f01, f012, (f123 - f012) / 42])
    x1, x2, x3 = kk - p[0], kk - p[1], kk - p[2]
    v = np.stack([np.ones_like(kk), x1, x1 * x2, x1 * x2 * x3], axis=1)
    return (v @ m).T


def _sinc() -> np.ndarray:
    kk = np.arange(N_SC, dtype=np.float64)
    return np.sinc((kk[None, :] - np.asarray(PILOTS, np.float64)[:, None]) / 14.0)


def _wiener(pdp: np.ndarray, snr_db: float) -> np.ndarray:
    """W = (R_pp + σ²I)⁻ᵀ R_kpᵀ, r(m) = Σ_l p_l·exp(−2πi·m·l/64)."""
    p = np.asarray(pdp, np.float64)
    p = p / p.sum()
    kk = np.arange(N_SC, dtype=np.float64)
    pp = np.asarray(PILOTS, np.float64)

    def r(m):
        m = np.asarray(m, np.float64)[..., None]
        return (p * np.exp(-2j * np.pi * m * np.arange(len(p)) / N_FFT)).sum(-1)

    r_pp = r(pp[:, None] - pp[None, :])
    r_kp = r(kk[:, None] - pp[None, :])
    return np.linalg.solve((r_pp + 10.0 ** (-snr_db / 10.0) * np.eye(4)).T, r_kp.T)


def wiener_prior(rms_samples: float, snr_db: float) -> np.ndarray:
    """The receiver's Wiener map for a channel model: an exponential
    profile of ``rms_samples`` over ceil(5·rms) + 1 taps, held to [8, 16]."""
    n = int(np.clip(int(np.ceil(5.0 * rms_samples)) + 1, 8, 16))
    return _wiener(np.exp(-np.arange(n) / rms_samples), snr_db)


class Consts:
    """The chain's constants on one device, float32."""

    def __init__(self, device, wiener: np.ndarray):
        wre, wim = block_dft()
        mats = [_linear(), _cubic(), _sinc(), _cubic(), wiener]
        stack = np.stack([np.asarray(m, np.complex128).T for m in mats])   # (5, 53, 4)
        f32 = torch.float32
        self.wre = torch.tensor(wre, dtype=f32, device=device)
        self.wim = torch.tensor(wim, dtype=f32, device=device)
        self.win_re = torch.tensor(stack.real, dtype=f32, device=device)
        self.win_im = torch.tensor(stack.imag, dtype=f32, device=device)


def tx_spectra(consts: Consts, tx_lp: np.ndarray, tx_pkt: np.ndarray):
    """((53, 15) block spectra, (53, 1) preamble spectrum) of the transmit
    frame, each as (re, im) float32, from a float32 DFT."""
    dev = consts.wre.device
    f32 = torch.float32
    pkt = torch.tensor(np.asarray(tx_pkt, np.complex64), device=dev)
    win = pkt.view(N_BLOCKS, SAMP)[:, N_CP:].T                      # (64, 15)
    wr, wi = consts.wre.T, consts.wim.T
    br = wr @ win.real.to(f32) - wi @ win.imag.to(f32)
    bi = wr @ win.imag.to(f32) + wi @ win.real.to(f32)
    lp = torch.tensor(np.asarray(tx_lp, np.complex64), device=dev)
    ar = (lp.real[32:96] + lp.real[96:160]) * 0.5
    ai = (lp.imag[32:96] + lp.imag[96:160]) * 0.5
    return (br, bi), ((wr @ ar - wi @ ai)[:, None], (wr @ ai + wi @ ar)[:, None])


# -- the chain -----------------------------------------------------------------------------


def _derotate(xr, xi, cfo, t):
    """(…, B) planes times exp(−2πi·cfo·t): the angle in float32, its cos and
    sin correctly rounded to float32."""
    ang = (((-TWO_PI) * cfo) * t).to(torch.float64)
    c, s = torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)
    return xr * c - xi * s, xr * s + xi * c


def chain(pkt, lp, tx, consts: Consts, sync: bool, equalize_with: str) -> dict:
    """The receive chain on one batch of aligned frames.

    ``pkt`` (re, im) (1200, B), ``lp`` (re, im) (160, B), in their storage
    type (bfloat16 here); ``tx``: `tx_spectra`.  Returns every h plane
    (re, im) (53, B) float32, eq (re, im) (15, 53, B) in the storage type,
    ow2 and cfo (B,) float32."""
    f32, f64 = torch.float32, torch.float64
    dev = pkt[0].device
    storage = pkt[0].dtype
    bf16_ops = storage != f32

    def ops(x):
        x = x.to(f32)
        return x.to(torch.bfloat16).to(f32) if bf16_ops else x

    def plane(w):
        w = ops(w) if bf16_ops else w
        return torch.cat([w.T, w.new_zeros(N_FFT - N_SC, N_FFT)])

    wr, wi = plane(consts.wre), plane(consts.wim)

    def dft(xr, xi):
        yr = wr @ xr - wi @ xi
        yi = wr @ xi + wi @ xr
        return yr[..., :N_SC, :], yi[..., :N_SC, :]

    lr, li = lp[0].to(f32), lp[1].to(f32)
    cfo = None
    if sync:
        r1r, r1i, r2r, r2i = (v.to(f64) for v in (lr[32:96], li[32:96], lr[96:160], li[96:160]))
        cr = (r1r * r2r + r1i * r2i).sum(0)
        ci = (r1r * r2i - r1i * r2r).sum(0)
        cfo = (torch.atan2(ci, cr) / (TWO_PI * N_FFT)).to(f32)
        lr, li = _derotate(lr, li, cfo, torch.arange(PREAMBLE, dtype=f32, device=dev)[:, None])
    rpre_r, rpre_i = dft(ops((lr[32:96] + lr[96:160]) * 0.5), ops((li[32:96] + li[96:160]) * 0.5))
    dr, di = lr[32:96] - lr[96:160], li[32:96] - li[96:160]
    ow2 = (dr * dr + di * di).sum(0) / (2.0 * N_FFT)

    def win(x):
        return x.view(N_BLOCKS, SAMP, -1)[:, N_CP:].to(f32)

    br, bi = win(pkt[0]), win(pkt[1])
    if sync:
        t = (PREAMBLE + N_CP + SAMP * torch.arange(N_BLOCKS, dtype=f32, device=dev)[:, None, None]
             + torch.arange(N_FFT, dtype=f32, device=dev)[None, :, None])
        br, bi = _derotate(br, bi, cfo, t)
    rbr, rbi = dft(ops(br), ops(bi))                                   # (15, 53, B)

    (txr, txi), (tpr, tpi) = tx
    tbr, tbi = txr.T[:, :, None], txi.T[:, :, None]                   # (15, 53, 1)
    dc = (torch.arange(N_SC, device=dev) == DC)[:, None]

    def cdiv(ar, ai, cr_, ci_):
        d = cr_ * cr_ + ci_ * ci_
        return (ar * cr_ + ai * ci_) / d, (ai * cr_ - ar * ci_) / d

    den = torch.where(dc, 1.0, tpr * tpr + tpi * tpi)
    hlt_r = torch.where(dc, 0.0, (tpr * rpre_r + tpi * rpre_i) / den)
    hlt_i = torch.where(dc, 0.0, (tpr * rpre_i - tpi * rpre_r) / den)
    h = {"h_lt": (hlt_r, hlt_i)}

    p = list(PILOTS)
    hpr, hpi = cdiv(rbr[:N_AVG, p], rbi[:N_AVG, p], tbr[:N_AVG, p], tbi[:N_AVG, p])
    for idx, kind in enumerate(INTERP):
        mr, mi = consts.win_re[idx], consts.win_im[idx]
        acc_r = sum(mr @ hpr[b] for b in range(N_AVG))
        acc_i = sum(mr @ hpi[b] for b in range(N_AVG))
        if kind == "wiener":
            acc_r = acc_r - sum(mi @ hpi[b] for b in range(N_AVG))
            acc_i = acc_i + sum(mi @ hpr[b] for b in range(N_AVG))
        h[f"h_{kind}"] = (acc_r / N_AVG, acc_i / N_AVG)

    acc_r = torch.zeros_like(hlt_r)
    acc_i = torch.zeros_like(hlt_i)
    for b in range(N_AVG):
        ur = tbr[b] * hlt_r - tbi[b] * hlt_i
        ui = tbr[b] * hlt_i + tbi[b] * hlt_r
        d = ow2 + (ur * ur + ui * ui).sum(0)
        sr = (ur * rbr[b] + ui * rbi[b]).sum(0) / d
        si = (ur * rbi[b] - ui * rbr[b]).sum(0) / d
        acc_r = acc_r + (hlt_r * sr - hlt_i * si)
        acc_i = acc_i + (hlt_r * si + hlt_i * sr)
    h["h_mmse"] = (acc_r / N_AVG, acc_i / N_AVG)

    hps_r, hps_i = h[equalize_with]
    w_ps = torch.tensor([(b + 1) / N_BLOCKS for b in range(N_BLOCKS)], dtype=f32,
                        device=dev)[:, None, None]
    w_lt = torch.tensor([(N_BLOCKS - (b + 1)) / N_BLOCKS for b in range(N_BLOCKS)], dtype=f32,
                        device=dev)[:, None, None]
    hur = torch.where(dc, 1.0, w_lt * hlt_r + w_ps * hps_r)
    hui = torch.where(dc, 0.0, w_lt * hlt_i + w_ps * hps_i)
    er, ei = cdiv(rbr, rbi, hur, hui)
    er, ei = torch.where(dc, 0.0, er), torch.where(dc, 0.0, ei)
    if sync:
        gr = gi = 0.0
        for q in p:
            zr, zi, xr, xi = er[:, q], ei[:, q], tbr[:, q], tbi[:, q]
            gr = gr + (zr * xr + zi * xi)
            gi = gi + (zi * xr - zr * xi)
        mag = torch.sqrt(gr * gr + gi * gi)
        mag = torch.where(mag == 0.0, 1.0, mag)
        rr, ri = (gr / mag)[:, None], (-gi / mag)[:, None]
        er, ei = er * rr - ei * ri, er * ri + ei * rr
    eq_dtype = torch.bfloat16 if storage == torch.int8 else storage
    out = dict(h)
    out.update(eq=(er.to(eq_dtype), ei.to(eq_dtype)), ow2=ow2,
               cfo=torch.zeros_like(ow2) if cfo is None else cfo)
    return out
