#!/usr/bin/env python3
"""Drive the PyTorch port's receive paths once on a CUDA card.

    python3 chip_smoke.py        # from the repository root; one card, nvcc

Builds every CUDA kernel from ``tpu80211_torch/kernels/csrc`` first (one
nvcc per source, all started together), then:

1. prints the card's name and power limit (nvidia-smi);
2. holds the fused-chain kernel against its plain PyTorch version on the
   card at a ragged B=1000, in every mode the port has;
2b. holds the other kernels against their plain versions at B=1000,
   NS=2048: detection (f32, bf16, int8; full resolution and decimated),
   alignment, placement, the chain's sync and evm_sums branches on frames
   with a 20 kHz CFO, the one-kernel raw receiver in its modes, and the
   staged receiver against it;
3. runs the chain's main path: the tx-constant chain at B=65536 in bf16,
   the shape the JAX package's bench headlines, through the public entry,
   then again for the MMSE blend, serving mode, int8 ingestion and sync,
   and checks the outputs against the capture's anchors and, on a
   1024-frame slice, against the plain version;
4. times the chain kernel and the plain version at that shape;
5. runs the raw receiver's path at bench.py's ``--raw`` size: B=32768
   streams of NS=2048 bf16 samples built on the card by the placement
   kernel, through the one-kernel receiver (decimate 16, then 32, then
   with sync on streams carrying a 20 kHz CFO) and the staged receiver,
   with bench.py's gates (every stream detected, start - offset in
   [-4, -2], finite checksum, EVM) and a 1024-stream slice against the
   plain version;
6. times the raw receiver, detection, placement and the synced chain
   against their plain versions.

Every failed check raises, so the script exits non-zero.  The last two
lines are JSON: the kernel table, then the device summary.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import _build
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.pipeline import raw as P

SEED = 0
B_SMALL = 1000      # ragged: not a multiple of the kernel's 32 frames
B_MAIN = 65536      # the production batch of the JAX package's bench
B_SLICE = 1024      # frames held against the plain version at full size
SNR_DB = 30.0
# frame 0 of the main run through the JAX kernel (fused_rx_chain_txconst,
# bf16, CPU interpret mode): h_lt at bin 0, and the median over all
# 15 x 53 entries of |eq - tx| with each equalizer blend
ANCHOR_H_LT0 = 0.009057 + 0.000910j
ANCHOR_MEDIAN = {"h_linear": 0.2870, "h_mmse": 0.1948}
NS = 2048           # raw stream length (bench.py's raw rows)
B_RAW = 32768       # raw streams per step (bench.py:261)
N_EMPTY = 40        # noise-only streams in phase 2b
NOISE = 1e-4        # AWGN per plane on the raw streams (bench.py:216)
EPS_CFO = 1e-3      # 20 kHz at 20 MS/s, in cycles/sample
KERNELS = ("fused_chain", "detect", "raw_chain")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|, in float64."""
    dt = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    g, w = got.to(dt), want.to(dt)
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def as_complex(c: Cplx) -> torch.Tensor:
    return torch.complex(c.re.to(torch.float64), c.im.to(torch.float64))


def compare(tag: str, got: dict, want: dict, h_tol: float, mmse_tol: float,
            eq_tol: float, frames: slice = slice(None)) -> float:
    """Hold every output of ``got`` against ``want`` (relative to the largest
    reference value); returns the max abs error over the h planes and eq."""
    max_abs = 0.0
    for name in (*F.OUT_NAMES, "eq"):
        if want[name] is None:
            check(got[name] is None, f"{tag}: {name} should be dropped")
            continue
        g, w = as_complex(got[name])[..., frames], as_complex(want[name])
        check(g.shape == w.shape, f"{tag}: {name} shape {tuple(g.shape)} vs {tuple(w.shape)}")
        tol = eq_tol if name == "eq" else mmse_tol if name == "h_mmse" else h_tol
        err = rel(g, w)
        check(err <= tol, f"{tag}: {name} rel err {err:.3g} > {tol}")
        max_abs = max(max_abs, float((g - w).abs().max()))
    # σ² is positive: elementwise rtol 1e-4 (f32 sums in another order)
    g, w = got["ow2"][frames].double(), want["ow2"].double()
    check(bool(((g - w).abs() <= 1e-4 * w.abs()).all()), f"{tag}: ow2")
    # the checksum sums ~2,000 signed terms per frame: 1e-4 of the batch's
    # largest checksum covers f32 summation-order noise
    err = rel(got["checksum"][frames], want["checksum"])
    check(err <= 1e-4, f"{tag}: checksum rel err {err:.3g}")
    # the CFO estimate (0 without sync): f64 correlations on both sides
    err = float((got["cfo"][frames] - want["cfo"]).abs().max())
    check(err <= 1e-6, f"{tag}: cfo abs err {err:.3g}")
    if "evm_sums" in want:
        # Σ|eq − tx|² over 795 f32 terms per frame, in another order
        g, w = got["evm_sums"][frames].double(), want["evm_sums"].double()
        err = float(((g - w).abs() / w.abs()).max())
        check(err <= 1e-4, f"{tag}: evm_sums rel err {err:.3g}")
    return max_abs


def frames_np(x: np.ndarray, phase: np.ndarray, rng, snr_db: float) -> np.ndarray:
    """(n,) → (n, B): x under one random phase per frame, plus AWGN."""
    y = x[:, None] * np.exp(1j * phase)[None, :]
    p = np.mean(np.abs(x) ** 2) / 10 ** (snr_db / 10)
    return y + np.sqrt(p / 2) * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))


def planes(x: np.ndarray, dtype: torch.dtype, dev) -> Cplx:
    return Cplx(*(torch.tensor(v, dtype=torch.float32, device=dev).to(dtype).contiguous()
                  for v in (x.real, x.imag)))


def phase_small(cap, dev) -> None:
    """Kernel vs plain on the card, B=1000, every mode."""
    rng = np.random.default_rng(SEED)
    phase = rng.uniform(0, 2 * np.pi, B_SMALL)
    rp = frames_np(cap.rx_packet, phase, rng, SNR_DB)
    rl = frames_np(cap.rx_lptot, phase, rng, SNR_DB)
    tp = cap.tx_packet[:, None] * np.exp(1j * phase)[None, :]
    tl = cap.tx_lptot[:, None] * np.exp(1j * phase)[None, :]
    txc = F.tx_spectra(planes(cap.tx_packet, torch.float32, dev),
                       planes(cap.tx_lptot, torch.float32, dev))
    consts = F.chain_consts(dev)
    # f32: the JAX tests' tolerances (tests/test_fused_chain.py:50-65);
    # bf16 and int8 round the DFT operands identically in both versions, so
    # the h planes agree to f32 summation order, and eq within a bf16 ulp
    tol = {torch.float32: (1e-5, 1e-3, 1e-4), torch.bfloat16: (1e-4, 1e-4, 1e-2)}

    def run(tag, rx_pkt, rx_lp, tx, storage, **kw):
        got = F.fused_chain(rx_pkt, rx_lp, tx, consts, **kw)
        want = F.fused_chain_plain(rx_pkt, rx_lp, tx, consts, **kw)
        compare(tag, got, want, *tol[storage])
        return got

    for dtype in (torch.float32, torch.bfloat16):
        pk, lp = planes(rp, dtype, dev), planes(rl, dtype, dev)
        full = run(f"txconst {dtype}", pk, lp, txc, dtype)
        served = run(f"txconst serve {dtype}", pk, lp, txc, dtype, serve=True)
        for k in ("h_wiener", "h_mmse", "eq"):
            check(torch.equal(full[k].re, served[k].re) and torch.equal(full[k].im, served[k].im),
                  f"serve {dtype}: {k} differs from the full run")
        for k in ("ow2", "cfo", "checksum"):
            check(torch.equal(full[k], served[k]), f"serve {dtype}: {k} differs")
        run(f"txconst eps {dtype}", pk, lp, txc, dtype, eps=0.01)
        run(f"per-frame tx {dtype}", pk, lp,
            F.TxFrames(planes(tp, dtype, dev), planes(tl, dtype, dev)), dtype)
    pk, lp = planes(rp, torch.float32, dev), planes(rl, torch.float32, dev)
    for ew in ("h_wiener", "h_mmse"):
        run(f"txconst {ew}", pk, lp, txc, torch.float32, equalize_with=ew)
    qp, lsb = F.quantize_i8(pk)
    ql, _ = F.quantize_i8(lp, lsb)
    run("txconst int8", qp, ql, txc, torch.bfloat16, lsb=float(lsb))

    # the public entries: lane-major per-frame tx, and batch-major
    tpk, tlp = planes(tp, torch.float32, dev), planes(tl, torch.float32, dev)
    want = F.fused_chain_plain(pk, lp, F.TxFrames(tpk, tlp), consts)
    compare("fused_rx_chain_lane_major", F.fused_rx_chain_lane_major(tpk, pk, tlp, lp),
            want, *tol[torch.float32])
    bm = F.fused_rx_chain(*(c.map(lambda t: t.T.contiguous()) for c in (tpk, pk, tlp, lp)))
    lane = {k: v if k in ("ow2", "cfo", "checksum") else
            v.map(lambda t: t.permute(1, 2, 0) if t.dim() == 3 else t.T) for k, v in bm.items()}
    compare("fused_rx_chain", lane, want, *tol[torch.float32])
    torch.cuda.synchronize()
    print(f"phase 2 ok: kernel == plain at B={B_SMALL} (f32, bf16, int8; serve, eps, "
          "per-frame tx, equalize_with, lane- and batch-major entries)")


def main_inputs(cap, dev):
    """B_MAIN frames on the card: frame 0 is the capture's rx frame, the
    others that frame under a random phase plus AWGN at SNR_DB."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase = torch.rand(B_MAIN, generator=gen, device=dev) * (2 * np.pi)
    rot = torch.polar(torch.ones_like(phase), phase)  # one phase per frame

    def frames(x: np.ndarray) -> torch.Tensor:
        x = torch.tensor(x, dtype=torch.complex64, device=dev)
        noise = torch.randn((x.shape[0], B_MAIN), generator=gen, device=dev,
                            dtype=torch.complex64)  # E|n|² = 1
        p = x.abs().square().mean() / 10 ** (SNR_DB / 10)
        y = x[:, None] * rot[None, :] + p.sqrt() * noise
        y[:, 0] = x
        return y

    return frames(cap.rx_packet), frames(cap.rx_lptot)


def phase_main(cap, dev):
    """The main path at full size; returns (kernel launches, max abs err,
    and its inputs: rx packet, rx preamble, tx spectra)."""
    txc = F.tx_spectra(planes(cap.tx_packet, torch.float32, dev),
                       planes(cap.tx_lptot, torch.float32, dev))
    rp, rl = main_inputs(cap, dev)
    def as_planes(z: torch.Tensor, dt: torch.dtype) -> Cplx:
        return Cplx(z.real.to(dt).contiguous(), z.imag.to(dt).contiguous())

    pk, lp = as_planes(rp, torch.bfloat16), as_planes(rl, torch.bfloat16)
    qp, lsb = F.quantize_i8(as_planes(rp, torch.float32))
    ql, _ = F.quantize_i8(as_planes(rl, torch.float32), lsb)
    del rp, rl
    torch.cuda.synchronize()

    F.launches = D.launches = D.place_launches = R.launches = 0
    out = F.fused_rx_chain_txconst(*txc, pk, lp)
    out_mmse = F.fused_rx_chain_txconst(*txc, pk, lp, equalize_with="h_mmse")
    out_serve = F.fused_rx_chain_txconst(*txc, pk, lp, serve=True)
    out_i8 = F.fused_rx_chain_txconst(*txc, qp, ql, lsb=lsb)
    out_sync = F.fused_rx_chain_txconst(*txc, pk, lp, sync=True)
    torch.cuda.synchronize()
    launches = F.launches
    check(launches > 0, "the main path launched no kernel")

    for tag, o in (("bf16", out), ("mmse", out_mmse), ("serve", out_serve), ("int8", out_i8),
                   ("sync", out_sync)):
        for k, v in o.items():
            if v is None:
                continue
            for t in (v if isinstance(v, Cplx) else (v,)):
                check(t.shape[-1] == B_MAIN, f"{tag}: {k} has batch {t.shape[-1]}")
                check(bool(torch.isfinite(t.float()).all()), f"{tag}: {k} not finite")
    check(out_i8["eq"].re.dtype == torch.bfloat16, "int8 ingestion: eq is not bf16")

    # frame 0 against the JAX kernel's anchors on the shipped capture
    h0 = complex(as_complex(out["h_lt"])[0, 0])
    check(abs(h0 - ANCHOR_H_LT0) <= 1e-3 * abs(ANCHOR_H_LT0), f"h_lt[0] = {h0}")
    tx = torch.tensor(cap.tx_symb, dtype=torch.complex128, device=dev)
    for ew, o in (("h_linear", out), ("h_mmse", out_mmse)):
        med = float((as_complex(o["eq"])[:, :, 0] - tx).abs().median())
        check(abs(med - ANCHOR_MEDIAN[ew]) <= 0.002, f"{ew}: median |eq - tx| = {med}")
        print(f"frame 0, {ew} blend: median |eq - tx| = {med:.4f} (anchor {ANCHOR_MEDIAN[ew]})")
    print(f"frame 0: h_lt[0] = {h0:.6f} (anchor {ANCHOR_H_LT0})")

    # a 1024-frame slice against the plain version (bf16 tolerances, phase 2)
    consts = F.chain_consts(dev)
    cut = lambda c: c.map(lambda t: t[:, :B_SLICE].contiguous())  # noqa: E731
    want = F.fused_chain_plain(cut(pk), cut(lp), txc, consts)
    max_abs = compare("main slice bf16", out, want, 1e-4, 1e-4, 1e-2, slice(0, B_SLICE))
    want = F.fused_chain_plain(cut(qp), cut(ql), txc, consts, lsb=lsb)
    compare("main slice int8", out_i8, want, 1e-4, 1e-4, 1e-2, slice(0, B_SLICE))
    want = F.fused_chain_plain(cut(pk), cut(lp), txc, consts, sync=True)
    compare("main slice sync", out_sync, want, 1e-4, 1e-4, 1e-2, slice(0, B_SLICE))

    # serving mode equals the full run on every served key
    for k in ("h_wiener", "h_mmse", "eq"):
        check(torch.equal(out[k].re, out_serve[k].re) and torch.equal(out[k].im, out_serve[k].im),
              f"serve: {k}")
    for k in F.SERVE_DROP:
        check(out_serve[k] is None, f"serve: {k} not dropped")
    # int8 against bf16: the 8-bit quantization floor (tests/test_fused_chain.py:185)
    for k in ("h_lt", "h_linear", "h_mmse", "h_wiener"):
        err = rel(as_complex(out_i8[k]), as_complex(out[k]))
        check(err < 0.05, f"int8 vs bf16: {k} rel err {err:.3g}")
    torch.cuda.synchronize()
    print(f"phase 3 ok: main path B={B_MAIN} bf16 tx-constant (+ h_mmse blend, serve, int8, sync); "
          f"{launches} kernel launches; slice of {B_SLICE} == plain, max abs err {max_abs:.3g}")
    return launches, max_abs, (pk, lp, txc)


def streams_np(rng, cap, b: int, n_empty: int = 0):
    """b raw streams, lane-major (NS, b) complex: the capture's frame at an
    offset in [40, NS − 1400) over NOISE of AWGN per plane (bench.py:201-229);
    the last ``n_empty`` carry noise only.  Returns (streams, offsets)."""
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    x = (rng.standard_normal((b, NS)) + 1j * rng.standard_normal((b, NS))) * NOISE
    offs = rng.integers(40, NS - 1400, b)
    for i, o in enumerate(offs[:b - n_empty]):
        x[i, o:o + frame.size] += frame
    return np.ascontiguousarray(x.T), offs


def stream_planes(xt: np.ndarray, storage: torch.dtype, dev) -> tuple[Cplx, float]:
    """(NS, B) complex → split planes on the card in ``storage``; int8 planes
    are ADC words of the batch's full scale.  Returns (planes, lsb)."""
    re, im = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (xt.real, xt.imag))
    lsb = 1.0
    if storage == torch.int8:
        lsb = max(float(re.abs().max()), float(im.abs().max())) / 127.0
        re, im = (torch.clamp(torch.round(v / lsb), -127, 127) for v in (re, im))
    return Cplx(re.to(storage).contiguous(), im.to(storage).contiguous()), lsb


def lts_planes(cap, dev) -> Cplx:
    """The matched filter's reference: the capture's transmit LTS."""
    return planes(cap.tx_lptot[-64:], torch.float32, dev)


def capture_spectra(cap, dev) -> F.TxConst:
    return F.tx_spectra(planes(cap.tx_packet, torch.float32, dev),
                        planes(cap.tx_lptot, torch.float32, dev))


def check_detection(tag: str, got: dict, want: D.Detection) -> float:
    """Indices equal, metric within 1e-5 relative (f64 sums on both sides,
    rounded to f32 once); returns the metric's max abs error."""
    for k in ("detected", "coarse", "start"):
        check(torch.equal(got[k], getattr(want, k)), f"{tag}: {k} differs from the plain version")
    err = ((got["metric"] - want.metric).abs() / want.metric.abs().clamp_min(1e-30)).max()
    check(float(err) <= 1e-5, f"{tag}: metric rel err {float(err):.3g}")
    return float((got["metric"] - want.metric).abs().max())


def check_aligned(tag: str, x: Cplx, det: dict, lp: Cplx, pkt: Cplx) -> None:
    """The aligned planes are the stream's rows from each start on, bit for bit."""
    s = torch.where(det["detected"], det["start"], 0).clamp(0, NS - 1360).long()
    rows = s[None, :] + torch.arange(1360, device=s.device)[:, None]
    for plane, a, b in ((x.re, lp.re, pkt.re), (x.im, lp.im, pkt.im)):
        check(a.dtype == plane.dtype, f"{tag}: aligned dtype {a.dtype}")
        check(torch.equal(torch.cat([a, b]), torch.gather(plane, 0, rows)),
              f"{tag}: aligned rows differ from the stream")


TOL = {torch.float32: (1e-5, 1e-3, 1e-4), torch.bfloat16: (1e-4, 1e-4, 1e-2),
       torch.int8: (1e-4, 1e-4, 1e-2)}


def phase_small_raw(cap, dev) -> dict:
    """2b: detection, alignment, placement, the chain's sync and evm_sums,
    and the raw receivers against their plain versions at B=1000; returns
    the max abs errors of detection (metric) and placement."""
    rng = np.random.default_rng(SEED + 1)
    xt, _ = streams_np(rng, cap, B_SMALL, N_EMPTY)
    lts = lts_planes(cap, dev)
    errs = {"detect": 0.0, "place": 0.0}
    for storage in (torch.float32, torch.bfloat16, torch.int8):
        x, _ = stream_planes(xt, storage, dev)
        for dec in (False, 16, 32, 64):
            got = D.detect_streams(x, lts, decimate=dec)
            errs["detect"] = max(errs["detect"], check_detection(
                f"detect {storage} decimate={dec}", got, D.detect_plain(x, lts, decimate=dec)))
            live = got["detected"]
            check(bool(live[:B_SMALL - N_EMPTY].all()) and not bool(live[B_SMALL - N_EMPTY:].any()),
                  f"detect {storage} decimate={dec}: detection pattern")
        check_aligned(f"align {storage}", x, *D.detect_and_align(x, lts))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for storage in (torch.float32, torch.bfloat16):
        sig = Cplx(*(torch.randn(NS, B_SMALL, generator=gen, device=dev).to(storage)
                     for _ in range(2)))
        noise = Cplx(*(NOISE * torch.randn(NS, B_SMALL, generator=gen, device=dev)
                       for _ in range(2)))
        offs = torch.randint(0, NS, (B_SMALL,), generator=gen, device=dev, dtype=torch.int32)
        got, want = D.place_streams(sig, noise, offs), D.place_plain(sig, noise, offs)
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"place {storage}: differs from the plain version")
            errs["place"] = max(errs["place"], float((g.float() - w.float()).abs().max()))

    # the chain's sync and evm_sums branches, on frames with a real CFO
    # (continuous from the preamble at t = 0 into the packet at t = 160)
    rng = np.random.default_rng(SEED + 2)
    phase = rng.uniform(0, 2 * np.pi, B_SMALL)
    rp = frames_np(cap.rx_packet, phase, rng, SNR_DB) * np.exp(
        2j * np.pi * EPS_CFO * (160 + np.arange(1200)))[:, None]
    rl = frames_np(cap.rx_lptot, phase, rng, SNR_DB) * np.exp(
        2j * np.pi * EPS_CFO * np.arange(160))[:, None]
    tp = cap.tx_packet[:, None] * np.exp(1j * phase)[None, :]
    tl = cap.tx_lptot[:, None] * np.exp(1j * phase)[None, :]
    txc, consts = capture_spectra(cap, dev), F.chain_consts(dev)
    for dtype in (torch.float32, torch.bfloat16):
        pk, lp = planes(rp, dtype, dev), planes(rl, dtype, dev)
        txf = F.TxFrames(planes(tp, dtype, dev), planes(tl, dtype, dev))
        for mode, tx in (("txconst", txc), ("per-frame tx", txf)):
            for kw in (dict(sync=True), dict(evm_sums=True),
                       dict(sync=True, evm_sums=True, equalize_with="h_mmse")):
                tag = f"chain {mode} {dtype} {kw}"
                got = F.fused_chain(pk, lp, tx, consts, **kw)
                compare(tag, got, F.fused_chain_plain(pk, lp, tx, consts, **kw), *TOL[dtype])
                if kw.get("sync"):
                    med = float(got["cfo"].median())
                    check(abs(med - EPS_CFO) <= 2e-2 * EPS_CFO, f"{tag}: median cfo {med}")

    # the one-kernel raw receiver in its modes, and the staged one against it
    xt_cfo = xt * np.exp(2j * np.pi * EPS_CFO * np.arange(NS))[:, None]
    cases = [(torch.float32, {}),
             (torch.bfloat16, dict(stream_sums=True, equalize_with="h_mmse")),
             (torch.bfloat16, dict(decimate=32, serve=True)),
             (torch.int8, dict(stream_sums=True, equalize_with="h_mmse", decimate=32)),
             (torch.bfloat16, dict(sync=True, stream_sums=True, equalize_with="h_mmse")),
             (torch.float32, dict(sync=True, decimate=32, equalize_with="h_wiener")),
             (torch.int8, dict(sync=True, serve=True))]
    for storage, kw in cases:
        x, lsb = stream_planes(xt_cfo if kw.get("sync") else xt, storage, dev)
        tag = f"raw {storage} {kw}"
        got = R.raw_rx_txconst_fused(x, lts, *txc, lsb=lsb, **kw)
        want = R.raw_chain_plain(x, lts, *txc, lsb=lsb, **kw)
        for k in ("detected", "start"):
            check(torch.equal(got[k], want[k]), f"{tag}: {k} differs from the plain version")
        compare(tag, got, want, *TOL[storage])
    x, _ = stream_planes(xt, torch.bfloat16, dev)
    staged = P.raw_rx_txconst(x, lts, *txc)
    fused = R.raw_rx_txconst_fused(x, lts, *txc, decimate=False)
    check(torch.equal(staged["start"], fused["start"]), "staged vs fused: start differs")
    compare("staged vs fused", staged, fused, *TOL[torch.bfloat16])
    torch.cuda.synchronize()
    print(f"phase 2b ok: detection (f32, bf16, int8; full, decimate 16/32/64), alignment, "
          f"placement, chain sync/evm_sums, raw receiver ({len(cases)} modes), staged == fused "
          f"at B={B_SMALL}, NS={NS}")
    return errs


def raw_workload(cap, dev):
    """The --raw workload's pieces on the card: the capture's frame in the
    first 1360 rows of every stream (bf16), AWGN of NOISE per plane, and
    offsets in [40, NS − 1400) from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    sig = Cplx(torch.zeros((NS, B_RAW), dtype=torch.bfloat16, device=dev),
               torch.zeros((NS, B_RAW), dtype=torch.bfloat16, device=dev))
    for plane, part in zip(sig, (frame.real, frame.imag)):
        plane[:frame.size] = torch.tensor(part, dtype=torch.float32, device=dev)[:, None]
    noise = Cplx(*(NOISE * torch.randn((NS, B_RAW), generator=gen, device=dev) for _ in range(2)))
    offs = torch.randint(40, NS - 1400, (B_RAW,), generator=gen, device=dev, dtype=torch.int32)
    return sig, noise, offs


def with_stream_cfo(x: Cplx, eps: float) -> Cplx:
    """x[r] · exp(2πi·eps·r) on every stream, in f32, back to x's dtype."""
    ang = 2 * np.pi * eps * torch.arange(NS, dtype=torch.float64, device=x.re.device)
    c, s = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    re, im = x.re.float(), x.im.float()
    return Cplx((re * c - im * s).to(x.re.dtype), (re * s + im * c).to(x.re.dtype))


def raw_gates(tag: str, out: dict, offs: torch.Tensor, evm_den: float, evm_max: float) -> float:
    """bench.py:284-293's gates; returns the EVM."""
    check(bool(out["detected"].all()), f"{tag}: missed {int((~out['detected']).sum())} streams")
    err = out["start"].long() - offs.long()
    lo, hi = int(err.min()), int(err.max())
    check(-4 <= lo and hi <= -2, f"{tag}: start - offset in [{lo}, {hi}]")
    check(bool(torch.isfinite(out["checksum"]).all()), f"{tag}: checksum not finite")
    evm = float(torch.sqrt(out["evm_sums"].double().sum() / (out["evm_sums"].numel() * evm_den)))
    check(evm < evm_max, f"{tag}: evm_rms {evm:.4f} >= {evm_max}")
    return evm


def phase_raw(cap, dev):
    """5: the raw receiver's path at the --raw size; returns (launches by
    kernel, max abs errors by kernel, inputs for phase 6)."""
    lts, txc = lts_planes(cap, dev), capture_spectra(cap, dev)
    evm_den = float((txc.txs.re[:, :15].double() ** 2 + txc.txs.im[:, :15].double() ** 2).sum())
    sig, noise, offs = raw_workload(cap, dev)
    kw = dict(stream_sums=True, equalize_with="h_mmse")
    torch.cuda.synchronize()

    F.launches = D.launches = D.place_launches = R.launches = 0
    x = D.place_streams(sig, noise, offs)
    out16 = R.raw_rx_txconst_fused(x, lts, *txc, decimate=16, **kw)
    out32 = R.raw_rx_txconst_fused(x, lts, *txc, decimate=32, **kw)
    xc = with_stream_cfo(x, EPS_CFO)
    out_sync = R.raw_rx_txconst_fused(xc, lts, *txc, decimate=16, sync=True, **kw)
    out_nosync = R.raw_rx_txconst_fused(xc, lts, *txc, decimate=16, **kw)
    staged = P.raw_rx_txconst(x, lts, *txc, equalize_with="h_mmse")
    torch.cuda.synchronize()
    launches = {"fused_chain": F.launches, "detect": D.launches, "place": D.place_launches,
                "raw_chain": R.launches}
    for k, n in launches.items():
        check(n > 0, f"the raw path launched no {k} kernel")

    evm = {tag: raw_gates(tag, out, offs, evm_den, 0.1)
           for tag, out in (("raw decimate=16", out16), ("raw decimate=32", out32))}
    med = float(out_sync["cfo"].median())
    check(abs(med - EPS_CFO) <= 2e-2 * EPS_CFO, f"raw sync: median cfo {med} vs {EPS_CFO}")
    evm["sync"] = raw_gates("raw 20 kHz CFO, sync", out_sync, offs, evm_den, 0.15)
    evm_nosync = float(torch.sqrt(out_nosync["evm_sums"].double().sum() / (B_RAW * evm_den)))
    check(torch.equal(staged["start"], out16["start"]), "staged start differs from the fused one")
    for k in ("h_mmse", "h_wiener"):
        err = rel(as_complex(staged[k]), as_complex(R.raw_rx_txconst_fused(
            x, lts, *txc, decimate=False, equalize_with="h_mmse")[k]))
        check(err <= 1e-4, f"staged vs fused {k}: rel err {err:.3g}")

    # a 1024-stream slice against the plain version (bf16 tolerances, 2b)
    errs = {}
    cut = x.map(lambda t: t[:, :B_SLICE].contiguous())
    want = R.raw_chain_plain(cut, lts, *txc, decimate=16, **kw)
    check(torch.equal(out16["start"][:B_SLICE], want["start"]), "raw slice: start differs")
    errs["raw_chain"] = compare("raw slice bf16", out16, want, *TOL[torch.bfloat16],
                                slice(0, B_SLICE))
    # detection and placement against their plain versions at full size
    want_det = D.detect_plain(x, lts)
    check(torch.equal(staged["start"], want_det.start), "staged start differs from plain detection")
    errs["detect"] = float((staged["metric"] - want_det.metric).abs().max())
    want_x = D.place_plain(sig, noise, offs)
    check(torch.equal(x.re, want_x.re) and torch.equal(x.im, want_x.im), "place differs from plain")
    errs["place"] = 0.0
    torch.cuda.synchronize()
    print(f"phase 5 ok: raw receiver B={B_RAW} x NS={NS} bf16, every stream detected, "
          f"start - offset in [-4, -2]; evm_rms {evm['raw decimate=16']:.4f} (decimate 16), "
          f"{evm['raw decimate=32']:.4f} (32); 20 kHz CFO: median cfo {med:.6g} "
          f"({med * 20e6:.1f} Hz), evm_rms {evm['sync']:.4f} with sync, {evm_nosync:.4f} without; "
          f"launches {launches}")
    return launches, errs, (x, lts, txc, sig, noise, offs)


def in_turns(kernel, plain) -> tuple[float, float]:
    """plain, kernel, kernel, plain: (kernel ms, plain ms), medians."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return statistics.median([k1, k2]), statistics.median([p1, p2])


def phase_raw_timing(raw_in, main_in, dev) -> dict:
    """6: the raw receiver, detection, placement and the synced chain
    against their plain versions, in turns."""
    x, lts, txc, sig, noise, offs = raw_in
    kw = dict(stream_sums=True, equalize_with="h_mmse")
    t = {}
    for dec in (16, 32):
        t[f"raw_chain{dec}"] = in_turns(
            lambda: R.raw_rx_txconst_fused(x, lts, *txc, decimate=dec, **kw),
            lambda: R.raw_chain_plain(x, lts, *txc, decimate=dec, **kw))
    t["detect"] = in_turns(lambda: D.detect_streams(x, lts, decimate=16),
                           lambda: D.detect_plain(x, lts, decimate=16))
    t["place"] = in_turns(lambda: D.place_streams(sig, noise, offs),
                          lambda: D.place_plain(sig, noise, offs))
    consts = F.chain_consts(dev)
    _, lp, pkt = D.detect_and_align(x, lts)
    chain_aligned = time_ms(lambda: F.fused_chain(pkt, lp, txc, consts, equalize_with="h_mmse",
                                                  evm_sums=True))
    pk, lpm, txm = main_in
    t["chain_sync"] = in_turns(lambda: F.fused_chain(pk, lpm, txm, consts, sync=True),
                               lambda: F.fused_chain_plain(pk, lpm, txm, consts, sync=True))
    torch.cuda.synchronize()
    for name, n, unit in (("raw_chain16", B_RAW, "streams"), ("raw_chain32", B_RAW, "streams"),
                          ("detect", B_RAW, "streams"), ("place", B_RAW, "streams"),
                          ("chain_sync", B_MAIN, "frames")):
        k_ms, p_ms = t[name]
        print(f"phase 6: {name}: kernel {k_ms:.4f} ms = {n / k_ms * 1e3:.4g} {unit}/s; "
              f"plain {p_ms:.4f} ms = {n / p_ms * 1e3:.4g} {unit}/s")
    print(f"phase 6: the chain kernel alone on the aligned frames (B={B_RAW}, evm_sums, h_mmse): "
          f"{chain_aligned:.4f} ms")
    return t


def time_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Steady-state ms per call: CUDA events around ``calls`` back-to-back
    calls (the queue stays full, as in a stream of steps), median of
    ``reps`` such runs after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_timing(pk: Cplx, lp: Cplx, txc, dev) -> tuple[float, float]:
    """Kernel and plain version on the main path's inputs, in turns."""
    consts = F.chain_consts(dev)
    kernel = lambda: F.fused_chain(pk, lp, txc, consts)  # noqa: E731
    plain = lambda: F.fused_chain_plain(pk, lp, txc, consts)  # noqa: E731
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    k_ms, p_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
    torch.cuda.synchronize()
    print(f"phase 4: B={B_MAIN} bf16 tx-constant: kernel {k_ms:.4f} ms ({k1:.4f}, {k2:.4f}) "
          f"= {B_MAIN / k_ms * 1e3:.4g} frames/s; plain {p_ms:.4f} ms ({p1:.4f}, {p2:.4f}) "
          f"= {B_MAIN / p_ms * 1e3:.4g} frames/s")
    return k_ms, p_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all([_build.CSRC / f"{name}.cu" for name in KERNELS])
    print(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    cap = load_capture()
    phase_small(cap, dev)
    small_errs = phase_small_raw(cap, dev)
    launches, max_abs, main_in = phase_main(cap, dev)
    k_ms, p_ms = phase_timing(*main_in, dev)
    raw_launches, raw_errs, raw_in = phase_raw(cap, dev)
    t = phase_raw_timing(raw_in, main_in, dev)
    src = "tpu80211_torch/kernels/csrc/"
    rows = [
        ("fused_chain", "fused_chain.cu", "tpu80211/kernels/fused_chain.py:93", launches,
         max_abs, (k_ms, p_ms)),
        ("detect", "detect.cu", "tpu80211/kernels/detect_kernel.py:267", raw_launches["detect"],
         max(small_errs["detect"], raw_errs["detect"]), t["detect"]),
        ("place", "detect.cu", "tpu80211/kernels/detect_kernel.py:446", raw_launches["place"],
         max(small_errs["place"], raw_errs["place"]), t["place"]),
        ("raw_chain", "raw_chain.cu", "tpu80211/kernels/raw_chain.py:41",
         raw_launches["raw_chain"], raw_errs["raw_chain"], t["raw_chain16"]),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    } for name, source, replaces, n, err, (ms, plain_ms) in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
