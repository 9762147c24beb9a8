#!/usr/bin/env python3
"""Drive the PyTorch port's fused receive chain once on a CUDA card.

    python3 chip_smoke.py        # from the repository root; one card, nvcc

Builds the fused-chain CUDA kernel from ``tpu80211_torch/kernels/csrc`` at
first use, then:

1. prints the card's name and power limit (nvidia-smi);
2. holds the kernel against its plain PyTorch version on the card at a
   ragged B=1000, in every mode the port has;
3. runs the main path — the tx-constant chain at B=65536 in bf16, the
   shape the JAX package's bench headlines — through the public entry,
   then again for the MMSE blend, serving mode and int8 ingestion, and
   checks the outputs against the capture's anchors and, on a 1024-frame
   slice, against the plain version;
4. times the kernel and the plain version at the main path's shape.

Every failed check raises, so the script exits non-zero.  The last two
lines are JSON: the kernel table, then the device summary.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import fused_chain as F

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

    F.launches = 0
    out = F.fused_rx_chain_txconst(*txc, pk, lp)
    out_mmse = F.fused_rx_chain_txconst(*txc, pk, lp, equalize_with="h_mmse")
    out_serve = F.fused_rx_chain_txconst(*txc, pk, lp, serve=True)
    out_i8 = F.fused_rx_chain_txconst(*txc, qp, ql, lsb=lsb)
    torch.cuda.synchronize()
    launches = F.launches
    check(launches > 0, "the main path launched no kernel")

    for tag, o in (("bf16", out), ("mmse", out_mmse), ("serve", out_serve), ("int8", out_i8)):
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
    print(f"phase 3 ok: main path B={B_MAIN} bf16 tx-constant (+ h_mmse blend, serve, int8); "
          f"{launches} kernel launches; slice of {B_SLICE} == plain, max abs err {max_abs:.3g}")
    return launches, max_abs, (pk, lp, txc)


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
    cap = load_capture()
    phase_small(cap, dev)
    launches, max_abs, main_in = phase_main(cap, dev)
    k_ms, p_ms = phase_timing(*main_in, dev)
    print(json.dumps({"kernels": [{
        "name": "fused_chain", "route": "cuda",
        "source": "tpu80211_torch/kernels/csrc/fused_chain.cu",
        "replaces": "tpu80211/kernels/fused_chain.py:93",
        "launches": launches, "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
