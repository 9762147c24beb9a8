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
4. times the chain kernel and the plain version at that shape (and per-frame
   tx at B=32768), with their bounds and the kernel's occupancy;
5. runs the raw receiver's path at bench.py's ``--raw`` size: B=32768
   streams of NS=2048 bf16 samples built on the card by the placement
   kernel, through the one-kernel receiver (decimate 16, then 32, then
   with sync on streams carrying a 20 kHz CFO) and the staged receiver,
   with bench.py's gates (every stream detected, start - offset in
   [-4, -2], finite checksum, EVM) and a 1024-stream slice against the
   plain version;
6. times the raw receiver, detection, placement and the synced chain
   against their plain versions, and prints the registers, spills, shared
   bytes and blocks per SM of the placement kernel (and its strip width),
   of the detection kernel and of the raw receiver's kernel;
2c. (run after 2b) holds the generative kernels against their plain
   versions at B=1024: ``fused_gen_chain`` in full and stream mode
   (channel models None and 'A', SNR 20 and 35; the stream record against
   the full run), ``gen_raw_system`` with and without a 40 kHz CFO;
7. runs the generative path at full width, B=32768 (scripts/bench_stream.py
   and bench.py --genraw): ``fused_gen_chain`` in stream mode (SNR 20) and
   in full (SNR 35, NMSE and sigma^2 gates, its first 1024 frames against
   the plain version at B=1024), ``gen_raw_system`` x NS=2048 (bench.py's
   gates; a 40 kHz CFO recovered), and ``run_stream_device`` for 4 batches
   with each of the four generators, plus a bit-identical resume;
8. times ``fused_gen_chain``, ``gen_raw_system`` and one stream step per
   generator, kernel and plain version in turns, each kernel beside its
   bound; the raw receiver alone on ``gen_raw_system``'s own field (what is
   left is the synthesis); and both generative kernels' registers, spills,
   shared bytes and blocks per SM;
2d. (run after 2c) holds the dense MMSE solve kernels against their plain
   versions at a ragged B=1000 systems of bench.py's dense-solve workload
   (sigma^2 = 0.37, normal u and rx): ``fused_rank1_solve`` and
   ``solve_batched``, ``gauss`` and ``chol``, z within 1e-4, seven spot
   systems within 5e-5 of numpy's f64 solve (bench.py:179-183);
9. runs the dense MMSE path at full width: bench.py's B=8192 systems through
   ``fused_rank1_solve`` (both methods, the gates of 2d), then the main
   path's B=65536 frames (262144 systems) through ``sc.ps_mmse_dense``
   (the fused kernel) and ``pipeline/rx.py::rx_chain_freq`` with
   ``mmse_solver="dense_pallas"`` (the dense kernel): h_mmse within 5e-2 of
   ``sc.ps_mmse_sm`` (tests/test_kernels.py:232-235), and a 1024-frame slice
   against the plain version;
10. prints, for each solve kernel's four instantiations, its registers,
   spill bytes, shared bytes and resident systems per SM, and the
   multiply-adds and shared loads its factorization issues per system; then
   times both entries x both methods at 8192 and 262144 systems, kernel and
   plain version in turns, and ``torch.linalg.solve`` on the same
   materialized complex64 systems (the library yardstick);
11. runs every default row of ``python -m tpu80211_torch.bench.throughput``
   (the tx-constant, per-frame, serving and int8 chain rows, raw, raw32,
   genraw, dense) at its full shape with a loop length of 8: each row's
   gates, both fences on the host clock and on CUDA events, each row printed
   on its own line;
12. runs ``pipeline.stream.run_stream`` (``sc.rx_chain_freq`` on the card)
   over ``synthetic_batches(engine="native")``, B=32768, 3 batches: shards
   written, batch 0's first 1024 frames against the CPU, a resume;
13. runs ``native_time_batches`` into ``fused_rx_chain`` (per-frame tx) at
   B=32768, a 1024-frame slice against the plain version;
14. runs the multi-device layer (``tpu80211_torch/parallel``): (a) a world
   of one on NCCL in this process: ``rx_step_shardmap`` "sm" at B=65536 on
   phase 3's frames against ``sc.rx_chain_freq``, "dense" (#8) at B=16384
   (sigma^2 = 0.25) against "sm", both within 1e-4 (tests/test_mesh.py),
   and the mesh ``kernel`` (#6) and ``kernel_raw`` (#7) stream steps at
   B=32768 bit-equal to the steps without a mesh, each step timed beside
   its single-process counterpart; (b) two ranks on the one card over gloo
   (``parallel/launch.py``): the shard-map steps over dp=2 and dp=1 x blk=2,
   "sm" and "dense", within 1e-4 of the world of one, the mesh stream steps
   equal to the pool of the two ranks' single-process kernel calls, then
   ``entry.dryrun_multichip(2)``;
15. runs the command line, ``tpu80211_torch.cli.main(argv)`` in this process
   with its standard output captured, on the card: ``devices``; ``run`` in
   the three modes (complex128, against the same command on the CPU);
   ``parity`` in the three modes; ``raw`` at bench.py's 32768 x 2048
   (kernel #5); ``sync`` at B=4096; ``stream --device-gen`` with each
   generator, 3 x 32768, and again to resume; the host ``stream`` over the
   native engine, 3 x 32768; ``quality --snrs 10,30 --batch 4096
   --fused-dtype bf16``; ``bench --txconst`` (B=65536) and ``bench --f32``
   (B=32768) at loop length 8; ``sweep`` in a world of one on NCCL.  Each
   command must return 0 and its output passes its check; each command's
   wall time is printed.  (``plot`` needs matplotlib, which the card's
   machine lacks; the CPU tests cover it.)
16. runs the bench modules ported from the JAX package's measurement scripts
   (``python -m tpu80211_torch.bench.<name>``'s ``main`` in this process,
   standard output captured): ``stream`` (the four device stream
   generators, B=32768), ``latency`` (B=512, 4096, 32768), ``raw_stream``
   (16384 x 2048), ``raw_quality`` (8 SNRs x 4096, 8192 noise streams),
   ``stages`` (16384), ``detect`` (4096 x 2048), ``mmse_solve`` (8192, with
   the library rows), ``raw_anatomy`` (32768 x 2048, 4096 a sensitivity
   point) and ``scaling`` (a gloo world of 8 CPU processes, two processes,
   and the card's world of one on NCCL), each at its script's sizes with
   its gates; loop lengths are cut (`SCRIPT_RUNS`, printed).  Each module
   must return 0; its last line and wall time are printed.

Kernels are timed through ``tpu80211_torch/utils/timing.py``.  Every failed check raises, so the script exits non-zero.  The last two
lines are JSON: the kernel table (each kernel's launches on its path, max
abs error, card and plain ms, and its bound: bytes over 3.35 TB/s or
operations, the chain's bf16 DFT products over 989 T/s and the rest over
67 T/s, whichever is larger), then the device summary.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets import synthetic_sc as SC
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import _build
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import gen_chain as G
from tpu80211_torch.kernels import mmse_solve as MS
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.kernels import raw_gen_chain as RG
from tpu80211_torch.ops.detect import lts_time_symbol
from tpu80211_torch.pipeline import raw as P
from tpu80211_torch.pipeline import rx as RXP
from tpu80211_torch.pipeline import sc as SCP
from tpu80211_torch.pipeline import stream as S
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.utils.timing import bound, card, in_turns, nbytes, time_ms

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
B_GEN = 32768       # generative batch (scripts/bench_stream.py, bench.py --genraw)
B_GEN_SMALL = 1024  # phase 2c, and the plain version's slice of phase 7
GEN_SEED = 7        # bench.py's generative seed
N_STREAM = 4        # stream batches per generator in phase 7
KERNELS = ("fused_chain", "detect", "raw_chain", "gen_chain", "raw_gen_chain", "mmse_solve")
# the bound (utils/timing.py): the larger of bytes over the HBM rate and
# operations over their peak rates (NVIDIA's H100 SXM data sheet): the
# chain's DFTs on bf16 operands at the tensor cores' dense bf16 rate (the
# TPU kernel feeds them to its MXU in bf16), every other operation at the
# f32 rate outside them


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
    """The --raw workload's pieces on the card (the bench's
    ``raw_pieces``): the capture's frame in the first 1360 rows of every
    stream (bf16), AWGN of NOISE per plane, and offsets in [40, NS − 1400)
    from a seeded generator."""
    return TP.raw_pieces(cap, B_RAW, dev, SEED)


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
    aligned_bound = bound(B_RAW * (CHAIN_OPS + EVM_OPS), nbytes(pkt, lp, txc, consts, F.fused_chain(
        pkt, lp, txc, consts, equalize_with="h_mmse", evm_sums=True)), B_RAW * DFT_OPS)
    pk, lpm, txm = main_in
    t["chain_sync"] = in_turns(lambda: F.fused_chain(pk, lpm, txm, consts, sync=True),
                               lambda: F.fused_chain_plain(pk, lpm, txm, consts, sync=True))
    at = D.place_attributes(sig.re.dtype, noise.re.dtype, NS, B_RAW)
    torch.cuda.synchronize()
    print(f"phase 6: place kernel ({sig.re.dtype} sig, {noise.re.dtype} noise, NS={NS}): "
          f"{occupancy(at)}, {at['strip']} streams a strip")
    for dec in (16, 32):
        print(f"phase 6: detect kernel ({x.re.dtype}, decimate {dec}): "
              f"{occupancy(D.detect_attributes(x.re.dtype, decimate=dec))}")
        print(f"phase 6: raw_chain kernel ({x.re.dtype}, decimate {dec}, stream_sums): "
              f"{occupancy(R.kernel_attributes(x.re.dtype, decimate=dec))}")
    for name, n, unit in (("raw_chain16", B_RAW, "streams"), ("raw_chain32", B_RAW, "streams"),
                          ("detect", B_RAW, "streams"), ("place", B_RAW, "streams"),
                          ("chain_sync", B_MAIN, "frames")):
        k_ms, p_ms = t[name]
        print(f"phase 6: {name}: kernel {k_ms:.4f} ms = {n / k_ms * 1e3:.4g} {unit}/s; "
              f"plain {p_ms:.4f} ms = {n / p_ms * 1e3:.4g} {unit}/s")
    print(f"phase 6: the chain kernel alone on the aligned frames (B={B_RAW}, evm_sums, h_mmse): "
          f"{chain_aligned:.4f} ms, bound {aligned_bound[0]:.4f} ms ({aligned_bound[1]})")
    return t


def occupancy(at: dict) -> str:
    """A kernel's attributes as phases 6, 8 and 10 print them."""
    return (f"{at['registers']} registers, {at['local_bytes']} B local (spill) a thread, "
            f"{at['shared_bytes']} B shared a block, {at['blocks_per_sm']} blocks per SM")


def phase_timing(pk: Cplx, lp: Cplx, txc, dev) -> tuple[float, float]:
    """Kernel and plain version on the main path's inputs, in turns."""
    consts = F.chain_consts(dev)
    kernel = lambda: F.fused_chain(pk, lp, txc, consts)  # noqa: E731
    plain = lambda: F.fused_chain_plain(pk, lp, txc, consts)  # noqa: E731
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    k_ms, p_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
    # the same kernel with per-frame tx (the JAX package's _fused_call) at
    # bench.py's B=32768: the rx frames stand in for the tx frames
    pk2, lp2 = (c.map(lambda t: t[:, :B_RAW].contiguous()) for c in (pk, lp))
    tx = F.TxFrames(pk2, lp2)
    f_ms, f_plain = in_turns(lambda: F.fused_chain(pk2, lp2, tx, consts),
                             lambda: F.fused_chain_plain(pk2, lp2, tx, consts))
    out = F.fused_chain(pk2, lp2, tx, consts)
    f_bound = bound(B_RAW * CHAIN_OPS, nbytes(pk2, lp2, tx, consts, out),
                    B_RAW * (DFT_OPS + TX_DFT_OPS))
    k_out = F.fused_chain(pk, lp, txc, consts)
    k_bound = bound(B_MAIN * CHAIN_OPS, nbytes(pk, lp, txc, consts, k_out), B_MAIN * DFT_OPS)
    attrs = {tx_const: F.kernel_attributes(pk.re.dtype, tx_const) for tx_const in (True, False)}
    torch.cuda.synchronize()
    print(f"phase 4: B={B_MAIN} bf16 tx-constant: kernel {k_ms:.4f} ms ({k1:.4f}, {k2:.4f}) "
          f"= {B_MAIN / k_ms * 1e3:.4g} frames/s; plain {p_ms:.4f} ms ({p1:.4f}, {p2:.4f}) "
          f"= {B_MAIN / p_ms * 1e3:.4g} frames/s; bound {k_bound[0]:.4f} ms ({k_bound[1]})")
    print(f"phase 4: B={B_RAW} bf16 per-frame tx: kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, "
          f"bound {f_bound[0]:.4f} ms ({f_bound[1]})")
    for tx_const, at in attrs.items():
        mode = "tx-constant" if tx_const else "per-frame tx"
        print(f"phase 4: fused_chain kernel (bf16, {mode}, cp.async ring): {occupancy(at)}")
    return k_ms, p_ms


# -- the generative path (phases 2c, 7, 8) ---------------------------------------------------

# eq of fused_gen_chain at tests/_torch_inputs.py::TOL's entry for its type; the
# h planes and h_true at the f32 entries (1e-5, h_mmse 1e-3): both versions
# compute in f32 on bit-equal normals, only the sums over bins run in another
# order, and a bf16 eq element can flip one rounding (2⁻⁸)
GEN_EQ_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# stream SNRs: the JAX package's stream tests (tests/test_stream.py:42,92)
STREAM_SNR = {"kernel": 35.0, "xla": 35.0, "raw": 30.0, "kernel_raw": 30.0}


def compare_gen(tag: str, got: dict, want: dict, eq_tol: float,
                frames: slice = slice(None)) -> float:
    """fused_gen_chain's outputs against the plain version's; returns the
    max abs error over the h planes, h_true and eq."""
    max_abs = 0.0
    for name in (*F.OUT_NAMES, "h_true", "eq"):
        g, w = as_complex(got[name])[..., frames], as_complex(want[name])
        check(g.shape == w.shape, f"{tag}: {name} shape {tuple(g.shape)} vs {tuple(w.shape)}")
        tol = eq_tol if name == "eq" else 1e-3 if name == "h_mmse" else 1e-5
        err = rel(g, w)
        check(err <= tol, f"{tag}: {name} rel err {err:.3g} > {tol}")
        max_abs = max(max_abs, float((g - w).abs().max()))
    g, w = got["ow2"][frames].double(), want["ow2"].double()
    check(bool(((g - w).abs() <= 1e-4 * w.abs()).all()), f"{tag}: ow2")
    err = rel(got["checksum"][frames], want["checksum"])
    check(err <= 1e-4, f"{tag}: checksum rel err {err:.3g}")
    if "sums" in want:
        # per-lane Σ|ĥ − h|² over 53 bins per frame, f32 in another order
        err = rel(got["sums"], want["sums"])
        check(err <= 1e-5, f"{tag}: sums rel err {err:.3g}")
    return max_abs


def check_stream_record(tag: str, st: dict, full: dict) -> None:
    """The stream configuration against the full run of the same draws: the
    sums equal those recomputed from the full planes, the checksum is the
    same bits, and every plane is the full run's last 128 frames exactly."""
    h = as_complex(full["h_true"])
    per_frame = torch.stack([(as_complex(full[n]) - h).abs().square().sum(0)
                             for n in F.OUT_NAMES] + [h.abs().square().sum(0)])
    err = rel(st["sums"], per_frame.view(G.N_SUMS, -1, G.LANES).sum(1))
    check(err <= 1e-5, f"{tag}: sums vs the full run rel err {err:.3g}")
    check(torch.equal(st["checksum"], full["checksum"]), f"{tag}: checksum differs from the full run")
    for name in (*F.OUT_NAMES, "h_true", "eq"):
        for a, b in zip(st[name], full[name]):
            check(torch.equal(a, b[..., -G.LANES:]), f"{tag}: {name} is not the last 128 frames")
    check(torch.equal(st["ow2"], full["ow2"][-G.LANES:]), f"{tag}: ow2 is not the last 128 frames")


def compare_raw_gen(tag: str, got: dict, want: dict, frames: slice = slice(None)) -> float:
    """gen_raw_system against the plain version: the synthesis is bit-equal,
    so offsets, the true CFO and the detection rows are exact and h_true
    agrees to f64 summation order (1e-6); the chain's outputs at the bf16
    tolerances of phase 2b.  The checksum and the EVM sums: 1e-3 of the
    largest, since on a deep fade the blended equalizer divides by a near
    cancellation and amplifies f32 order differences (6.1e-5 and 6.8e-5
    measured at B=1024, SNR 20).  Returns the max abs error of the h
    planes."""
    for k in ("detected", "start", "offsets", "cfo_true"):
        check(torch.equal(got[k][frames], want[k]), f"{tag}: {k} differs from the plain version")
    m = got["metric"][frames]
    err = float(((m - want["metric"]).abs() / want["metric"].abs().clamp_min(1e-30)).max())
    check(err <= 1e-5, f"{tag}: metric rel err {err:.3g}")
    err = rel(as_complex(got["h_true"])[..., frames], as_complex(want["h_true"]))
    check(err <= 1e-6, f"{tag}: h_true rel err {err:.3g}")
    max_abs = 0.0
    for name, tol in (("h_wiener", 1e-4), ("h_mmse", 1e-3)):
        g, w = as_complex(got[name])[..., frames], as_complex(want[name])
        err = rel(g, w)
        check(err <= tol, f"{tag}: {name} rel err {err:.3g} > {tol}")
        max_abs = max(max_abs, float((g - w).abs().max()))
    g, w = got["ow2"][frames].double(), want["ow2"].double()
    check(bool(((g - w).abs() <= 1e-4 * w.abs()).all()), f"{tag}: ow2")
    err = float((got["cfo"][frames] - want["cfo"]).abs().max())
    check(err <= 1e-6, f"{tag}: cfo abs err {err:.3g}")
    for k in ("checksum", "evm_sums"):
        err = rel(got[k][frames], want[k])
        check(err <= 1e-3, f"{tag}: {k} rel err {err:.3g}")
    return max_abs


def phase_small_gen(cap, dev) -> dict:
    """2c: the generative kernels against their plain versions at B=1024;
    returns their max abs errors."""
    txc, lts = capture_spectra(cap, dev), lts_planes(cap, dev)
    errs = {"gen_chain": 0.0, "raw_gen_chain": 0.0}
    cases = [(model, snr, eq) for model in (None, "A") for snr in (20.0, 35.0)
             for eq in (torch.bfloat16,)] + [(None, 20.0, torch.float32)]
    for i, (model, snr, eq_dtype) in enumerate(cases):
        kw = dict(snr_db=snr, eq_dtype=eq_dtype, channel_model=model)
        tag = f"gen {model} snr {snr} {eq_dtype}"
        full = G.fused_gen_chain(SEED + i, B_GEN_SMALL, *txc, **kw)
        want = G.gen_chain_plain(SEED + i, B_GEN_SMALL, *txc, **kw)
        errs["gen_chain"] = max(errs["gen_chain"],
                                compare_gen(tag, full, want, GEN_EQ_TOL[eq_dtype]))
        st = G.fused_gen_chain(SEED + i, B_GEN_SMALL, *txc, stream_sums=True, **kw)
        compare_gen(tag + " stream", st,
                    G.gen_chain_plain(SEED + i, B_GEN_SMALL, *txc, stream_sums=True, **kw),
                    GEN_EQ_TOL[eq_dtype])
        check_stream_record(tag, st, full)
    for kw in (dict(), dict(cfo_khz=40.0, equalize_with="h_mmse"),
               dict(channel_model="A", snr_db=35.0, equalize_with="h_wiener")):
        got = RG.gen_raw_system(SEED + 5, B_GEN_SMALL, *txc, lts, return_field=True, **kw)
        want = RG.gen_raw_plain(SEED + 5, B_GEN_SMALL, *txc, lts, return_field=True, **kw)
        for g, w in zip(got["field"], want["field"]):
            check(torch.equal(g, w), f"raw gen {kw}: the field differs from the plain version's")
        errs["raw_gen_chain"] = max(errs["raw_gen_chain"], compare_raw_gen(f"raw gen {kw}", got, want))
    torch.cuda.synchronize()
    print(f"phase 2c ok: fused_gen_chain == plain at B={B_GEN_SMALL} ({len(cases)} cases, full and "
          "stream; the stream record == the full run's), gen_raw_system == plain (3 cases, "
          "40 kHz CFO included; the field, offsets and detection exact)")
    return errs


def nmse_db(est: Cplx, h: Cplx) -> float:
    e, t = as_complex(est), as_complex(h)
    return float(10 * torch.log10((e - t).abs().square().sum() / t.abs().square().sum()))


def raw_gen_gates(tag: str, out: dict, evm_den: float, in_band_min: float,
                  evm_max: float) -> tuple[float, float]:
    """bench.py:355-365's gates on a gen_raw_system run: every stream
    detected, start − offset in [−4, −2] for ``in_band_min`` of them, the
    detected streams' EVM rms below ``evm_max``, a finite checksum.
    Returns (in-band rate, EVM)."""
    det = out["detected"]
    check(bool(det.all()), f"{tag}: missed {int((~det).sum())} streams")
    err = out["start"].long() - out["offsets"].long()
    in_band = float(((err >= -4) & (err <= -2)).double().mean())
    check(in_band >= in_band_min, f"{tag}: timing in band for {in_band:.4f} < {in_band_min}")
    check(bool(torch.isfinite(out["checksum"]).all()), f"{tag}: checksum not finite")
    evm = float(torch.sqrt(out["evm_sums"][det].double().mean() / evm_den))
    check(evm < evm_max, f"{tag}: evm_rms {evm:.4f} >= {evm_max}")
    return in_band, evm


def read_stream(out_dir: pathlib.Path, n: int) -> list[dict]:
    return [dict(np.load(out_dir / f"stream_{i:06d}.npz")) for i in range(n)]


def check_stream_summaries(gen: str, records: list[dict]) -> None:
    """Every batch's summary finite, inside the JAX package's stream test
    bounds (tests/test_stream.py:52-55, 94-98) and bench.py's timing gate."""
    for i, rec in enumerate(records):
        for k, v in rec.items():
            check(bool(np.isfinite(v).all()), f"stream {gen} batch {i}: {k} not finite")
        if gen in ("kernel", "xla"):
            for k, bound in (("h_lt_nmse", 0.1), ("h_mmse_nmse", 0.1), ("h_wiener_nmse", 0.5)):
                check(float(rec[k]) < bound, f"stream {gen} batch {i}: {k} = {float(rec[k])}")
        else:
            check(float(rec["detect_rate"]) == 1.0, f"stream {gen} batch {i}: detect_rate")
            check(float(rec["timing_in_band_rate"]) >= 0.85,
                  f"stream {gen} batch {i}: timing_in_band_rate {float(rec['timing_in_band_rate'])}")
            check(float(rec["h_mmse_mag_nmse"]) < 0.1, f"stream {gen} batch {i}: h_mmse_mag_nmse")


def check_resume(tmp: pathlib.Path, gen: str, dev) -> None:
    """A stream resumed after 2 of 4 batches writes batches 2 and 3 bit for
    bit as an uninterrupted run does (B=1024)."""
    kw = dict(batch=B_GEN_SMALL, seed=GEN_SEED, snr_db=STREAM_SNR[gen], sample=8, gen=gen,
              device=dev)
    a, b = tmp / f"whole_{gen}", tmp / f"resumed_{gen}"
    S.run_stream_device(4, out_dir=str(a), **kw)
    S.run_stream_device(2, out_dir=str(b), **kw)
    again = S.run_stream_device(4, out_dir=str(b), **kw)
    check(again["frames"] == 2 * B_GEN_SMALL, f"resume {gen}: ran {again['frames']} frames")
    for i, (x, y) in enumerate(zip(read_stream(a, 4), read_stream(b, 4))):
        for k in x:
            check(np.array_equal(x[k], y[k], equal_nan=True), f"resume {gen}: batch {i} {k} differs")
    cur = [json.loads((d / "cursor.json").read_text()) for d in (a, b)]
    check(cur[0] == cur[1], f"resume {gen}: cursors differ")


def phase_gen(cap, dev):
    """7: the generative path at full width; returns (launches by kernel,
    max abs errors, inputs for phase 8)."""
    txc, lts = capture_spectra(cap, dev), lts_planes(cap, dev)
    evm_den = float((txc.txs.re[:, :15].double() ** 2 + txc.txs.im[:, :15].double() ** 2).sum())
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        F.launches = D.launches = D.place_launches = R.launches = G.launches = RG.launches = 0
        st = G.fused_gen_chain(GEN_SEED, B_GEN, *txc, snr_db=20.0, stream_sums=True)
        full = G.fused_gen_chain(GEN_SEED, B_GEN, *txc, snr_db=35.0)
        raw = RG.gen_raw_system(GEN_SEED, B_GEN, *txc, lts, equalize_with="h_mmse",
                                return_field=True)
        raw_cfo = RG.gen_raw_system(GEN_SEED + 1, B_GEN, *txc, lts, equalize_with="h_mmse",
                                    cfo_khz=40.0)
        runs = {gen: S.run_stream_device(N_STREAM, B_GEN, seed=GEN_SEED, snr_db=STREAM_SNR[gen],
                                         out_dir=str(tmp / gen), gen=gen, device=dev)
                for gen in S.GENERATORS}
        torch.cuda.synchronize()
        launches = {"gen_chain": G.launches, "raw_gen_chain": RG.launches,
                    "fused_chain": F.launches, "place": D.place_launches, "raw_chain": R.launches}
        for k, n in launches.items():
            check(n > 0, f"the generative path launched no {k} kernel")
        records = {gen: read_stream(tmp / gen, N_STREAM) for gen in S.GENERATORS}
        for gen in S.GENERATORS:
            check(runs[gen]["frames"] == N_STREAM * B_GEN, f"stream {gen}: {runs[gen]['frames']} frames")
            check_stream_summaries(gen, records[gen])
        for gen in S.GENERATORS:
            check_resume(tmp, gen, dev)

    # stream mode at SNR 20: the record and the sums
    check(tuple(st["sums"].shape) == (G.N_SUMS, G.LANES), "gen stream: sums shape")
    check(bool(torch.isfinite(st["sums"]).all() and torch.isfinite(st["checksum"]).all()),
          "gen stream: not finite")
    s = st["sums"].double().sum(-1)
    nmse20 = {n: float(10 * torch.log10(s[k] / s[-1])) for k, n in enumerate(F.OUT_NAMES)}
    # full outputs at SNR 35: tests/test_stream.py:245-253's bounds, σ̂² within 2%
    for k, v in full.items():
        for t in (v if isinstance(v, Cplx) else (v,)):
            check(t.shape[-1] == B_GEN and bool(torch.isfinite(t.float()).all()), f"gen full: {k}")
    nmse35 = {n: nmse_db(full[n], full["h_true"]) for n in F.OUT_NAMES}
    for n, bound_db in (("h_lt", -12.0), ("h_mmse", -12.0), ("h_wiener", -5.0)):
        check(nmse35[n] < bound_db, f"gen full SNR 35: {n} NMSE {nmse35[n]:.2f} dB")
    sigma_t2 = 10 ** (-3.5) / 64
    ow2 = float(full["ow2"].double().mean())
    check(abs(ow2 - sigma_t2) <= 0.02 * sigma_t2, f"gen full: mean sigma^2 {ow2} vs {sigma_t2}")
    want = G.gen_chain_plain(GEN_SEED, B_GEN_SMALL, *txc, snr_db=35.0)
    errs = {"gen_chain": compare_gen("gen full slice", full, want, GEN_EQ_TOL[torch.bfloat16],
                                     slice(0, B_GEN_SMALL))}

    in_band, evm = raw_gen_gates("raw gen", raw, evm_den, 0.85, 0.1)
    want = RG.gen_raw_plain(GEN_SEED, B_GEN_SMALL, *txc, lts, equalize_with="h_mmse",
                            return_field=True)
    errs["raw_gen_chain"] = compare_raw_gen("raw gen slice", raw, want, slice(0, B_GEN_SMALL))
    # the field's first streams against the plain version's: bit-equal where
    # h_true's f32 rounding is (its f64 sums run in another order on each
    # side, so a rare frame sample may round one bf16 ulp apart)
    field = raw.pop("field")
    n_diff, field_err = 0, 0.0
    for g, w in zip(field, want.pop("field")):
        g = g[:, :B_GEN_SMALL]
        n_diff += int((g != w).sum())
        field_err = max(field_err, float((g - w).abs().max() / w.abs().max()))
    check(n_diff <= 1e-5 * 2 * NS * B_GEN_SMALL and field_err <= 2 ** -7,
          f"raw gen slice: {n_diff} field samples differ, by up to {field_err:.3g} of the largest")
    del field
    cfo_err_hz = float(((raw_cfo["cfo"] - raw_cfo["cfo_true"]).abs() * 20e6).median())
    check(cfo_err_hz < 200.0, f"raw gen 40 kHz: median |cfo error| {cfo_err_hz:.1f} Hz")
    det = raw_cfo["detected"]
    evm_cfo = float(torch.sqrt(raw_cfo["evm_sums"][det].double().mean() / evm_den))
    check(evm_cfo < 0.15, f"raw gen 40 kHz: evm_rms {evm_cfo:.4f}")
    torch.cuda.synchronize()
    fmt = lambda d: ", ".join(f"{k} {v:.2f}" for k, v in d.items())  # noqa: E731
    print(f"phase 7 ok: fused_gen_chain B={B_GEN}: stream SNR 20 NMSE dB {fmt(nmse20)}; "
          f"full SNR 35 NMSE dB {fmt(nmse35)}, mean sigma^2 {ow2:.6g} (target {sigma_t2:.6g}); "
          f"first {B_GEN_SMALL} frames == plain")
    print(f"phase 7 ok: gen_raw_system B={B_GEN} x NS={NS} SNR 20 h_mmse: detect 1.0, timing in "
          f"band {in_band:.4f}, evm_rms {evm:.4f}; 40 kHz: median cfo error {cfo_err_hz:.1f} Hz, "
          f"detect {float(det.double().mean()):.4f}, evm_rms {evm_cfo:.4f}; first {B_GEN_SMALL} "
          f"streams == plain, their field bit-equal but for {n_diff} samples")
    for gen in S.GENERATORS:
        last = records[gen][-1]
        print(f"phase 7 ok: stream {gen} ({N_STREAM} x {B_GEN}, SNR {STREAM_SNR[gen]}): batch "
              f"{N_STREAM - 1} " + ", ".join(f"{k} {float(v):.4g}" for k, v in last.items()
                                             if k != "h_mmse_sample") + "; resume bit-identical")
    print(f"phase 7: launches {launches}")
    return launches, errs, (txc, lts, st, raw)


def phase_gen_timing(gen_in, dev) -> dict:
    """8: the generative kernels against their plain versions, and one
    stream step per generator, serialized through the carried state."""
    txc, lts, _, raw = gen_in
    t = {"gen_chain": in_turns(
        lambda: G.fused_gen_chain(GEN_SEED, B_GEN, *txc, stream_sums=True),
        lambda: G.gen_chain_plain(GEN_SEED, B_GEN, *txc, stream_sums=True))}
    gen_full = time_ms(lambda: G.fused_gen_chain(GEN_SEED, B_GEN, *txc))
    t["raw_gen_chain"] = in_turns(
        lambda: RG.gen_raw_system(GEN_SEED, B_GEN, *txc, lts, equalize_with="h_mmse"),
        lambda: RG.gen_raw_plain(GEN_SEED, B_GEN, *txc, lts, equalize_with="h_mmse"))
    steps = {}
    for gen in S.GENERATORS:
        step, s0 = S.make_device_stream_step(B_GEN, seed=GEN_SEED, gen=gen, device=dev)
        carry = {"i": 0, "state": s0}

        def one():
            _, _, carry["state"] = step(carry["i"], carry["state"])
            carry["i"] += 1

        steps[gen] = time_ms(one)
    # anatomy: the raw receiver alone on raw_gen_chain's own f32 field, and
    # the torch generators the xla and raw steps call
    field = RG.gen_raw_system(GEN_SEED, B_GEN, *txc, lts, equalize_with="h_mmse",
                              return_field=True)["field"]
    recv = time_ms(lambda: R.raw_rx_txconst_fused(field, lts, *txc, decimate=16, stream_sums=True,
                                                  equalize_with="h_mmse"))
    det = time_ms(lambda: D.detect_streams(field, lts, decimate=16))
    del field
    seeded = lambda: torch.Generator(device=dev).manual_seed(GEN_SEED)  # noqa: E731
    gen_rx = time_ms(lambda: SC.generate_rx_lane_major(seeded(), B_GEN, *txc))
    gen_raw = time_ms(lambda: SC.generate_raw_lane_major(seeded(), B_GEN, *txc, ns=NS))
    torch.cuda.synchronize()
    lower = gen_bounds(gen_in, dev)
    for name in ("gen_chain", "raw_gen_chain"):
        k_ms, p_ms = t[name]
        print(f"phase 8: {name}: kernel {k_ms:.4f} ms = {B_GEN / k_ms * 1e3:.4g} frames/s; "
              f"plain {p_ms:.4f} ms; bound {lower[name][0]:.4f} ms ({lower[name][1]})")
    print(f"phase 8: fused_gen_chain with full outputs at B={B_GEN}: {gen_full:.4f} ms")
    for eq_dtype in (torch.bfloat16, torch.float32):
        print(f"phase 8: gen_chain kernel (eq {str(eq_dtype).split('.')[-1]}): "
              f"{occupancy(G.kernel_attributes(eq_dtype))}")
    print(f"phase 8: raw_gen_chain anatomy: the raw receiver alone on its f32 field {recv:.4f} ms "
          f"(detection {det:.4f} ms), so synthesis ~{t['raw_gen_chain'][0] - recv:.4f} ms")
    for sync in (False, True):
        at = RG.kernel_attributes(sync)
        print(f"phase 8: raw_gen_chain kernel ({'with' if sync else 'no'} CFO): {occupancy(at)}")
    for gen, ms in steps.items():
        print(f"phase 8: stream step {gen}: {ms:.4f} ms per batch = {B_GEN / ms * 1e3:.4g} frames/s")
    print(f"phase 8: generate_rx_lane_major {gen_rx:.4f} ms, generate_raw_lane_major {gen_raw:.4f} ms "
          f"at B={B_GEN}")
    return t


# -- the dense MMSE solves (phases 2d, 9, 10) --------------------------------------------------

B_SOLVE = 8192           # bench.py's dense-solve batch (_bench_dense_mmse)
S_MAIN = 4 * B_MAIN      # systems on the main path: 4 averaged blocks per frame
SOLVE_SIGMA2 = 0.37      # bench.py:169
SOLVE_ROW = {"fused": "mmse_solve", "dense": "mmse_solve_dense"}


def solve_workload(n: int, dev, seed: int):
    """bench.py's systems (bench.py:162-169): u and rx (n, 53) complex64
    with standard normal real and imaginary parts, sigma^2 = 0.37; and the
    materialized systems sigma^2 I + u u^H."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u, rx = (torch.complex(torch.randn(n, 53, generator=gen, device=dev),
                           torch.randn(n, 53, generator=gen, device=dev)) for _ in range(2))
    ow2 = torch.full((n,), SOLVE_SIGMA2, device=dev)
    return u, rx, ow2, MS.rank1_systems(u, ow2)


def solve(entry: str, method: str, u, rx, ow2, a, plain: bool = False) -> torch.Tensor:
    """z (n, 53) through one entry: the kernel, or its plain version."""
    if entry == "fused":
        return (MS.fused_rank1_plain if plain else MS.fused_rank1_solve)(u, rx, ow2, method)
    return (MS.solve_batched_plain if plain else MS.solve_batched)(a, rx[..., None], method)[..., 0]


def check_solves(tag: str, n: int, dev, seed: int, entries=("fused", "dense")) -> dict:
    """Kernel against plain for each entry and method: z within 1e-4
    relative (two f32 eliminations in another order at condition ~300),
    and seven spot systems within 5e-5 of numpy's f64 solve
    (bench.py:179-183).  Returns the max abs error per kernel row."""
    u, rx, ow2, a = solve_workload(n, dev, seed)
    spots = list(range(0, n, max(1, n // 7)))
    a64, rx64 = a[spots].cpu().to(torch.complex128).numpy(), rx[spots].cpu().to(torch.complex128).numpy()
    errs = {}
    for entry in entries:
        for method in MS.METHODS:
            got = solve(entry, method, u, rx, ow2, a)
            want = solve(entry, method, u, rx, ow2, a, plain=True)
            err = rel(got, want)
            check(err <= 1e-4, f"{tag} {entry} {method}: z rel err {err:.3g} against plain")
            z = got[spots].cpu().to(torch.complex128).numpy()
            for i in range(len(spots)):
                ref = np.linalg.solve(a64[i], rx64[i])
                e = float(np.abs(z[i] - ref).max() / np.abs(ref).max())
                check(e < 5e-5, f"{tag} {entry} {method}: system {spots[i]} rel err {e:.3g} against f64")
            row = SOLVE_ROW[entry]
            errs[row] = max(errs.get(row, 0.0), float((got - want).abs().max()))
    return errs


def phase_small_solve(dev) -> dict:
    """2d: both solve kernels against their plain versions at B=1000."""
    errs = check_solves("2d", B_SMALL, dev, SEED)
    torch.cuda.synchronize()
    print(f"phase 2d ok: fused_rank1_solve and solve_batched (gauss, chol) == plain at "
          f"B={B_SMALL} systems, 7 spot systems within 5e-5 of numpy f64")
    return errs


def phase_solve(cap, dev):
    """9: bench.py's shape, then the dense MMSE path at the main path's
    B=65536 frames; returns (launches by kernel row, max abs errors)."""
    errs = check_solves("9a", B_SOLVE, dev, SEED + 1, entries=("fused",))
    rp, rl = main_inputs(cap, dev)  # (1200, B), (160, B) complex64, frame 0 the capture
    tx_blocks = SCP.extract_blocks(torch.tensor(cap.tx_packet, dtype=torch.complex64, device=dev))
    tx_pre = SCP.preamble_fft(torch.tensor(cap.tx_lptot, dtype=torch.complex64, device=dev))
    rx_blocks, rx_pre, ow2 = SCP.extract_blocks(rp.T), SCP.preamble_fft(rl.T), SCP.noise_power(rl.T)
    h_lt = SCP.lt_ls(tx_pre, rx_pre)
    del rp, rl
    torch.cuda.synchronize()

    MS.launches = MS.dense_launches = 0
    h_dense = SCP.ps_mmse_dense(tx_blocks, rx_blocks, ow2, h_lt)
    out = RXP.rx_chain_freq(tx_pre, rx_pre, tx_blocks, rx_blocks, ow2, mmse_solver="dense_pallas")
    torch.cuda.synchronize()
    launches = {"mmse_solve": MS.launches, "mmse_solve_dense": MS.dense_launches}
    for k, n in launches.items():
        check(n > 0, f"the dense MMSE path launched no {k} kernel")

    # the capture's sigma^2 (~1e-7) and SNR 30 make these systems of condition
    # 1e5-1e7: f32 solves hold h_mmse to the JAX package's 5e-2 against the
    # rank-1 closed form (tests/test_kernels.py:232-235, 251-252)
    h_sm = SCP.ps_mmse_sm(tx_blocks, rx_blocks, ow2, h_lt)
    for tag, h in (("sc.ps_mmse_dense", h_dense), ("rx_chain_freq dense_pallas", out.h_mmse)):
        check(tuple(h.shape) == (B_MAIN, 53) and bool(torch.isfinite(h).all()), f"{tag}: shape, finite")
        err, err0 = rel(h, h_sm), rel(h[0], h_sm[0])
        check(err <= 5e-2 and err0 <= 5e-2, f"{tag}: h_mmse rel err {err:.3g} (frame 0 {err0:.3g}) vs sm")
        print(f"phase 9: {tag} at B={B_MAIN} frames ({S_MAIN} systems): h_mmse rel err {err:.3g} "
              f"against sc.ps_mmse_sm (frame 0, the capture: {err0:.3g})")
    for k, v in out._asdict().items():
        check(bool(torch.isfinite(v).all()), f"rx_chain_freq dense_pallas: {k} not finite")

    # a 1024-frame slice against the plain version: the same inputs on the
    # CPU, where the wrappers run it; h_mmse within 1e-2 (f32 solves in
    # another order on systems of condition 1e5-1e7)
    cut = lambda t: t[:B_SLICE].cpu()  # noqa: E731
    want = SCP.ps_mmse_dense(tx_blocks.cpu(), cut(rx_blocks), cut(ow2), cut(h_lt))
    err = rel(h_dense[:B_SLICE].cpu(), want)
    check(err <= 1e-2, f"sc.ps_mmse_dense slice: h_mmse rel err {err:.3g} against plain")
    errs["mmse_solve"] = max(errs["mmse_solve"], float((h_dense[:B_SLICE].cpu() - want).abs().max()))
    want = RXP.rx_chain_freq(tx_pre.cpu(), cut(rx_pre), tx_blocks.cpu(), cut(rx_blocks), cut(ow2),
                             mmse_solver="dense_pallas")
    for k in RXP.RxOutputs._fields:
        g, w = getattr(out, k)[:B_SLICE].cpu(), getattr(want, k)
        tol = 1e-2 if k == "h_mmse" else 1e-3 if k == "eq" else 1e-4
        err = rel(g, w)
        check(err <= tol, f"rx_chain_freq slice: {k} rel err {err:.3g} against the CPU run")
        if k == "h_mmse":
            errs["mmse_solve_dense"] = float((g - w).abs().max())
    torch.cuda.synchronize()
    print(f"phase 9 ok: bench.py's B={B_SOLVE} fused solves (gauss, chol) pass its gates; the "
          f"dense MMSE path at B={B_MAIN} frames is within 5e-2 of sm, a {B_SLICE}-frame slice "
          f"equals the plain version; launches {launches}")
    return launches, errs


def solve_cmacs(method: str, fused: bool, n: int = 53) -> int:
    """Complex multiply-adds per system, from the shapes: LU takes, at each
    column, r = n-1-j rows times (r columns + the multiplier + the rhs);
    LL^H the trailing lower triangle r(r+1)/2 plus the column scale and the
    forward solve; both add the back substitution n(n-1)/2 + n; the fused
    kernel builds the system first (n^2 entries, the lower triangle for
    LL^H)."""
    if method == "chol":
        factor = sum(r * (r + 1) // 2 + 2 * r for r in range(1, n))
        build = n * (n + 1) // 2
    else:
        factor = sum(r * (r + 2) for r in range(1, n))
        build = n * n
    return factor + n * (n - 1) // 2 + n + (build if fused else 0)


def issued_per_system(method: str) -> tuple[int, int]:
    """Complex multiply-adds and shared loads that the solve kernel's
    factorization issues per system, over its 64 threads (csrc/mmse_solve.cu):
    at step j = 8·jb + jj each thread updates its 7×7 register tiles from
    tile jb on, all of them for LU; for LL^H those on and below the diagonal
    and the last tile column (in warp 1, which holds the right-hand side;
    warp 0 only its diagonal tile).  Warp w skips tile column jb once its
    columns 4w..4w+3 are all <= j.  A thread loads one multiplier per tile
    row and one row value per tile column (LL^H: the right-hand side's
    value, one load)."""
    cmacs = loads = 0
    for jb in range(7):
        m = 7 - jb
        for jj in range(8 if jb < 6 else 53 - 48):
            for warp in (0, 1):
                skip = jj >= 4 * warp + 3 and (method == "gauss" or jb < 6)
                if method == "gauss":
                    tiles, lds = m * m, 2 * m
                else:
                    tiles = sum(7 - b for b in range(jb, 6)) + (m if warp else 1)
                    lds = m + max(m - 1, 0) + 1
                cmacs += 32 * (tiles - skip * m)
                loads += 32 * (lds - skip)
    return cmacs, loads


def phase_solve_timing(dev) -> tuple[dict, dict]:
    """10: each solve kernel's build and occupancy; then each entry and
    method at 8192 and 262144 systems, kernel and plain version in turns,
    and torch.linalg.solve on the same complex64 systems; returns (times,
    bounds), keyed by (entry, method, n) and, for the library call,
    ("library", n)."""
    for entry in SOLVE_ROW:
        for method in MS.METHODS:
            at, (cmacs, loads) = MS.kernel_attributes(entry, method), issued_per_system(method)
            print(f"phase 10: {entry} {method} kernel: {at['registers']} registers, "
                  f"{at['local_bytes']} B local (spill) a thread, {at['shared_bytes']} B shared a "
                  f"block, {at['blocks_per_sm']} systems per SM; its factorization issues {cmacs} "
                  f"complex multiply-adds and {loads} shared loads per system")
    t, lower = {}, {}
    for n in (B_SOLVE, S_MAIN):
        u, rx, ow2, a = solve_workload(n, dev, SEED + 2)
        plain_kw = dict(calls=1, reps=3) if n > B_SOLVE else {}
        for entry in SOLVE_ROW:
            for method in MS.METHODS:
                t[entry, method, n] = in_turns(
                    lambda: solve(entry, method, u, rx, ow2, a),
                    lambda: solve(entry, method, u, rx, ow2, a, plain=True), **plain_kw)
                z = solve(entry, method, u, rx, ow2, a)
                ins = (u, rx, ow2) if entry == "fused" else (a, rx)
                lower[entry, method, n] = bound(8 * n * solve_cmacs(method, entry == "fused"),
                                                nbytes(*ins, z))
        rhs = rx[..., None]
        t["library", n] = time_ms(lambda: torch.linalg.solve(a, rhs),
                                  **(dict(calls=2, reps=3) if n > B_SOLVE else {}))
        del u, rx, ow2, a, rhs, z
    torch.cuda.synchronize()
    for (entry, method, n), (k_ms, p_ms) in ((k, v) for k, v in t.items() if k[0] != "library"):
        b_ms, b_by = lower[entry, method, n]
        print(f"phase 10: {entry} {method} n={n}: kernel {k_ms:.4f} ms = {n / k_ms * 1e3:.4g} "
              f"solves/s; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    for n in (B_SOLVE, S_MAIN):
        ms = t["library", n]
        print(f"phase 10: torch.linalg.solve n={n} complex64: {ms:.4f} ms = {n / ms * 1e3:.4g} solves/s")
    return t, lower


# operations per frame or stream, from the shapes: an f32 or 32-bit integer
# operation counts 1, a complex multiply-add 8, a log, sqrt, sin or cos 1
DFT_OPS = 16 * 53 * 64 * 8   # the chain's 16 DFTs of 53 bins from 64 samples (bf16
                             # operands on the tensor cores)
TX_DFT_OPS = 5 * 53 * 64 * 8  # per-frame tx: its preamble and blocks 0..3
CHAIN_OPS = 29_000           # the rest of the chain: equalizer 15·53·19, the five
                             # interpolators 53·4·24, MMSE 4·53·17 + 53·32, LT-LS, checksum
EVM_OPS = 15 * 53 * 4
PHILOX_OPS = 80              # ten rounds of 2 mulhi, 2 mullo, 4 xor
PAIR_OPS = 12                # two uniforms, log, sqrt, 2π·u, sin, cos, two products


def detect_ops(b: int, n_det: int, stride: int = 16, search: int = 192) -> float:
    """The lag-64 window sums over every sample (16 per sample), and the
    matched filter (64 taps) over each detected stream's fine window."""
    return b * 16 * NS + n_det * (2 * (search + stride) + 68) * 64 * 8


def gen_ops(b: int, n_taps: int) -> float:
    """fused_gen_chain: a Philox call per tap, per preamble bin and per
    block bin but DC (the equalizer zeroes it, and LT-LS's zero there makes
    its MMSE terms 0); a normal pair per tap, two per preamble bin, one per
    block bin but DC; the CFR; tx·H and the noise of 16 symbols; the chain
    without DFTs; the stream sums."""
    calls, pairs = n_taps + 53 + 15 * 52, n_taps + 2 * 53 + 15 * 52
    per = (calls * PHILOX_OPS + pairs * PAIR_OPS + 53 * n_taps * 8 + 53 * (16 * 6 + 17 * 4)
           + CHAIN_OPS + 8 * 53 * 4)
    return float(b * per)


def raw_gen_ops(b: int, n_taps: int, n_det: int) -> float:
    """gen_raw_system but for the chain's DFTs: the channel, 16 IDFTs of 64
    samples from 53 bins (f64), a noise pair per row, then detection and the
    chain with EVM sums."""
    calls, pairs = n_taps + 1 + NS, n_taps + NS
    per = (calls * PHILOX_OPS + pairs * PAIR_OPS + 53 * n_taps * 8 + 16 * 53 * 6
           + 16 * 64 * 53 * 8 + NS * 4 + CHAIN_OPS + EVM_OPS)
    return b * per + detect_ops(b, n_det)


def gen_bounds(gen_in, dev) -> dict:
    """The generative kernels' bounds at phase 8's shapes, from phase 7's
    inputs and outputs.  gen_raw_system's chain reads the field as bf16, so
    its DFTs count at the tensor cores' rate."""
    txc, lts, st, raw = gen_in
    n_taps = G.channel_consts(dev).tscale.shape[0]
    return {"gen_chain": bound(gen_ops(B_GEN, n_taps), nbytes(txc, st)),
            "raw_gen_chain": bound(raw_gen_ops(B_GEN, n_taps, int(raw["detected"].sum())),
                                   nbytes(txc, lts, raw), B_GEN * DFT_OPS)}


def bounds(main_in, raw_in, gen_in, dev) -> dict:
    """Each kernel's bound at the shapes phases 4, 6 and 8 time, from this
    run's inputs and outputs."""
    pk, lp, txm = main_in
    x, lts, txc, sig, noise, offs = raw_in
    consts = F.chain_consts(dev)
    b_main, b_raw = pk.re.shape[-1], x.re.shape[-1]
    chain_out = F.fused_chain(pk, lp, txm, consts)
    det = D.detect_streams(x, lts, decimate=16)
    n_det = int(det["detected"].sum())
    raw_out = R.raw_rx_txconst_fused(x, lts, *txc, decimate=16, stream_sums=True,
                                     equalize_with="h_mmse")
    return {
        "fused_chain": bound(b_main * CHAIN_OPS, nbytes(pk, lp, txm, consts, chain_out),
                             b_main * DFT_OPS),
        "detect": bound(detect_ops(b_raw, n_det), nbytes(x, lts, det)),
        "place": bound(2 * sig.re.numel(), nbytes(sig, noise, offs, x)),
        "raw_chain": bound(detect_ops(b_raw, n_det) + b_raw * (CHAIN_OPS + EVM_OPS),
                           nbytes(x, lts, txc, raw_out), b_raw * DFT_OPS),
        **gen_bounds(gen_in, dev),
    }


# -- the bench rows and the host stream (phases 11, 12, 13) ---------------------------------

BENCH_ITERS = 8   # phase 11's loop length: the bench's full shapes, short loops
N_HOST = 3        # phase 12's batches


def phase_bench(dev) -> dict:
    """11: every default row of ``python -m tpu80211_torch.bench.throughput``
    at its full shape with loop length 8: its gates, both fences on both
    clocks, each row printed; returns the full rows."""
    def log(name, row):
        print(f"phase 11: {name}: {json.dumps(TP.compact(row), separators=(',', ':'))}", flush=True)

    torch.cuda.synchronize()
    F.launches = D.launches = D.place_launches = R.launches = RG.launches = MS.launches = 0
    rows = TP.run(TP.DEFAULT_ROWS, iters=BENCH_ITERS, device=dev, log=log)
    torch.cuda.synchronize()
    launches = {"fused_chain": F.launches, "place": D.place_launches, "raw_chain": R.launches,
                "raw_gen_chain": RG.launches, "mmse_solve": MS.launches}
    for k, n in launches.items():
        check(n > 0, f"the bench rows launched no {k} kernel")
    line = json.dumps(TP.summary(rows, dev), separators=(",", ":"))
    check(len(line) < TP.MAX_LINE, f"the bench line has {len(line)} characters")
    print(f"phase 11 ok: {len(rows)} bench rows gated and timed (loop length {BENCH_ITERS}), "
          f"the bench line {len(line)} characters; launches {launches}")
    return rows


def phase_host_stream(dev) -> None:
    """12: ``run_stream`` (``sc.rx_chain_freq`` on the card) over the native
    engine's batches, B=32768, 3 batches: shards persisted, batch 0's first
    1024 frames against the same frames on the CPU (h 1e-4, h_mmse 1e-3),
    and a run stopped after 2 batches resumed to 3, its shards those of the
    whole run."""
    def batches(n):
        return S.synthetic_batches(n, B_GEN, seed=SEED, engine="native")

    with tempfile.TemporaryDirectory() as tmp:
        whole, resumed = pathlib.Path(tmp) / "whole", pathlib.Path(tmp) / "resumed"
        t0 = time.perf_counter()
        res = S.run_stream(batches(N_HOST), out_dir=str(whole), device=dev)
        wall = time.perf_counter() - t0
        check(res["frames"] == N_HOST * B_GEN and res["batches"] == N_HOST, f"run_stream: {res}")
        cursor = json.loads((whole / "cursor.json").read_text())
        check(cursor["done"] == list(range(N_HOST)), f"run_stream cursor {cursor}")
        shard = np.load(whole / "h_est_000000.npz")
        want = SCP.rx_chain_freq(*(x[:B_SLICE] for x in next(batches(1))))
        errs = {}
        for k in S._STREAM_ESTS:
            got = torch.from_numpy(shard[k])
            check(tuple(got.shape) == (B_GEN, 53) and bool(torch.isfinite(got).all()),
                  f"run_stream shard 0: {k} shape {tuple(got.shape)} or not finite")
            errs[k] = rel(got[:B_SLICE], getattr(want, k))
            tol = 1e-3 if k == "h_mmse" else 1e-4
            check(errs[k] <= tol, f"run_stream shard 0: {k} rel err {errs[k]:.3g} against the CPU")
        S.run_stream(batches(2), out_dir=str(resumed), device=dev)
        again = S.run_stream(batches(N_HOST), out_dir=str(resumed), device=dev)
        check(again["batches"] == 1 and again["frames"] == B_GEN, f"resume ran {again}")
        for i in range(N_HOST):
            a, b = (np.load(d / f"h_est_{i:06d}.npz") for d in (whole, resumed))
            for k in S._STREAM_ESTS:
                err = float(np.abs(a[k] - b[k]).max() / np.abs(a[k]).max())
                check(err <= 1e-6, f"resume: batch {i} {k} differs by {err:.3g}")
    print(f"phase 12 ok: run_stream over the native engine, {N_HOST} x {B_GEN} frames on the card "
          f"in {wall:.2f} s ({res['frames'] / wall:.4g} frames/s, host generation and shard "
          f"writes included); shard 0's first {B_SLICE} frames == the CPU's (max rel err "
          f"{max(errs.values()):.3g}); resumed after 2 batches to the same shards")


def phase_native_fused(dev) -> tuple[int, float]:
    """13: ``native_time_batches`` into the batch-major ``fused_rx_chain``
    (#2, per-frame tx, f32 planes) at B=32768; a 1024-frame slice against
    the plain version at the f32 tolerances.  Returns (launches, max abs
    err)."""
    (args,) = list(S.native_time_batches(1, B_GEN, seed=SEED))
    ins = [c.map(lambda t: t.to(dev)) for c in args]
    torch.cuda.synchronize()
    F.launches = 0
    out = F.fused_rx_chain(*ins)
    torch.cuda.synchronize()
    launches = F.launches
    check(launches > 0, "native_time_batches -> fused_rx_chain launched no fused_chain kernel")
    for k, v in out.items():
        for t in (v if isinstance(v, Cplx) else (v,)):
            check(t.shape[0] == B_GEN and bool(torch.isfinite(t).all()), f"native fused: {k}")
    tx_pkt, rx_pkt, tx_lp, rx_lp = (c.map(lambda t: t[:B_SLICE].T.contiguous()) for c in ins)
    want = F.fused_chain_plain(rx_pkt, rx_lp, F.TxFrames(tx_pkt, tx_lp), F.chain_consts(dev))
    lane = {k: v if k in ("ow2", "cfo", "checksum") else
            v.map(lambda t: t.permute(1, 2, 0) if t.dim() == 3 else t.T) for k, v in out.items()}
    max_abs = compare("native fused slice", lane, want, *TOL[torch.float32], slice(0, B_SLICE))
    torch.cuda.synchronize()
    print(f"phase 13 ok: native_time_batches -> fused_rx_chain at B={B_GEN} f32 (per-frame tx); "
          f"a {B_SLICE}-frame slice == plain, max abs err {max_abs:.3g}; {launches} launch")
    return launches, max_abs


# -- the multi-device layer (phase 14) -------------------------------------------------------

B_MESH = B_MAIN        # the sm step at the main path's batch
B_MESH_DENSE = 16384   # the dense step: 16,384 frames x 15 blocks = 245,760 systems
B_MESH_TWO = 16384     # the shard-map steps of the two-rank world
OW2_DENSE = 0.25       # a well-conditioned sigma^2 for the dense f32 solve (tests/test_mesh.py:118-121)
MESH_TOL = 1e-4        # tests/test_mesh.py:94-105: every estimate and eq, and the metric
TWO_RANKS = "two ranks time-sliced on one card, gloo; not a scaling figure"


def mesh_inputs(cap, dev, b: int) -> tuple:
    """The first b of phase 3's capture-like frames in the frequency domain,
    batch-major on the card: (tx_pre (b, 53), rx_pre, tx_blocks (b, 15, 53),
    rx_blocks, ow2 (b,)); the tx side is the capture's, alike in every frame."""
    rp, rl = (x[:, :b].T.contiguous() for x in main_inputs(cap, dev))
    tx_blocks = SCP.extract_blocks(torch.tensor(cap.tx_packet, dtype=torch.complex64, device=dev))
    tx_pre = SCP.preamble_fft(torch.tensor(cap.tx_lptot, dtype=torch.complex64, device=dev))
    return (tx_pre.expand(b, -1).contiguous(), SCP.preamble_fft(rl),
            tx_blocks.expand(b, -1, -1).contiguous(), SCP.extract_blocks(rp), SCP.noise_power(rl))


def check_rx(tag: str, out, mse, ref, blocks: slice = slice(0, 15)) -> float:
    """Each estimate and eq (on ``blocks`` of the frame) within MESH_TOL of
    ``ref`` (an RxOutputs), the metric within MESH_TOL of ``ref``'s mean
    |h_mmse|^2; returns the largest relative error."""
    worst = 0.0
    for name in S._STREAM_ESTS:
        worst = max(worst, rel(getattr(out, name), getattr(ref, name)))
    nb = blocks.stop - blocks.start
    worst = max(worst, rel(out.eq[:, :nb], ref.eq[:, blocks]))
    want = float(ref.h_mmse.abs().double().square().mean())
    check(worst <= MESH_TOL, f"{tag}: rel err {worst:.3g} > {MESH_TOL}")
    check(abs(float(mse) - want) <= MESH_TOL * want, f"{tag}: metric {float(mse)} vs {want}")
    return worst


def host_ms(fn, calls: int = 50) -> float:
    """Host ms a call to dispatch ``calls`` back-to-back calls (the card
    synchronized before and after, outside the clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def phase_mesh_one(cap, dev, tmp: pathlib.Path) -> dict:
    """14a: a world of one on NCCL in this process, at full width: the sm
    step at B=65536 against ``sc.rx_chain_freq``, the dense step (#8) at
    B=16384 against sm, and the mesh ``kernel`` (#6) and ``kernel_raw`` (#7)
    stream steps at B=32768 bit-equal to the steps without a mesh over two
    chained batches; each timed beside its single-process counterpart (and
    the stream steps' host dispatch, and one 9-float NCCL all-reduce).
    Saves the world-of-one outputs at B=16384 for 14b.  Returns the
    launches."""
    from tpu80211_torch.parallel import mesh as PM
    from tpu80211_torch.parallel import multihost

    multihost.init_distributed(f"file://{tmp / 'store'}", 1, 0, device=dev)
    try:
        check(torch.distributed.get_backend() == "nccl", "the world of one is not on NCCL")
        mesh = PM.make_mesh(device=dev)
        args = mesh_inputs(cap, dev, B_MESH)
        dense_args = tuple(x[:B_MESH_DENSE] for x in args[:4]) + (
            torch.full((B_MESH_DENSE,), OW2_DENSE, device=dev),)
        step_sm, _ = PM.rx_step_shardmap(mesh)
        step_dense, _ = PM.rx_step_shardmap(mesh, solver="dense")
        steps = {gen: S.make_device_stream_step(B_GEN, seed=GEN_SEED, snr_db=STREAM_SNR[gen],
                                                gen=gen, mesh=mesh, device=dev)
                 for gen in S.MESH_GENERATORS}
        torch.cuda.synchronize()
        G.launches = RG.launches = MS.launches = 0
        out, mse = step_sm(*args)
        out_d, mse_d = step_dense(*dense_args)
        mesh_runs = {}
        for gen, (step, state) in steps.items():
            runs = []
            for i in range(2):
                summary, sample, state = step(i, state)
                runs.append((summary, sample, state))
            mesh_runs[gen] = runs
        torch.cuda.synchronize()
        launches = {"gen_chain": G.launches, "raw_gen_chain": RG.launches,
                    "mmse_solve": MS.launches}
        for k, n in launches.items():
            check(n > 0, f"phase 14a launched no {k} kernel")

        err_sm = check_rx(f"sm step B={B_MESH}", out, mse, SCP.rx_chain_freq(*args))
        out_s, mse_s = step_sm(*dense_args)
        err_d = rel(out_d.h_mmse, out_s.h_mmse)
        check(err_d <= MESH_TOL, f"dense step: h_mmse rel err {err_d:.3g} against sm")
        check(abs(float(mse_d) - float(mse_s)) <= MESH_TOL * float(mse_s), "dense step: metric")
        for gen, runs in mesh_runs.items():
            step, state = S.make_device_stream_step(B_GEN, seed=GEN_SEED, snr_db=STREAM_SNR[gen],
                                                    gen=gen, device=dev)
            for i, (msum, msample, mstate) in enumerate(runs):
                summary, sample, state = step(i, state)
                for k, v in msum.items():
                    check(torch.equal(v, summary[k]), f"mesh {gen} step {i}: {k} differs")
                check(torch.equal(msample.re, sample.re) and torch.equal(msample.im, sample.im),
                      f"mesh {gen} step {i}: sample differs")
                check(torch.equal(mstate, state), f"mesh {gen} step {i}: next state differs")

        t = {"sm": in_turns(lambda: step_sm(*args), lambda: SCP.rx_chain_freq(*args)),
             "dense": in_turns(lambda: step_dense(*dense_args), lambda: step_sm(*dense_args))}
        host = {}
        for gen, (mstep, m0) in steps.items():
            sstep, s0 = S.make_device_stream_step(B_GEN, seed=GEN_SEED, snr_db=STREAM_SNR[gen],
                                                  gen=gen, device=dev)
            t[gen] = in_turns(lambda: mstep(0, m0), lambda: sstep(0, s0))
            host[gen] = (host_ms(lambda: mstep(0, m0)), host_ms(lambda: sstep(0, s0)))
        # what one collective of the mesh stream step costs: 9 floats over NCCL
        small, dp_group = torch.zeros(9, device=dev), PM.axis(mesh, PM.DP)[2]
        t["all_reduce"] = time_ms(lambda: PM.all_reduce(small, dp_group))
        host["all_reduce"] = host_ms(lambda: PM.all_reduce(small, dp_group))
        print(f"phase 14a: {card()}; world of one, NCCL")
        print(f"phase 14a: rx_step_shardmap sm B={B_MESH}: {t['sm'][0]:.4f} ms; "
              f"sc.rx_chain_freq {t['sm'][1]:.4f} ms")
        print(f"phase 14a: rx_step_shardmap dense B={B_MESH_DENSE} ({B_MESH_DENSE * 15} systems): "
              f"{t['dense'][0]:.4f} ms; the sm step {t['dense'][1]:.4f} ms")
        for gen in S.MESH_GENERATORS:
            print(f"phase 14a: mesh stream step {gen} B={B_GEN}: {t[gen][0]:.4f} ms; "
                  f"without a mesh {t[gen][1]:.4f} ms; host dispatch a call "
                  f"{host[gen][0]:.4f} ms, without a mesh {host[gen][1]:.4f} ms")
        print(f"phase 14a: NCCL all_reduce of 9 floats: {t['all_reduce']:.4f} ms on events, "
              f"{host['all_reduce']:.4f} ms of host dispatch a call")

        # 14b's reference: the world of one at B_MESH_TWO, both solvers
        two = tuple(x[:B_MESH_TWO] for x in args)
        ref = {}
        for solver, a in (("sm", two), ("dense", two[:4] + (torch.full_like(two[4], OW2_DENSE),))):
            o, m = (step_sm if solver == "sm" else step_dense)(*a)
            ref[solver] = ({k: getattr(o, k).cpu() for k in (*S._STREAM_ESTS, "eq")}, float(m))
        torch.save(ref, tmp / "world_of_one.pt")
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()
    print(f"phase 14a ok: world of one on NCCL: sm step B={B_MESH} == sc.rx_chain_freq (rel err "
          f"{err_sm:.3g}), dense step B={B_MESH_DENSE} == sm (rel err {err_d:.3g}), mesh kernel "
          f"and kernel_raw steps B={B_GEN} bit-equal to the steps without a mesh; launches {launches}")
    return launches


def mesh_two_rank(ref_path: str) -> dict:
    """14b, on each rank of a two-rank gloo world on one card: the shard-map
    steps over dp=2 and over dp=1 x blk=2, with sm and dense, against the
    world of one (MESH_TOL); the mesh kernel and kernel_raw steps at
    B=32768 against the pool of two single-process kernel calls with the
    ranks' seeds (rank 0 makes them: the same sums, the same f32 order);
    step times.  Returns this rank's launches and times, and rank 0's
    stream summaries."""
    from tpu80211_torch.parallel import mesh as PM
    from tpu80211_torch.parallel import multihost

    dev = multihost.rank_device("cuda")
    rank = torch.distributed.get_rank()
    cap = load_capture()
    ref = torch.load(ref_path)
    full = mesh_inputs(cap, dev, B_MESH_TWO)
    meshes = {(dp, blk): PM.make_mesh(dp=dp, blk=blk, device="cuda") for dp, blk in ((2, 1), (1, 2))}
    streams = {gen: S.make_device_stream_step(B_GEN, seed=GEN_SEED, snr_db=STREAM_SNR[gen],
                                              gen=gen, mesh=meshes[2, 1], device=dev)
               for gen in S.MESH_GENERATORS}
    torch.cuda.synchronize()
    G.launches = RG.launches = MS.launches = 0
    res, calls = {"times": {}}, {}
    for (dp, blk), mesh in meshes.items():
        blk_rank = PM.axis(mesh, PM.BLK)[1]
        for solver in PM.SOLVERS:
            step, nb_pad = PM.rx_step_shardmap(mesh, solver=solver)
            ow2 = full[4] if solver == "sm" else torch.full_like(full[4], OW2_DENSE)
            pre = PM.shard_batch(mesh, (full[0], full[1], ow2), dev)
            blocks = PM.shard_blocks(mesh, tuple(PM.pad_blocks(x, blk)[:, :nb_pad]
                                                 for x in full[2:4]), dev)
            args = (pre[0], pre[1], *blocks, pre[2])
            calls[dp, blk, solver] = (step, args, PM.frame_sharding(mesh, B_MESH_TWO),
                                      blk_rank * (nb_pad // blk), step(*args))
    for gen, (step, state) in streams.items():
        calls[gen] = step(0, state)
    torch.cuda.synchronize()
    res["launches"] = {"gen_chain": G.launches, "raw_gen_chain": RG.launches,
                       "mmse_solve": MS.launches}

    for key, value in calls.items():
        if key in S.MESH_GENERATORS:
            continue
        step, args, rows, b0, (out, mse) = value
        want, want_mse = ref[key[2]]
        b1 = min(b0 + out.eq.shape[1], 15)
        err = max(max(rel(getattr(out, k), want[k][rows].to(dev)) for k in S._STREAM_ESTS),
                  rel(out.eq[:, :b1 - b0], want["eq"][rows, b0:b1].to(dev)))
        check(err <= MESH_TOL, f"two ranks {key}: rel err {err:.3g} against the world of one")
        check(abs(float(mse) - want_mse) <= MESH_TOL * want_mse, f"two ranks {key}: metric")
        res["times"][key] = time_ms(lambda: step(*args))
    for gen in S.MESH_GENERATORS:
        summary, _, state = calls[gen]
        if rank == 0:
            want, want_state = pooled_stream(gen, cap, dev)
            check(set(summary) == set(want), f"two ranks {gen}: keys {sorted(summary)}")
            for k, v in want.items():
                check(torch.equal(summary[k], v), f"two ranks {gen}: {k} {float(summary[k])} "
                      f"!= the pooled {float(v)}")
            check(torch.equal(state, want_state), f"two ranks {gen}: next state")
            res[gen] = {k: float(v) for k, v in summary.items()}
        step, state0 = streams[gen]
        res["times"][gen] = time_ms(lambda: step(0, state0))
    torch.cuda.synchronize()
    return res


def pooled_stream(gen: str, cap, dev, ranks: int = 2) -> tuple[dict, torch.Tensor]:
    """The summary and next state that the mesh stream step ``gen`` over
    ``ranks`` dp ranks at B=32768 must give: each rank's B/ranks frames
    received in this process with that rank's seed, their sums added in
    rank order in f32 (as the all-reduce adds them), then the step's
    formulas (C3's EVM for kernel_raw)."""
    txc = F.tx_spectra(planes(cap.tx_packet, torch.float32, dev),
                       planes(cap.tx_lptot, torch.float32, dev))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pooled = None
    for r in range(ranks):
        seed = S.kernel_seed(GEN_SEED, 0, zero, r)
        if gen == "kernel":
            out = G.fused_gen_chain(seed, B_GEN // ranks, *txc, snr_db=STREAM_SNR[gen],
                                    stream_sums=True)
            pack = out["sums"].sum(-1)
        else:
            lts = planes(lts_time_symbol(cap.tx_lptot).numpy(), torch.float32, dev)
            out = RG.gen_raw_system(seed, B_GEN // ranks, *txc, lts, snr_db=STREAM_SNR[gen])
            pack = S._raw_pack(out, out["offsets"])
        pack = torch.cat([pack, out["checksum"].sum()[None]])
        pooled = pack if pooled is None else pooled + pack
    s = pooled[:-1]
    if gen == "kernel":
        want = {n + "_nmse": s[k] / s[-1] for k, n in enumerate(S._STREAM_ESTS)}
    else:
        evm_den = float((txc.txs.re[:, :15].double() ** 2 + txc.txs.im[:, :15].double() ** 2).sum())
        want = S._raw_rates(s, B_GEN, evm_den)
    return want, S._state_of(pooled[-1])


def phase_mesh_two(tmp: pathlib.Path) -> dict:
    """14b: ``mesh_two_rank`` in a two-rank gloo world on the one card
    (``parallel/launch.py``), then ``dryrun_multichip(2)`` on the card.
    Returns rank 0's launches."""
    from tpu80211_torch import entry
    from tpu80211_torch.parallel import launch

    t0 = time.perf_counter()
    res = launch.launch(mesh_two_rank, 2, str(tmp / "world_of_one.pt"), device="cuda",
                        backend="gloo")
    wall = time.perf_counter() - t0
    for k, n in res["launches"].items():
        check(n > 0, f"phase 14b launched no {k} kernel on rank 0")
    for key, ms in res["times"].items():
        what = (f"rx_step_shardmap {key[2]} dp={key[0]} blk={key[1]} B={B_MESH_TWO}"
                if isinstance(key, tuple) else f"mesh stream step {key} B={B_GEN} (dp=2)")
        print(f"phase 14b: {what}: {ms:.4f} ms ({TWO_RANKS})")
    t0 = time.perf_counter()
    entry.dryrun_multichip(2)
    print(f"phase 14b ok: two-rank gloo world ({wall:.1f} s): shard-map steps (dp=2; dp=1 x blk=2; "
          f"sm, dense) == the world of one; mesh kernel {res['kernel']} and kernel_raw "
          f"{res['kernel_raw']} == the pool of the ranks' single-process calls; "
          f"dryrun_multichip(2) on the card in {time.perf_counter() - t0:.1f} s; rank 0 launches "
          f"{res['launches']}")
    return res["launches"]


# -- the command line (phase 15) -------------------------------------------------------------

B_CLI_RAW = B_RAW        # bench.py's raw shape: 32768 streams x NS=2048
B_CLI_SYNC = 4096
B_CLI_QUALITY = 4096
N_CLI_STREAM = 3         # batches of B_GEN per stream command
CLI_MODES = ("math", "matlab", "c_parity")
PRINT_QUANTUM = 1e-10    # run prints 11 significant digits (%+.10e): one unit of the last, relative
# the JAX commands' output keys: the stream summary and record
# (tpu80211/pipeline/stream.py:297-301, 367, 484-487, 538) and a sweep row
# (tpu80211/bench/scaling.py:62-71)
STREAM_KEYS = {"frames", "batches", "wall_s", "frames_per_s", "out_dir"}
HOST_STREAM_KEYS = {"frames", "batches", "out_dir"}
RECORD_KEYS = {
    "kernel": {f"{k}_nmse" for k in F.OUT_NAMES} | {"h_mmse_sample"},
    "raw": {"detect_rate", "timing_in_band_rate", "evm_rms", "h_mmse_mag_nmse", "h_mmse_sample"},
}
SWEEP_KEYS = {"dp", "blk", "devices", "frames_per_s", "ms_per_step", "scaling_efficiency"}


def cli_call(walls: dict, tag: str, *argv: str) -> str:
    """``cli.main(argv)`` in this process, its standard output captured;
    checks the exit code 0 and records the wall time (to a synchronize)."""
    from tpu80211_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    walls[tag] = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv)}: exit code {rc}")
    return buf.getvalue()


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def parse_run(out: str) -> dict:
    """``run``'s printed H_EST lines → {estimator: (53,) complex128}."""
    res, name = {}, None
    for line in out.splitlines():
        if line.startswith("# "):
            name = line[2:].split(" (")[0]
            res[name] = []
        elif line.startswith("H_EST["):
            re_, im = line.split(" = ")[1].split()
            res[name].append(complex(float(re_), float(im[:-1])))
    return {k: np.array(v) for k, v in res.items()}


def phase_cli(dev, tmp: pathlib.Path) -> dict:
    """15: every subcommand but ``plot`` through ``cli.main`` on the card
    (module docstring); returns the launches of #1/#2, #4, #5, #6, #7."""
    from tpu80211_torch import cli
    from tpu80211_torch.config import ESTIMATOR_NAMES

    walls = {}
    out = cli_call(walls, "devices", "devices")
    check("H100" in out, f"devices: {out!r}")

    torch.cuda.synchronize()
    F.launches = D.place_launches = R.launches = G.launches = RG.launches = 0
    run_err = {}
    for mode in CLI_MODES:
        got = parse_run(cli_call(walls, f"run {mode}", "run", "--mode", mode))
        want = parse_run(cli_call(walls, f"run {mode} (cpu)", "run", "--mode", mode,
                                  "--device", "cpu"))
        exact = (cli.run_estimators(ESTIMATOR_NAMES, mode, device=dev),
                 cli.run_estimators(ESTIMATOR_NAMES, mode, device="cpu"))
        check(list(got) == list(want) == list(ESTIMATOR_NAMES), f"run {mode}: {list(got)}")
        for name in ESTIMATOR_NAMES:
            # tests/test_torch_models.py: 1e-12; 1e-8 for MATLAB mode's sigma^2 division
            tol = 1e-8 if (mode, name) == ("matlab", "ps_mmse") else 1e-12
            check(got[name].shape == (53,) and bool(np.isfinite(got[name]).all()),
                  f"run {mode}: {name} shape {got[name].shape} or not finite")
            err = rel(torch.from_numpy(exact[0][name][1]), torch.from_numpy(exact[1][name][1]))
            printed = rel(torch.from_numpy(got[name]), torch.from_numpy(want[name]))
            check(err <= tol and printed <= tol + PRINT_QUANTUM,
                  f"run {mode} {name}: card vs CPU rel err {err:.3g} (printed {printed:.3g})")
            run_err[mode] = max(run_err.get(mode, 0.0), err)
        res = last_json(cli_call(walls, f"parity {mode}", "parity", "--mode", mode))
        check(res["pass"] and max(res["max_rel_err"].values()) < 1e-6, f"parity {mode}: {res}")

    res = last_json(cli_call(walls, "raw", "raw", "--batch", str(B_CLI_RAW), "--ns", str(NS)))
    check(res["streams"] == res["detected"] == B_CLI_RAW, f"raw: {res}")
    check(-4 <= res["timing_err_min"] <= res["timing_err_max"] <= -2, f"raw: {res}")
    raw_res = res

    res = last_json(cli_call(walls, "sync", "sync", "--batch", str(B_CLI_SYNC)))
    check(abs(res["fo_hz_estimated"] - 20e3) <= 0.02 * 20e3, f"sync: {res}")  # tests/test_cfo.py:47
    check(res["median_symbol_err_sync"] < res["median_symbol_err_uncorrected"], f"sync: {res}")
    sync_res = res

    stream_res = {}
    for gen in S.GENERATORS:
        where = tmp / f"stream_{gen}"
        args = ("stream", "--device-gen", "--gen", gen, "--batches", str(N_CLI_STREAM),
                "--batch", str(B_GEN), "--out-dir", str(where))
        res = last_json(cli_call(walls, f"stream --device-gen --gen {gen}", *args))
        check(set(res) == STREAM_KEYS and res["frames"] == N_CLI_STREAM * B_GEN, f"{gen}: {res}")
        keys = RECORD_KEYS["raw" if gen in ("raw", "kernel_raw") else "kernel"]
        for rec in read_stream(where, N_CLI_STREAM):
            check(set(rec) == keys, f"stream {gen}: record keys {sorted(rec)}")
            check(all(bool(np.isfinite(v).all()) for v in rec.values()), f"stream {gen}: not finite")
            if gen in ("raw", "kernel_raw"):
                check(float(rec["detect_rate"]) == 1.0, f"stream {gen}: detect {rec['detect_rate']}")
        again = last_json(cli_call(walls, f"stream {gen} resumed", *args))
        check(again["frames"] == 0, f"stream {gen}: the resumed run ran {again}")
        stream_res[gen] = res["frames_per_s"]

    where = tmp / "stream_host"
    args = ("stream", "--batches", str(N_CLI_STREAM), "--batch", str(B_GEN), "--out-dir", str(where))
    res = last_json(cli_call(walls, "stream (host, native)", *args))
    check(set(res) == HOST_STREAM_KEYS and res["frames"] == N_CLI_STREAM * B_GEN, f"host: {res}")
    for i in range(N_CLI_STREAM):
        with np.load(where / f"h_est_{i:06d}.npz") as shard:
            check(set(shard.files) == set(S._STREAM_ESTS), f"host stream shard {i}: {shard.files}")
            check(all(shard[k].shape == (B_GEN, 53) and np.isfinite(shard[k]).all()
                      for k in shard.files), f"host stream shard {i}")
    again = last_json(cli_call(walls, "stream (host) resumed", *args))
    check(again["batches"] == 0, f"host stream: the resumed run ran {again}")

    rows = [json.loads(ln) for ln in cli_call(
        walls, "quality", "quality", "--snrs", "10,30", "--batch", str(B_CLI_QUALITY),
        "--fused-dtype", "bf16").strip().splitlines()]
    check(len(rows) == 4 and all(r["path"] == "fused_chain" for r in rows[2:]), "quality rows")
    for lo, hi in ((rows[0], rows[1]), (rows[2], rows[3])):
        for name, m in lo["estimators"].items():
            check(hi["estimators"][name]["nmse_db"] < m["nmse_db"],
                  f"quality: {name} NMSE {m['nmse_db']} at 10 dB, "
                  f"{hi['estimators'][name]['nmse_db']} at 30 dB")

    bench = {}
    for tag, args, row, storage in (
            ("bench --txconst", ("--txconst", "--batch", str(B_MAIN)), "txconst", "bf16"),
            ("bench --f32", ("--f32", "--batch", str(B_GEN)), "fused", "f32")):
        res = last_json(cli_call(walls, tag, "bench", *args, "--iters", str(BENCH_ITERS)))
        check(list(res["rows"]) == [row] and res["metric"].endswith(f"{storage} planes"),
              f"{tag}: {res['metric']}")
        bench[tag] = res["rows"][row]

    rows = [json.loads(ln) for ln in cli_call(
        walls, "sweep", "sweep", "--batch", "4096", "--iters", "2").strip().splitlines()]
    check(len(rows) == 2 and all(set(r) == SWEEP_KEYS and r["devices"] == 1 for r in rows),
          f"sweep rows {rows}")
    check(not torch.distributed.is_initialized(), "sweep left its world up")

    torch.cuda.synchronize()
    launches = {"fused_chain": F.launches, "place": D.place_launches, "raw_chain": R.launches,
                "gen_chain": G.launches, "raw_gen_chain": RG.launches}
    for k, n in launches.items():
        check(n > 0, f"phase 15 launched no {k} kernel")
    print(f"phase 15: {card()}")
    for tag, wall in walls.items():
        print(f"phase 15: {tag}: {wall:.3f} s")
    print(f"phase 15: raw {raw_res}; sync {sync_res}; device streams frames/s {stream_res}; "
          f"bench {json.dumps(bench, separators=(',', ':'))}")
    print(f"phase 15 ok: every subcommand but plot on the card in {sum(walls.values()):.1f} s; "
          f"run card == CPU (max rel err {run_err}); parity passes in every mode; raw "
          f"{B_CLI_RAW} streams all detected; sync, streams (resumed), quality, bench (gated), "
          f"sweep pass; launches {launches}")
    return launches


# -- the script modules (phase 16) -----------------------------------------------------------

# each module's arguments: the script's sizes; the loop length n cut from the
# script's (third column) to keep the phase near 90 s
SCRIPT_RUNS = (
    ("stream", ("32768", "8"), "n 24 -> 8"),
    ("latency", ("16",), "iters 32 -> 16"),
    ("raw_stream", ("16384", "8"), "n 24 -> 8"),
    ("raw_quality", (), "untimed"),
    ("stages", ("16384", "8"), "n 24 -> 8"),
    ("detect", ("4096", "2048", "8"), "n 24 -> 8"),
    ("mmse_solve", ("8192", "8", "--methods", "gauss,chol,xla,xla_chol"), "n 32 -> 8"),
    ("raw_anatomy", ("32768", "8"), "n 24 -> 8"),
    ("scaling", ("--iters", "2"), "iters 5 -> 2"),
)


def phase_scripts(tmp: pathlib.Path) -> dict:
    """16: every script module's ``main`` on the card with its gates (module
    docstring); returns the launches by kernel row."""
    import importlib

    torch.cuda.synchronize()
    F.launches = D.launches = D.place_launches = R.launches = G.launches = RG.launches = 0
    MS.launches = 0
    walls, docs = {}, {}
    t_all = time.perf_counter()
    for name, args, cut in SCRIPT_RUNS:
        mod = importlib.import_module(f"tpu80211_torch.bench.{name}")
        out = tmp / f"{name}.json"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([*args, "--out", str(out)])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"bench.{name} {' '.join(args)}: exit code {rc}")
        docs[name] = json.loads(out.read_text())
        print(f"phase 16: {name} {' '.join(args)} ({cut}), {walls[name]:.1f} s: "
              f"{buf.getvalue().strip().splitlines()[-1]}", flush=True)
    torch.cuda.synchronize()
    launches = {"fused_chain": F.launches, "detect": D.launches, "place": D.place_launches,
                "raw_chain": R.launches, "gen_chain": G.launches, "raw_gen_chain": RG.launches,
                "mmse_solve": MS.launches}
    for k, n in launches.items():
        check(n > 0, f"phase 16 launched no {k} kernel")
    stream = docs["stream"]["rows"]
    check(set(stream) == set(S.GENERATORS), f"stream rows {sorted(stream)}")
    check("card_world_of_one" in docs["scaling"], "scaling: no world of one on the card")
    print(f"phase 16: {card()}")
    print(f"phase 16 ok: {len(SCRIPT_RUNS)} script modules gated and run on the card in "
          f"{time.perf_counter() - t_all:.1f} s; stream idle shares "
          f"{ {g: r['idle_share'] for g, r in stream.items()} }; launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all([_build.CSRC / f"{name}.cu" for name in KERNELS])
    print(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    cap = load_capture()
    phase_small(cap, dev)
    small_errs = phase_small_raw(cap, dev)
    small_errs.update(phase_small_gen(cap, dev))
    solve_errs = phase_small_solve(dev)
    launches, max_abs, main_in = phase_main(cap, dev)
    k_ms, p_ms = phase_timing(*main_in, dev)
    raw_launches, raw_errs, raw_in = phase_raw(cap, dev)
    t = phase_raw_timing(raw_in, main_in, dev)
    gen_launches, gen_errs, gen_in = phase_gen(cap, dev)
    t.update(phase_gen_timing(gen_in, dev))
    solve_launches, errs9 = phase_solve(cap, dev)
    solve_t, solve_lower = phase_solve_timing(dev)
    phase_bench(dev)
    phase_host_stream(dev)
    phase_native_fused(dev)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_launches = [phase_mesh_one(cap, dev, pathlib.Path(tmp)), phase_mesh_two(pathlib.Path(tmp))]
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = phase_cli(dev, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        script_launches = phase_scripts(pathlib.Path(tmp))
    launches += cli_launches["fused_chain"] + script_launches["fused_chain"]
    for k in ("place", "raw_chain"):
        raw_launches[k] += cli_launches[k] + script_launches[k]
    raw_launches["detect"] += script_launches["detect"]
    for k in ("gen_chain", "raw_gen_chain"):
        gen_launches[k] += cli_launches[k] + script_launches[k]
    solve_launches["mmse_solve"] += script_launches["mmse_solve"]
    for k in ("gen_chain", "raw_gen_chain"):
        gen_launches[k] += sum(m[k] for m in mesh_launches)
    solve_launches["mmse_solve"] += sum(m["mmse_solve"] for m in mesh_launches)
    lower = bounds(main_in, raw_in, gen_in, dev)
    # the solve rows at the main path's shape and method (gauss, the
    # default of sc.ps_mmse_dense and of the dense_pallas solver); the bound
    # is the least work that computes z, over both methods: LL^H, since the
    # systems are Hermitian positive definite
    for entry, row in SOLVE_ROW.items():
        t[row] = solve_t[entry, "gauss", S_MAIN]
        lower[row] = min((solve_lower[entry, m, S_MAIN] for m in MS.METHODS), key=lambda b: b[0])
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
        ("gen_chain", "gen_chain.cu", "tpu80211/kernels/gen_chain.py:115",
         gen_launches["gen_chain"], max(small_errs["gen_chain"], gen_errs["gen_chain"]),
         t["gen_chain"]),
        ("raw_gen_chain", "raw_gen_chain.cu", "tpu80211/kernels/raw_gen_chain.py:65",
         gen_launches["raw_gen_chain"], max(small_errs["raw_gen_chain"], gen_errs["raw_gen_chain"]),
         t["raw_gen_chain"]),
        ("mmse_solve", "mmse_solve.cu", "tpu80211/kernels/mmse_solve.py:651",
         solve_launches["mmse_solve"], max(solve_errs["mmse_solve"], errs9["mmse_solve"]),
         t["mmse_solve"]),
        ("mmse_solve_dense", "mmse_solve.cu", "tpu80211/kernels/mmse_solve.py:759",
         solve_launches["mmse_solve_dense"],
         max(solve_errs["mmse_solve_dense"], errs9["mmse_solve_dense"]), t["mmse_solve_dense"]),
    ]
    # torch.linalg.solve on the materialized systems computes the solves (for
    # the fused row without building them); no single PyTorch call computes
    # the other functions, whose library_ms is null
    library = {row: solve_t["library", S_MAIN] for row in SOLVE_ROW.values()}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": lower[name][0], "bound_by": lower[name][1], "library_ms": library.get(name),
    } for name, source, replaces, n, err, (ms, plain_ms) in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
