"""What each part of the detection body costs on the card: build variants of
``csrc/detect.cuh`` (and of ``csrc/raw_chain.cu``) and time them beside the
kernels as they are.

    python -m tpu80211_torch.kernels.detect_variants

A variant is the source with text replaced (``OLD -> NEW``; ``_variants``
builds and times them).  Most variants give wrong results on purpose: the
time a variant saves is what the removed part costs.  ``DIAGNOSTICS`` edit
``detect.cuh``, the body that ``detect.cu``, ``raw_chain.cu`` and
``raw_gen_chain.cu`` share; each builds into ``detect.cu`` and
``raw_chain.cu``:

* ``no_mf_loads``: the matched filter's tiles multiply made-up fragments,
  rows and taps, in place of the staged ones (the price of its
  shared-memory reads and their conversions to f64, less the few integer
  to f64 conversions a K-step that make the fragments up);
* ``no_mf_convert``: the tiles read the staged rows but take their bits as
  made-up f64 values (the price of the conversions to f64);
* ``shared_rows``: every stream's window is lane 0's (the same rows, so
  the copy walks one window, not the union of 32): the price of the windows'
  spread;
* ``f32_mf``: the tiles' f64 products on the tensor cores become four f32
  FMAs a product on the CUDA cores, into f32 accumulators (the price of the
  f64 products; its results are wrong on purpose);
* ``no_copy``: the windows are not staged (the price of the copy);
* ``no_peak_scan``: the detected streams' peak metric is skipped;
* ``running_scan``: the sweep and the peak scans take a running window
  (each product added, then taken away) in place of block sums (the price
  of the running form);
* ``no_scan``: the sweep is skipped: lane l crosses at grid point
  2 + l mod 38, so the windows spread as the workload's do;
* ``full_sweep``: the sweep's stop vote is off: every block sweeps the
  whole grid, every stream to its end (the price of the grid past the
  block's last first crossing; its outputs are the tree's bit for bit);
* ``no_mf``: the matched filter's tiles are skipped.

Through ``raw_chain`` a variant that moves the starts also moves the rows
the chain reads (``lane0_chain_rows`` prices those), so its time there
prices more than the part it removes; ``detect`` alone has no such
confound.

Before the sweep, the threshold scan split the grid into 8 contiguous
ranges, one a warp, and every stream was scanned to its end; ``no_scan``
and ``running_scan`` asked the same questions of it.  The body before the
tensor-core matched filter (each thread summing runs of 8 offsets by f64
FMAs on the CUDA cores) took the same names for the same questions: ``no_mf_loads``
made-up rows, ``f32_mf`` f32 sums, ``no_mf`` no runs.  The body before it
(each lane reading its own window from device memory) was probed with
``no_mf_loads``, ``f32_mf``, ``no_peak_scan``, ``no_scan`` and ``no_mf``
as above, and ``shared_rows`` as every lane reading lane 0's window
(PERF.md §5); its scans took the running window.

``CHAIN_DIAGNOSTICS`` edit ``raw_chain.cu`` alone:

* ``lane0_chain_rows``: the chain reads every lane's frame at lane 0's rows
  (coalesced), which prices the chain's scattered loads.

Each variant is timed through ``detect_streams`` and through
``raw_rx_txconst_fused`` at ``bench.py --raw``'s shape: B = 32,768 bf16
streams of NS = 2,048 samples, the capture's frame at offsets in
[40, NS − 1,400) over 1e-4 AWGN, decimate 16, ``stream_sums``, h_mmse.
Prints the card, nvcc's registers and spill stores per instantiation, each
build's kernel attributes at that shape (bf16), and ms per call (CUDA
events, median of 5 runs of 10 calls), then ``swept_share`` of the
workload and of ``gen_raw_system``'s field (the Monte Carlo step: a 20 kHz
CFO, channel A) at 0, 10, 20, 30 and 40 dB.  Needs a CUDA card and nvcc;
the builds go to a temporary directory.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import numpy as np
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import _build, _variants
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.kernels import raw_gen_chain as RG

HEADER = "detect.cuh"
SOURCES = {"detect": _build.CSRC / "detect.cu", "raw_chain": _build.CSRC / "raw_chain.cu"}
B, NS, SEED, NOISE = 32768, 2048, 0, 1e-4

DIAGNOSTICS = {
    "no_mf_loads": (
        "    const double2 a0 = unpack(xa[k]), a1 = unpack(xa[k + LAG]);\n"
        "    const double2 b = hb[k]; -> "
        "    const double2 a0 = make_double2(0.25 * k, 0.5 - 0.125 * g), "
        "a1 = make_double2(0.125 * t, 0.25 * k);\n"
        "    const double2 b = make_double2(0.5 * k - t, 1.0 - g);"),
    "no_mf_convert": (
        "// |MF| at the MF_ITEM offsets -> "
        "__device__ __forceinline__ double2 bits_of(float2 v) {\n"
        "  return make_double2(__hiloint2double(__float_as_int(v.y), __float_as_int(v.x)),\n"
        "                      __hiloint2double(__float_as_int(v.x), __float_as_int(v.y)));\n}\n"
        "__device__ __forceinline__ double2 bits_of(__nv_bfloat162 v) {\n"
        "  const int w = *reinterpret_cast<const int*>(&v);\n"
        "  return make_double2(__hiloint2double(w, w), __hiloint2double(w, ~w));\n}\n"
        "__device__ __forceinline__ double2 bits_of(char2 v) {\n"
        "  const int w = *reinterpret_cast<const short*>(&v);\n"
        "  return make_double2(__hiloint2double(w, w), __hiloint2double(w, -w));\n}\n\n"
        "// |MF| at the MF_ITEM offsets ;; "
        "    const double2 a0 = unpack(xa[k]), a1 = unpack(xa[k + LAG]); -> "
        "    const double2 a0 = bits_of(xa[k]), a1 = bits_of(xa[k + LAG]);"),
    "shared_rows": (
        "  if (g == 0) {\n    const int i_end -> "
        "  const int coarse_w = __shfl_sync(0xffffffffu, coarse, 0);\n"
        "  if (g == 0) {\n    const int coarse = coarse_w;\n    const int i_end"),
    "f32_mf": (
        "  using Acc = double; ->   using Acc = float; ;; "
        "// |MF| at the MF_ITEM offsets -> "
        "__device__ __forceinline__ void mma_f64(float (&d)[4], double a0, double a1, double b) {\n"
        "  const float x0 = a0, x1 = a1, y = b;\n"
        "  d[0] = fmaf(x0, y, d[0]);\n  d[1] = fmaf(x0, -y, d[1]);\n"
        "  d[2] = fmaf(x1, y, d[2]);\n  d[3] = fmaf(x1, -y, d[3]);\n}\n\n"
        "// |MF| at the MF_ITEM offsets"),
    "no_copy": (
        "r0 < r_hi; r0 += COPY_UNROLL * step) { -> r0 < 0 * r_hi; r0 += COPY_UNROLL * step) {"),
    "no_peak_scan": (
        "    if (t < gs * WARPS)\n      s.pk[t] -> "
        "    if (false)\n      s.pk[t]"),
    "running_scan": (
        "  switch (stride) {\\n    case 16: -> "
        "  switch (0) {\\n    case 16: ;; "
        "    switch (st) {\\n      case 16: r = sweep<4> -> "
        "    switch (0) {\\n      case 16: r = sweep<4>"),
    "no_scan": (
        "    Scan r;\\n    switch (st) { -> "
        "    Scan r{g == 0 ? 2 + static_cast<int>(f % 38) : nm, 0.0};\\n    if (false) switch (st) {"),
    "full_sweep": (
        "    if (hits == FULL) break;\\n    active = live && !(hits >> lane & 1u); -> "
        "    (void)hits;"),
    "no_mf": "        if (q0 >= n) continue; ->         if (q0 >= 0 * n) continue;",
}
CHAIN_DIAGNOSTICS = {
    "lane0_chain_rows": (
        "  const long long row0 = detect::frame_row(r, p.det_cfg.ns); -> "
        "  const long long row0 = __shfl_sync(0xffffffffu, detect::frame_row(r, p.det_cfg.ns), 0);"),
}


def streams(dev, cfo: float = 0.0) -> Cplx:
    """The raw workload: the capture's frame placed at seeded offsets in
    [40, NS − 1,400) of every stream over AWGN, bf16 (placed by the plain
    version, so no kernel under test makes its own input); ``cfo`` (cycles
    a sample) turns the frame by exp(2πi·cfo·n) from its first sample."""
    cap = load_capture()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    frame = frame * np.exp(2j * np.pi * cfo * np.arange(frame.size))
    sig = Cplx(*(torch.zeros((NS, B), dtype=torch.bfloat16, device=dev) for _ in range(2)))
    for plane, part in zip(sig, (frame.real, frame.imag)):
        plane[:frame.size] = torch.tensor(part, dtype=torch.float32, device=dev)[:, None]
    noise = Cplx(*(NOISE * torch.randn((NS, B), generator=gen, device=dev) for _ in range(2)))
    offs = torch.randint(40, NS - 1400, (B,), generator=gen, device=dev, dtype=torch.int32)
    return D.place_plain(sig, noise, offs)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("detect_variants: no CUDA device", file=sys.stderr)
        return 1
    if argv:
        print("detect_variants takes no arguments", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(_variants.card())
    cap = load_capture()
    txc = F.tx_spectra(*(Cplx(*(torch.tensor(v, dtype=torch.float32, device=dev).contiguous()
                                for v in (a.real, a.imag))) for a in (cap.tx_packet, cap.tx_lptot)))
    lts = Cplx(*(torch.tensor(v.copy(), dtype=torch.float32, device=dev)
                 for v in (cap.tx_lptot[-64:].real, cap.tx_lptot[-64:].imag)))
    x = streams(dev)
    header_variants = {"as_is": "", **{name: {HEADER: e} for name, e in DIAGNOSTICS.items()}}
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        built = {tag: _variants.build(src, {**header_variants, **(
                     CHAIN_DIAGNOSTICS if tag == "raw_chain" else {})}, out / tag)
                 for tag, src in SOURCES.items()}
        for tag, libs in built.items():
            for name, (_, regs, spills) in libs.items():
                print(f"{tag} {name}: registers {regs}, spill stores {spills} "
                      "(instantiations in nvcc's order)")
        want = None
        for name, (path, _, _) in built["detect"].items():
            lib = D.LIB.at(path)
            run = lambda: D._launch_detect(x, lts, D.DEFAULT_THRESHOLD, 192, 4, 16,  # noqa: E731
                                           False, lib=lib)
            got = run()
            want = want or got
            same = torch.equal(got.start, want.start)
            print(f"detect {name}: {_variants.time_ms(run):.4f} ms; detected "
                  f"{int(got.detected.sum())} of {B}, starts {'==' if same else '!='} as_is; "
                  f"{D.detect_attributes(torch.bfloat16, lib=lib)}", flush=True)
        want = None
        for name, (path, _, _) in built["raw_chain"].items():
            lib = R.LIB.at(path)
            run = lambda: R._launch(x, lts, *txc, None, 192, 4, 0.0, False, False,  # noqa: E731
                                    None, None, 1.0, True, "h_mmse", 16, lib=lib)
            got = run()
            want = want or got
            same = torch.equal(got["start"], want["start"])
            print(f"raw_chain {name}: {_variants.time_ms(run):.4f} ms; detected "
                  f"{int(got['detected'].sum())} of {B}, starts {'==' if same else '!='} as_is; "
                  f"{R.kernel_attributes(lib=lib)}", flush=True)
    det = D.detect_streams(x, lts, decimate=16)
    print(f"swept_share workload: {swept_share(det['detected'], det['coarse'], 16, NS):.4f}")
    for snr in (0.0, 10.0, 20.0, 30.0, 40.0):
        field = RG.gen_raw_system(SEED, B, *txc, lts, NS, snr, "A", cfo_khz=20.0,
                                  equalize_with="h_mmse", return_field=True)["field"]
        det = D.detect_streams(field, lts, decimate=16)
        print(f"swept_share gen_raw_system {snr:g} dB: "
              f"{swept_share(det['detected'], det['coarse'], 16, NS):.4f}; detected "
              f"{int(det['detected'].sum())} of {B}", flush=True)
    return 0


def swept_share(detected, coarse, stride: int, ns: int) -> float:
    """The share of every stream's NS − 64 lag products that detection's
    sweep takes, from the detection rows alone (``detect.cuh``, phase 1):
    per block of 32 streams, the tiles of 8·max(1, 64/stride) grid points up
    to the one that holds the block's last first crossing, or every tile
    where a stream is undetected; P points span products [0, (P − 1)·stride
    + 64).  ``coarse`` is the crossing itself at full resolution (stride 1)
    and (crossing − 1)·stride when decimated, where 0 stands for crossing 0
    or 1, which share a tile."""
    det = torch.as_tensor(detected).to("cpu", torch.bool)
    coarse = torch.as_tensor(coarse).to("cpu", torch.int64)
    nm = (ns - 64) // stride - 64 // stride + 1
    tile = 8 * (1 if stride >= 16 else 64 // stride)
    cross = torch.where(coarse > 0, coarse // stride + 1, 0) if stride > 1 else coarse
    n_prod = ns - 64
    taken = 0
    for b0 in range(0, det.numel(), 32):
        d, c = det[b0:b0 + 32], cross[b0:b0 + 32]
        points = nm if not bool(d.all()) else min(nm, (int(c.max()) // tile + 1) * tile)
        taken += min(n_prod, (points - 1) * stride + 64)
    return taken / (-(-det.numel() // 32) * n_prod)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
