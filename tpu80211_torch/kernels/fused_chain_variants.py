"""What each part of the chain body costs on the card: build variants of
``csrc/chain.cuh`` (and of ``csrc/fused_chain.cu``) and time them beside the
kernel as it is.

    python -m tpu80211_torch.kernels.fused_chain_variants [--parent DIR]

A variant is the source with text replaced (``OLD -> NEW``; ``_variants``
builds and times them).  Most variants give wrong results on purpose: the
time a variant saves is what the removed part costs.  ``DIAGNOSTICS`` edit
the body as it is (the DFT on the tensor cores):

* ``no_dft``: the products' accumulators are never fed; the operands are
  still read (a bitwise OR keeps them live): the price of the MMAs;
* ``no_twiddle_loads``: the twiddle fragments are a per-thread constant:
  the price of their ldmatrix reads;
* ``no_stage``: no device-memory reads of the preamble or the packet (the
  copies zero-fill the window): the price of the loads, but zero spectra
  send the f32 divisions of LT-LS and the equalizer down their slow path;
* ``cached_rows``: every packet window reads block 0's rows again (from L2
  after the first, samples as real as before): the price of the packet's
  device-memory traffic (the parent's variant read the packet's first row
  for every row, through L1);
* ``no_eq_division``: the equalizer multiplies by the blended estimate
  instead of dividing by it (14 f32 divisions a thread a window): the
  price of the divisions;
* ``no_eq_stores`` and ``no_h_stores``: the equalized blocks, or the h
  planes, are not written;
* ``no_second_pass``: the equalizer skips blocks 0..3 (and with them the
  four windows transformed again);
* ``no_ring`` (``fused_chain.cu``): aligned rows are staged by each thread
  (its own frame's rows, through registers) instead of in 16-byte runs
  (for bf16 without sync, the cp.async ring).

``PARENT_DIAGNOSTICS`` price the parent's derotation (one f64 library
sincos a derotated sample), run with ``--parent DIR``, a directory that
holds that body's ``fused_chain.cu``, ``raw_chain.cu`` and ``chain.cuh``:

* ``f32_sincos``: cos and sin by ``__sincosf`` on the f32 angle (wrong
  bits, the same data path);
* ``no_sincos``: cos = 1, sin = 0.

``TREE_DIAGNOSTICS`` put the tree's derotation (phase factors, the guard)
to the same questions:

* ``library_sincos``: every derotated sample's cos and sin from the library
  again, as the parent took them (its outputs are the tree's bit for bit;
  the card tests build it as the kernels' twin);
* ``count_fallbacks``: counts the library's sincos calls of one sync call at
  each shape, phase factors and the guard's fallbacks apart, and prints
  them a frame and a derotated sample.

Each variant is timed through ``fused_chain`` at the main path's shape,
B = 65,536 bf16 tx-constant (the capture's rx frame under a random phase
and AWGN at SNR 30 per frame), in per-frame-tx mode at B = 32,768 (the
same frames as tx and rx), and with ``sync`` at B = 65,536 on the same
frames turned by a 20 kHz CFO (1e-3 cycles a sample).  The derotation's
variants (``SINCOS``) are also built into ``raw_chain.cu`` and timed
through ``raw_chain`` with ``sync`` at B = 32,768 streams of 2,048 samples
(``detect_variants``' streams, the frame turned by the same CFO), decimate
16.  Prints the card, nvcc's registers and spill stores per instantiation,
the attributes of every ``sync`` instantiation of both kernels as built,
the kernel's attributes where the build has them, and ms per call (CUDA
events, median of 5 runs of 10 calls).  Needs a CUDA card and nvcc; the
builds go to a temporary directory.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import numpy as np
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import _build, _ffi, _variants
from tpu80211_torch.kernels import detect_variants as DV
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import raw_chain as R

HEADER = "chain.cuh"
SOURCE = _build.CSRC / "fused_chain.cu"
RAW_SOURCE = _build.CSRC / "raw_chain.cu"
B, B_FRAMES, SEED, SNR_DB, CFO = 65536, 32768, 0, 30.0, 1e-3

_LTS_READ = "    if (live) {\\n      const long long i1 = (lp_base + LTS0 + n) * batch + f;"
_LTS_SKIP = "    if (false) {\\n      const long long i1 = (lp_base + LTS0 + n) * batch + f;"
_EQ_STORE = "if (live && eq_re != nullptr) { -> if (false) {"
_H_STORE = "  if (live && p.h[2 * which] != nullptr) { ->   if (false) {"
# the parent's library sincos of each derotated sample (the tree keeps these
# lines as its guard's fallback)
_LIBRARY_SINCOS = ("  double sd, cd;\\n  sincos(static_cast<double>(ang), &sd, &cd);\\n"
                   "  const float sn = static_cast<float>(sd), cs = static_cast<float>(cd);")

DIAGNOSTICS = {
    "no_dft": (
        "      mma_bf16(acc1[2 * np], wr, ba[0], ba[1]);\\n"
        "      mma_bf16(acc1[2 * np + 1], wr, ba[2], ba[3]);\\n"
        "      mma_bf16(acc2[2 * np], wi, bb[0], bb[1]);\\n"
        "      mma_bf16(acc2[2 * np + 1], wi, bb[2], bb[3]); -> "
        "      acc1[2 * np][0] = __uint_as_float(__float_as_uint(acc1[2 * np][0]) | ba[0] | ba[1] "
        "| ba[2] | ba[3] | bb[0] | bb[1] | bb[2] | bb[3] | wr[0] | wr[1] | wr[2] | wr[3] | wi[0] "
        "| wi[1] | wi[2] | wi[3]);"),
    "no_twiddle_loads": (
        "    ldsm_x4(wr, &tw[0][m][8 * chunk]);\\n    ldsm_x4(wi, &tw[1][m][8 * chunk]); -> "
        "    wr[0] = wr[1] = wr[2] = wr[3] = 0x3f803f80u + m;\\n"
        "    wi[0] = wi[1] = wi[2] = wi[3] = 0x3e803e80u + m + chunk;"),
    "no_stage": (
        f"{_LTS_READ} -> {_LTS_SKIP} ;; "
        "        const int bytes = fc < batch ? 16 : 0; -> "
        "        const int bytes = 0 * (fc < batch); ;; "
        "        return fc < batch ? *reinterpret_cast<const Run*>(src) : Run{}; -> "
        "        return false ? *reinterpret_cast<const Run*>(src) : Run{}; ;; "
        "      if (live) {\\n        const long long idx = (pkt_base + row0 -> "
        "      if (false) {\\n        const long long idx = (pkt_base + row0"),
    "cached_rows": (
        "        const long long row = (side ? 0 : pkt_base) + row0 + n; -> "
        "        const long long row = (side ? 0 : pkt_base) + N_CP + n; ;; "
        "        const long long idx = (pkt_base + row0 + g + GROUPS * r) * batch + f; -> "
        "        const long long idx = (pkt_base + N_CP + g + GROUPS * r) * batch + f;"),
    "no_eq_division": (
        "        e[j] = cdiv(rb[j], hu);  // no zero guard, as the TPU kernel -> "
        "        e[j] = make_float2(rb[j].x * hu.x - rb[j].y * hu.y, rb[j].x * hu.y + rb[j].y * hu.x);"),
    "no_eq_stores": _EQ_STORE,
    "no_h_stores": _H_STORE,
    "no_second_pass": (
        "  for (int i = N_AVG; i < N_WINDOWS; ++i) { ->   for (int i = 2 * N_AVG; i < N_WINDOWS; ++i) {"),
}
SOURCE_DIAGNOSTICS = {
    "no_ring": (
        "    if (rows_aligned(p, TX_CONST)) return -> "
        "    if (false && rows_aligned(p, TX_CONST)) return"),
}
PARENT_DIAGNOSTICS = {
    "f32_sincos": f"{_LIBRARY_SINCOS} ->   float sn, cs;\\n  __sincosf(ang, &sn, &cs);",
    "no_sincos": f"{_LIBRARY_SINCOS} ->   const float sn = 0.f, cs = 1.f;",
}
# library_sincos (tree): neither test ever vouches, so every derotated
# sample's cos and sin come from the library, as the parent took them (its
# outputs are the tree's bit for bit);
# count_fallbacks (tree): every block counts its library sincos calls in
# shared memory, phase factors and the guard's fallbacks apart, and adds
# them to a device counter with one atomic each at its end;
# chain_library_calls copies the two counts out and zeroes them
_COUNTERS = (
    "__device__ unsigned long long library_calls[2];  // factors, fallbacks\\n"
    "__shared__ unsigned int block_calls[2];\\n")
_READ_COUNTERS = (
    'extern \"C\" int chain_library_calls(unsigned long long* out) {\\n'
    "  cudaError_t err = cudaMemcpyFromSymbol(out, chain::library_calls, sizeof(chain::library_calls));\\n"
    "  const unsigned long long zero[2] = {0, 0};\\n"
    "  if (err == cudaSuccess) err = cudaMemcpyToSymbol(chain::library_calls, zero, sizeof(zero));\\n"
    "  return err;\\n"
    "}\\n")
TREE_DIAGNOSTICS = {
    "library_sincos": (
        "    sure = false;\\n  return r;\\n} ->     sure = false;\\n  sure = false;\\n  return r;\\n} ;; "
        "  if (fabsf(ang) < SMALL_ANGLE) return true;\\n ->   return false;\\n"),
    "count_fallbacks": (
        f"namespace chain {{\\n\\nconstexpr int N_SC -> namespace chain {{\\n\\n{_COUNTERS}constexpr int N_SC ;; "
        "float2 library_cis(float ang) {\\n -> "
        "float2 library_cis(float ang) {\\n  atomicAdd(&block_calls[1], 1u);\\n ;; "
        "double2 factor(double x) {\\n -> double2 factor(double x) {\\n  atomicAdd(&block_calls[0], 1u);\\n ;; "
        "\\n  issue(0);\\n -> \\n  if (threadIdx.x < 2) block_calls[threadIdx.x] = 0u;\\n  issue(0);\\n ;; "
        "  s.red[g][1][lane] = evm;\\n  __syncthreads();\\n -> "
        "  s.red[g][1][lane] = evm;\\n  __syncthreads();\\n"
        "  if (threadIdx.x < 2) atomicAdd(&library_calls[threadIdx.x], block_calls[threadIdx.x]);\\n ;; "
        f"}}  // namespace chain\\n -> }}  // namespace chain\\n\\n{_READ_COUNTERS}"),
}
# count_fallbacks' reader (unsigned long long out[2]), an export it adds
COUNTERS_EXPORT = {"chain_library_calls": (_ffi.PTR,)}
# derotated samples a frame: the two LTS repeats, then 19 windows of 64
DEROTATED = 2 * 64 + 19 * 64
# the variants built into raw_chain.cu as well
SINCOS = ("as_is", *PARENT_DIAGNOSTICS, *TREE_DIAGNOSTICS)


def main_frames(dev, cfo: float = 0.0) -> tuple[Cplx, Cplx]:
    """B frames in bf16 on the card: the capture's rx packet and preamble
    under one random phase per frame plus AWGN at SNR_DB (chip_smoke.py's
    main path, built with torch's generator); ``cfo`` (cycles a sample)
    turns each frame by exp(2πi·cfo·n), n from the preamble's first sample."""
    cap = load_capture()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rot = torch.polar(torch.ones(B, device=dev), torch.rand(B, generator=gen, device=dev) * 2 * np.pi)

    def frames(x: np.ndarray, n0: int) -> Cplx:
        x = x * np.exp(2j * np.pi * cfo * (n0 + np.arange(x.size)))
        x = torch.tensor(x, dtype=torch.complex64, device=dev)
        noise = torch.randn((x.shape[0], B), generator=gen, device=dev, dtype=torch.complex64)
        y = x[:, None] * rot[None, :] + (x.abs().square().mean() / 10 ** (SNR_DB / 10)).sqrt() * noise
        return Cplx(y.real.to(torch.bfloat16).contiguous(), y.imag.to(torch.bfloat16).contiguous())

    return frames(cap.rx_packet, cap.rx_lptot.size), frames(cap.rx_lptot, 0)


def variants(parent: bool) -> tuple[dict, dict]:
    """(fused_chain.cu's variants, raw_chain.cu's): name → edits, for the
    tree or, with ``parent``, for the parent's body."""
    header = PARENT_DIAGNOSTICS if parent else {**DIAGNOSTICS, **TREE_DIAGNOSTICS}
    fused = {"as_is": "", **{n: {HEADER: e} for n, e in header.items()},
             **({} if parent else SOURCE_DIAGNOSTICS)}
    return fused, {n: e for n, e in fused.items() if n in SINCOS}


def sync_attributes(lib, raw_lib) -> list[str]:
    """The attributes of every ``sync`` instantiation of both kernels."""
    lines = []
    for storage in (torch.float32, torch.bfloat16, torch.int8):
        for tx_const in (True, False) if storage != torch.int8 else (True,):
            for evm in (False, True):
                for aligned in (False, True):
                    at = F.kernel_attributes(storage, tx_const, True, evm, aligned, lib=lib)
                    lines.append(f"fused_chain sync {storage} tx_const={tx_const} evm={evm} "
                                 f"aligned={aligned}: {at}")
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for sums in (False, True):
            at = R.kernel_attributes(dtype, True, sums, decimate=16, lib=raw_lib)
            lines.append(f"raw_chain sync {dtype} stream_sums={sums} decimate=16: {at}")
    return lines


def library_calls(lib, run, frames: int, tag: str) -> str:
    """One call of ``run`` on count_fallbacks' build ``lib``: its library
    sincos calls a frame and the guard's fallbacks a derotated sample."""
    counts = torch.zeros(2, dtype=torch.int64)
    lib.chain_library_calls(counts.data_ptr())  # zero them
    run()
    torch.cuda.synchronize()
    lib.chain_library_calls(counts.data_ptr())
    factors, fallbacks = counts.tolist()
    return (f"{tag}: library sincos {(factors + fallbacks) / frames:.4f} a frame "
            f"({factors / frames:.4f} phase factors, {fallbacks / frames:.6f} fallbacks); "
            f"fallback share {fallbacks / (frames * DEROTATED):.3e} of {DEROTATED} derotated "
            "samples a frame")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("fused_chain_variants: no CUDA device", file=sys.stderr)
        return 1
    if argv and (len(argv) != 2 or argv[0] != "--parent"):
        print("fused_chain_variants takes no arguments but --parent DIR", file=sys.stderr)
        return 2
    parent = bool(argv)
    root = pathlib.Path(argv[1]) if parent else _build.CSRC
    dev = torch.device("cuda", 0)
    print(_variants.card())
    cap = load_capture()
    txc = F.tx_spectra(*(Cplx(*(torch.tensor(v, dtype=torch.float32, device=dev).contiguous()
                                for v in (a.real, a.imag))) for a in (cap.tx_packet, cap.tx_lptot)))
    lts = Cplx(*(torch.tensor(v.copy(), dtype=torch.float32, device=dev)
                 for v in (cap.tx_lptot[-64:].real, cap.tx_lptot[-64:].imag)))
    consts = F.chain_consts(dev)
    pk, lp = main_frames(dev)
    pk2, lp2 = (c.map(lambda t: t[:, :B_FRAMES].contiguous()) for c in (pk, lp))
    tx2 = F.TxFrames(pk2, lp2)
    spk, slp = main_frames(dev, CFO)
    x = DV.streams(dev, CFO)
    fused, raw = variants(parent)
    tag = "parent" if parent else "tree"
    with tempfile.TemporaryDirectory() as tmp:
        built = _variants.build(root / SOURCE.name, fused, pathlib.Path(tmp) / "fused_chain")
        raw_built = _variants.build(root / RAW_SOURCE.name, raw, pathlib.Path(tmp) / "raw_chain")
        for kind, libs in (("fused_chain", built), ("raw_chain", raw_built)):
            for name, (_, regs, spills) in libs.items():
                print(f"{tag} {kind} {name}: registers {regs}, spill stores {spills} "
                      "(instantiations in nvcc's order)")
        libs = {name: F.LIB.at(path, **COUNTERS_EXPORT) for name, (path, _, _) in built.items()}
        raw_libs = {name: R.LIB.at(path, **COUNTERS_EXPORT)
                    for name, (path, _, _) in raw_built.items()}
        print("\n".join(f"{tag} as_is {line}"
                        for line in sync_attributes(libs["as_is"], raw_libs["as_is"])))
        for name, lib in libs.items():
            def run(rp=pk, rl=lp, tx=txc, sync=False, lib=lib):
                return F._launch(rp, rl, tx, consts, 0.0, 1.0, False,
                                 "h_mmse" if sync else "h_linear", sync, False, lib=lib)

            ms = _variants.time_ms(run)
            ms_frames = _variants.time_ms(lambda: run(pk2, lp2, tx2))
            ms_sync = _variants.time_ms(lambda: run(spk, slp, sync=True))
            print(f"{tag} {name}: B={B} bf16 tx-const {ms:.4f} ms; B={B_FRAMES} per-frame tx "
                  f"{ms_frames:.4f} ms; B={B} sync {ms_sync:.4f} ms; "
                  f"{F.kernel_attributes(sync=True, lib=lib)}", flush=True)
            if name == "count_fallbacks":
                print(library_calls(lib, lambda: run(spk, slp, sync=True), B,
                                    f"{tag} fused_chain {name}"))
        for name, lib in raw_libs.items():
            def run_raw(lib=lib):
                return R._launch(x, lts, *txc, None, 192, 4, 0.0, True, False, None, None, 1.0,
                                 False, "h_mmse", 16, lib=lib)

            got = run_raw()
            print(f"{tag} raw_chain {name}: B={B_FRAMES} x {DV.NS} sync {_variants.time_ms(run_raw):.4f}"
                  f" ms; detected {int(got['detected'].sum())} of {B_FRAMES}; "
                  f"{R.kernel_attributes(sync=True, stream_sums=False, decimate=16, lib=lib)}",
                  flush=True)
            if name == "count_fallbacks":
                print(library_calls(lib, run_raw, B_FRAMES, f"{tag} raw_chain {name}"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
