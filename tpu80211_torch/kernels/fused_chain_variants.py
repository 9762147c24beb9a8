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

``PARENT_DIAGNOSTICS`` are the same questions put to the body before the
tensor cores (each thread forming its bins on the CUDA cores from f32
twiddles, blocks 0..3 kept in registers), run with ``--parent DIR``, a
directory that holds that body's ``fused_chain.cu`` and ``chain.cuh``;
there ``no_rkeep`` equalizes blocks 0..3 from a fresh DFT instead of the 28
registers that keep their spectra.

Each variant is timed through ``fused_chain`` at the main path's shape,
B = 65,536 bf16 tx-constant (the capture's rx frame under a random phase
and AWGN at SNR 30 per frame), and in per-frame-tx mode at B = 32,768 (the
same frames as tx and rx).  Prints the card, nvcc's registers and spill
stores per instantiation, the kernel's attributes where the build has
them, and ms per call (CUDA events, median of 5 runs of 10 calls).  Needs
a CUDA card and nvcc; the builds go to a temporary directory.
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
from tpu80211_torch.kernels import fused_chain as F

HEADER = "chain.cuh"
SOURCE = _build.CSRC / "fused_chain.cu"
B, B_FRAMES, SEED, SNR_DB = 65536, 32768, 0, 30.0

_LTS_READ = "    if (live) {\\n      const long long i1 = (lp_base + LTS0 + n) * batch + f;"
_LTS_SKIP = "    if (false) {\\n      const long long i1 = (lp_base + LTS0 + n) * batch + f;"
_EQ_STORE = "if (live && eq_re != nullptr) { -> if (false) {"
_H_STORE = "  if (live && p.h[2 * which] != nullptr) { ->   if (false) {"

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
    "no_dft": (
        "        rr[j] = fmaf(w.x, xv.x, rr[j]);\\n"
        "        ii[j] = fmaf(w.y, xv.y, ii[j]);\\n"
        "        ri[j] = fmaf(w.x, xv.y, ri[j]);\\n"
        "        ir[j] = fmaf(w.y, xv.x, ir[j]); -> "
        "        rr[j] = __uint_as_float(__float_as_uint(rr[j]) | __float_as_uint(w.x) "
        "| __float_as_uint(w.y) | __float_as_uint(xv.x) | __float_as_uint(xv.y));"),
    "no_twiddle_loads": (
        "        const float2 w = s.w[n][k]; -> "
        "        const float2 w = make_float2(0.5f * k, 0.25f + k);"),
    "no_stage": (
        f"{_LTS_READ} -> {_LTS_SKIP} ;; "
        "    if (live) {\\n      const long long idx = (base + row0 + n) * batch + f; -> "
        "    if (false) {\\n      const long long idx = (base + row0 + n) * batch + f;"),
    "cached_rows": (
        "      const long long idx = (base + row0 + n) * batch + f; -> "
        "      const long long idx = base * batch + f;"),
    "no_eq_stores": _EQ_STORE,
    "no_h_stores": _H_STORE,
    "no_rkeep": (
        "    equalize(b, rkeep[b], tb); -> "
        "    __syncthreads();\\n    stage_rx(b);\\n    __syncthreads();\\n"
        "    float2 rf[BINS];\\n    dft_bins(&s.xr[0][0], s, g, lane, p.scale, rf);\\n"
        "    equalize(b, rf, tb);"),
}


def main_frames(dev) -> tuple[Cplx, Cplx]:
    """B frames in bf16 on the card: the capture's rx packet and preamble
    under one random phase per frame plus AWGN at SNR_DB (chip_smoke.py's
    main path, built with torch's generator)."""
    cap = load_capture()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rot = torch.polar(torch.ones(B, device=dev), torch.rand(B, generator=gen, device=dev) * 2 * np.pi)

    def frames(x: np.ndarray) -> Cplx:
        x = torch.tensor(x, dtype=torch.complex64, device=dev)
        noise = torch.randn((x.shape[0], B), generator=gen, device=dev, dtype=torch.complex64)
        y = x[:, None] * rot[None, :] + (x.abs().square().mean() / 10 ** (SNR_DB / 10)).sqrt() * noise
        return Cplx(y.real.to(torch.bfloat16).contiguous(), y.imag.to(torch.bfloat16).contiguous())

    return frames(cap.rx_packet), frames(cap.rx_lptot)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("fused_chain_variants: no CUDA device", file=sys.stderr)
        return 1
    if argv and (len(argv) != 2 or argv[0] != "--parent"):
        print("fused_chain_variants takes no arguments but --parent DIR", file=sys.stderr)
        return 2
    parent = bool(argv)
    source = pathlib.Path(argv[1]) / SOURCE.name if parent else SOURCE
    dev = torch.device("cuda", 0)
    print(_variants.card())
    cap = load_capture()
    txc = F.tx_spectra(*(Cplx(*(torch.tensor(v, dtype=torch.float32, device=dev).contiguous()
                                for v in (a.real, a.imag))) for a in (cap.tx_packet, cap.tx_lptot)))
    consts = F.chain_consts(dev)
    pk, lp = main_frames(dev)
    pk2, lp2 = (c.map(lambda t: t[:, :B_FRAMES].contiguous()) for c in (pk, lp))
    tx2 = F.TxFrames(pk2, lp2)
    if parent:
        variants = {"as_is": "", **{n: {HEADER: e} for n, e in PARENT_DIAGNOSTICS.items()}}
    else:
        variants = {"as_is": "", **{n: {HEADER: e} for n, e in DIAGNOSTICS.items()},
                    **SOURCE_DIAGNOSTICS}
    tag = "parent" if parent else "tree"
    with tempfile.TemporaryDirectory() as tmp:
        built = _variants.build(source, variants, pathlib.Path(tmp))
        for name, (lib, regs, spills) in built.items():
            print(f"{tag} {name}: registers {regs}, spill stores {spills} "
                  "(instantiations in nvcc's order)")
        for name, (lib, _, _) in built.items():
            kernel = F.bind(lib)

            def run(rp=pk, rl=lp, tx=txc):
                return F._launch(rp, rl, tx, consts, 0.0, 1.0, False, "h_linear", False, False,
                                 kernel=kernel)

            ms = _variants.time_ms(run)
            ms_frames = _variants.time_ms(lambda: run(pk2, lp2, tx2))
            attrs = "" if parent else f"; {F.kernel_attributes(lib=lib)}"
            print(f"{tag} {name}: B={B} bf16 tx-const {ms:.4f} ms; B={B_FRAMES} per-frame tx "
                  f"{ms_frames:.4f} ms{attrs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
