"""What each part of the generative raw kernel and of the placement kernel
costs on the card: build variants of ``csrc/raw_gen_chain.cu`` and
``csrc/detect.cu`` and time them beside the kernels as they are.

    python -m tpu80211_torch.kernels.raw_gen_chain_variants

A variant is the source with text replaced (``OLD -> NEW``; ``_variants``
builds and times them).  Most variants give wrong results on purpose: the
time a variant saves is what the removed part costs.  ``DIAGNOSTICS`` edit
``raw_gen_chain.cu``:

* ``no_field_stores``: the field's rows are computed but not stored (a
  store guarded by a value no sample takes);
* ``no_compact_stores``: the frame's distinct samples are computed but not
  stored in the compact scratch;
* ``no_frame_staging``: the compact frames are not copied into shared
  memory before the field pass;
* ``no_frame_reads``: a frame row takes a constant sample (1 + 1j) in place
  of its read from shared memory;
* ``no_noise_draws``: each row's noise is a cheap integer hash of (stream,
  row) made uniform, in place of the Philox call and the f64 Box-Muller
  pair (the price of drawing the noise, and so of drawing it again
  wherever a row is read);
* ``no_box_muller``: the Philox words made uniform, without Box-Muller;
* ``no_idft``: each symbol sample from one bin, not 53 (a constant or zero
  frame would change what detection finds, and so its time);
* ``synthesis_only``: the kernel returns after the synthesis.

``PLACE_DIAGNOSTICS`` edit ``detect.cu``'s placement kernel:

* ``unshifted``: every stream reads its own row of the staged strip, not
  the row its offset shifts it to (the price of the shifted reads);
* ``no_staging``: the strip is not copied into shared memory (the price of
  the copy);
* ``unstaged``: every strip reads sig in place, as a stream too long to
  stage does (the price of not staging);
* ``deep_loads``, ``deep_rows``: 16 loads in flight a thread in the copy
  or in the row pass, where the kernel keeps 4 (bf16 sig).

The generative kernel runs at B = 32,768 streams, NS = 2,048, SNR 20,
h_mmse (``bench.py --genraw``); placement at the raw workload's B = 32,768,
NS = 2,048, bf16 signal and f32 noise, each variant timed through
``place_streams``' wrapper and by its launch alone (without the wrapper's
checks, which read ``offs`` back to the host).  Prints the card, nvcc's
registers and spill stores per instantiation, and ms per call (CUDA
events, median of 5 runs of 10 calls).  Needs a CUDA card and nvcc; the builds go to a
temporary directory.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import _build, _ffi, _variants
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import raw_gen_chain as RG

SOURCE = _build.CSRC / "raw_gen_chain.cu"
PLACE_SOURCE = _build.CSRC / "detect.cu"
B, NS, SEED = 32768, 2048, 7

DIAGNOSTICS = {
    "no_field_stores": (
        "        p.x_re[i] = x.x;\\n        p.x_im[i] = x.y; -> "
        "        if (x.x == 1e30f) {\\n          p.x_re[i] = x.x;\\n          p.x_im[i] = x.y;\\n"
        "        }"),
    "no_compact_stores": (
        "    dst[0] = make_uint4(w[0], w[1], w[2], w[3]); -> "
        "    if (w[0] == 0x7FC07FC0u) dst[0] = make_uint4(w[0], w[1], w[2], w[3]); ;; "
        "    dst[1] = make_uint4(w[4], w[5], w[6], w[7]); -> "
        "    if (w[4] == 0x7FC07FC0u) dst[1] = make_uint4(w[4], w[5], w[6], w[7]);"),
    "no_frame_staging": (
        "i += THREADS) dst[i] = src[i]; -> i += THREADS) {}"),
    "no_frame_reads": (
        "          const uint32_t b = frame_h[frame_sample(rel)]; -> "
        "          const uint32_t b = 0x3F803F80u;"),
    "no_noise_draws": (
        "    const uint4 w = gen::draw(key, stream, r, gen::NOISE);\\n"
        "    return gen::normal_pair(w.x, w.y, fs.ln); -> "
        "    uint32_t w = static_cast<uint32_t>(stream) * 0x9E3779B9u ^ static_cast<uint32_t>(r) * 0x85EBCA6Bu;\\n"
        "    w = (w ^ (w >> 15)) * 0x2C1B3C6Du;\\n"
        "    return make_float2(3.4641f * (gen::uniform(w) - 0.5f), 3.4641f * (gen::uniform(w << 8) - 0.5f));"),
    "no_box_muller": (
        "    return gen::normal_pair(w.x, w.y, fs.ln); -> "
        "    return make_float2(3.4641f * (gen::uniform(w.x) - 0.5f), 3.4641f * (gen::uniform(w.y) - 0.5f));"),
    "no_idft": "    for (int k = 0; k < N_SC; ++k) { ->     for (int k = 0; k < 1; ++k) {",
    "synthesis_only": (
        "  __syncthreads();  // the block's columns of the field are written; shared memory is free -> "
        "  return;"),
}
PLACE_DIAGNOSTICS = {
    "unshifted": "    int src = r - off; ->     int src = r + (off == -1);",
    "no_staging": "  if (STAGED) { ->   if (false) {",
    "unstaged": "  const int k = strip_log2(ns, sizeof(TS)); ->   const int k = -1;",
    "deep_loads": "LOAD_UNROLL = 4, ROW_UNROLL -> LOAD_UNROLL = 16, ROW_UNROLL",
    "deep_rows": "ROW_UNROLL = sizeof(TS) == 2 ? 4 : 16; -> ROW_UNROLL = 16;",
}


def _planes(x, dev) -> Cplx:
    return Cplx(*(torch.tensor(v, dtype=torch.float32, device=dev).contiguous()
                  for v in (x.real, x.imag)))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("raw_gen_chain_variants: no CUDA device", file=sys.stderr)
        return 1
    if argv:
        print("raw_gen_chain_variants takes no arguments", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(_variants.card())
    cap = load_capture()
    txc = F.tx_spectra(_planes(cap.tx_packet, dev), _planes(cap.tx_lptot, dev))
    lts = _planes(cap.tx_lptot[-64:], dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sig = Cplx(*(torch.randn(NS, B, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)))
    noise = Cplx(*(1e-4 * torch.randn(NS, B, generator=gen, device=dev) for _ in range(2)))
    offs = torch.randint(40, NS - 1400, (B,), generator=gen, device=dev, dtype=torch.int32)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        (out / "gen").mkdir()
        (out / "place").mkdir()
        built = _variants.build(SOURCE, {"as_is": "", **DIAGNOSTICS}, out / "gen")
        placed = _variants.build(PLACE_SOURCE, {"as_is": "", **PLACE_DIAGNOSTICS}, out / "place")
        for tag, libs in (("raw_gen_chain", built), ("detect", placed)):
            for name, (_, regs, spills) in libs.items():
                print(f"{tag} {name}: registers {regs}, spill stores {spills} "
                      "(instantiations in nvcc's order)")
        want = None
        for name, (path, _, _) in built.items():
            lib = RG.LIB.at(path)
            run = lambda: RG._launch(SEED, B, *txc, lts, NS, 20.0, None, 0.5, "h_mmse",  # noqa: E731
                                     0.0, False, lib=lib)
            got = run()
            want = want or got
            same = torch.equal(got["start"], want["start"])
            print(f"raw_gen_chain {name}: {_variants.time_ms(run):.4f} ms; detected "
                  f"{int(got['detected'].sum())} of {B}, starts {'==' if same else '!='} as_is",
                  flush=True)
        out = Cplx(torch.empty_like(sig.re), torch.empty_like(sig.im))
        for name, (path, _, _) in placed.items():
            lib = D.LIB.at(path)
            run = lambda: D._launch_place(sig, noise, offs, lib=lib)  # noqa: E731
            bare = lambda: _ffi.launch(lib.place_launch, [*sig, *noise, offs, *out],  # noqa: E731
                                       _ffi.STORAGE[torch.bfloat16], _ffi.STORAGE[torch.float32],
                                       NS, B)
            print(f"place {name}: {_variants.time_ms(run):.4f} ms through the wrapper, "
                  f"{_variants.time_ms(bare):.4f} ms the launch alone", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
