"""What each part of the generative chain kernel costs on the card: build
variants of ``csrc/gen_chain.cu`` and of ``csrc/gen.cuh`` and time them
beside the kernel as it is.

    python -m tpu80211_torch.kernels.gen_chain_variants [--parent DIR]

A variant is the source with text replaced (``OLD -> NEW``; ``_variants``
builds and times them).  Most variants give wrong results on purpose: the
time a variant saves is what the removed part costs.  The diagnostics, for
the body as it is (``DIAGNOSTICS``) and for the body before it drew each
number once (``PARENT_DIAGNOSTICS``, run with ``--parent DIR``, a directory
that holds that body's ``gen_chain.cu``, ``gen.cuh`` and ``chain.cuh``):

* ``no_box_muller``: the normals are the two words made uniform (scaled to
  unit variance), without log, sqrt or sincos: the price of Box-Muller;
* ``f32_box_muller``: Box-Muller in f32 (``logf``, ``sqrtf``,
  ``sincosf``): what f32 normals would save (they are not the plain
  version's bit for bit);
* ``f64_no_log``, ``f64_no_sqrt``, ``f64_no_sincos``: one f64 function of
  Box-Muller each replaced by a cheap f64 stand-in;
* ``libm_box_muller`` (tree): Box-Muller with the CUDA library's f64 ``log``
  and ``sincos``, as the parent draws, in place of gen.cuh's table and
  series: what those save;
* ``no_philox``: the words are a counter hash (a few multiplies), not ten
  Philox rounds: the price of the generator;
* ``taps_once`` (parent): only warp 0 draws the taps, the other warps take
  constants: what drawing each tap once saves;
* ``no_block_redraw`` (parent): the estimation pass over blocks 0..3 takes
  tx H with no draw: what drawing those blocks twice costs;
* ``no_pilot_pass`` (tree): the 16 pilot pairs of blocks 0..3 are tx H
  with no draw, and the main pass draws them again: the price of drawing
  them in a pass of their own;
* ``no_divisions``: LT-LS and the equalizer multiply where they divide;
* ``no_stores``: neither the h planes nor eq are written (full mode);
* ``blocks3``: ``__launch_bounds__`` asks for 3 blocks per SM (at most 85
  registers), ``blocks1`` for 1: how far more or fewer warps an SM move it.

The noise and the windows stay nonzero in every variant: zero spectra
would send the chain's f32 divisions down their slow path.  Each variant
is timed through ``gen_chain._launch`` at the generative main path's
shape, B = 32,768 at SNR 20: stream mode with the legacy 8 taps and with
channel model E (16 taps), and full-output mode.  Prints the card, nvcc's
registers and spill stores per instantiation, the bf16 kernel's attributes
(``gen_chain_attributes``; ``PARENT_ATTRIBUTES`` adds it to the parent's
source for its builds),
and ms per call (CUDA events, median of 5 runs of 10 calls).  Needs a CUDA
card and nvcc; the builds go to a temporary directory.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import _build, _variants
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import gen_chain as G

HEADER = "gen.cuh"
SOURCE = _build.CSRC / "gen_chain.cu"
B, SEED, SNR_DB = 32768, 7, 20.0

_PHILOX_LOOP = "#pragma unroll\\n  for (int r = 0; r < 10; ++r) {"
_EQ_STORE = "      if (keep) {\\n        const long long idx"
_LAUNCH_BOUNDS = "__launch_bounds__(THREADS, 2) gen_chain_kernel"
_LT_DIVISION = ("(tp.x * r.x + tp.y * r.y) / d, (tp.x * r.y - tp.y * r.x) / d -> "
                "(tp.x * r.x + tp.y * r.y) * d, (tp.x * r.y - tp.y * r.x) * d")
# Box-Muller's log and sincos: the library's (the parent) and the tables' (the tree)
_LIBM = ("log(static_cast<double>(uniform_open(a)))",
         "  sincos(TWO_PI * static_cast<double>(uniform(b)), &sn, &cs);")
_OWN = ("ln_uniform(uniform_open(a), ln)", "  sincos_turn(b, &sn, &cs);")


def _box_muller(log: str, sincos: str) -> str:
    return (f"  const double r = sqrt(-2.0 * {log});\\n  double sn, cs;\\n{sincos}\\n"
            "  return make_float2(static_cast<float>(r * cs), static_cast<float>(r * sn));")


def gen_diagnostics(log: str, sincos: str) -> dict:
    """gen.cuh's variants, for Box-Muller's log call ``log`` and sincos line
    ``sincos``."""
    body = _box_muller(log, sincos)
    return {
        "no_box_muller": (
            f"{body} -> "
            "  return make_float2(3.4641f * (uniform(a) - 0.5f), 3.4641f * (uniform(b) - 0.5f));"),
        "f32_box_muller": (
            f"{body} -> "
            "  const float r = sqrtf(-2.f * logf(uniform_open(a)));\\n  float sn, cs;\\n"
            "  sincosf(6.28318530717958648f * uniform(b), &sn, &cs);\\n"
            "  return make_float2(r * cs, r * sn);"),
        "f64_no_log": f"{log} -> (static_cast<double>(uniform_open(a)) - 1.0005)",
        "f64_no_sqrt": f"sqrt(-2.0 * {log}) -> (-0.5 * {log} + 0.5)",
        "f64_no_sincos": (
            f"{sincos} -> "
            "  sn = static_cast<double>(uniform(b)) - 0.5;\\n  cs = 0.75 - sn * sn;"),
        "no_philox": (
            f"{_PHILOX_LOOP} -> "
            "  {\\n"
            "    uint32_t h = c.x * 0x9E3779B9u ^ c.y * 0x85EBCA6Bu ^ c.z * 0xC2B2AE35u ^ "
            "c.w * 0x27D4EB2Fu ^ k.x;\\n"
            "    h = (h ^ (h >> 15)) * 0x2C1B3C6Du;\\n"
            "    h ^= h >> 12;\\n"
            "    return make_uint4(h, h * 0x297A2D39u, (h ^ (h >> 7)) * 0xAD90777Du, "
            "(h ^ (h >> 11)) * 0x68E31DA5u);\\n"
            "  }\\n"
            f"{_PHILOX_LOOP}"),
    }


GEN_DIAGNOSTICS = {**gen_diagnostics(*_OWN),
                   "libm_box_muller": f"{_box_muller(*_OWN)} -> {_box_muller(*_LIBM)}"}
PARENT_GEN_DIAGNOSTICS = gen_diagnostics(*_LIBM)
SOURCE_DIAGNOSTICS = {  # gen_chain.cu
    "no_stores": (
        "    if (keep && re != nullptr) { ->     if (false) { ;; "
        f"{_EQ_STORE} -> "
        "      if (false) {\\n        const long long idx"),
    "blocks3": f"{_LAUNCH_BOUNDS} -> __launch_bounds__(THREADS, 3) gen_chain_kernel",
    "blocks1": f"{_LAUNCH_BOUNDS} -> __launch_bounds__(THREADS, 1) gen_chain_kernel",
}
DIAGNOSTICS = {
    "no_pilot_pass": (
        "    const float2 rb = rx_bin(b, k, gen::channel_bin<FRAMES>(p.n_taps, s.taps, s.wc, k, lane)); -> "
        "    const float2 rb = gen::cmul_rn(s.txs[b][k], make_float2(0.5f + 0.01f * i, 0.25f)); ;; "
        "        const float2 rb = est && q >= 0 ? s.prx[b][q][lane] : rx_bin(b, k, h[j]); -> "
        "        const float2 rb = rx_bin(b, k, h[j]);"),
    "no_divisions": (
        _LT_DIVISION + " ;; "
        "        e = chain::cdiv(rb, hu); -> "
        "        e = make_float2(rb.x * hu.x - rb.y * hu.y, rb.x * hu.y + rb.y * hu.x);"),
}
PARENT_DIAGNOSTICS = {
    "taps_once": {HEADER: (
        "    const uint4 w = draw(key, f, l, TAPS);\\n"
        "    const float2 z = normal_pair(w.x, w.y); -> "
        "    float2 z = make_float2(0.3f + 0.01f * l, 0.7f - 0.02f * (l ^ g));\\n"
        "    if (g == 0) {\\n"
        "      const uint4 w = draw(key, f, l, TAPS);\\n"
        "      z = normal_pair(w.x, w.y);\\n"
        "    }")},
    "no_block_redraw": (
        "      const float2 rb = rx_bin(b, j, k); -> "
        "      const float2 rb = gen::cmul_rn(s.txs[b][k], make_float2(h[j].x + 0.01f, h[j].y));"),
    "no_divisions": (
        _LT_DIVISION + " ;; "
        "        e = chain::cdiv(rx_bin(b, j, k), hu); -> "
        "        const float2 rb = rx_bin(b, j, k);\\n"
        "        e = make_float2(rb.x * hu.x - rb.y * hu.y, rb.x * hu.y + rb.y * hu.x);"),
}
_ERROR_STRING = 'extern "C" const char* gen_chain_error_string(int err) {'


# gen_chain_attributes for the parent's body (static shared memory only),
# inserted before its error-string entry
PARENT_ATTRIBUTES = """extern "C" int gen_chain_attributes(int eq_bf16, int* out) {
  const void* kernel = eq_bf16 ? reinterpret_cast<const void*>(gen_chain_kernel<__nv_bfloat16>)
                               : reinterpret_cast<const void*>(gen_chain_kernel<float>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  return err;
}
"""


def variants(parent: bool) -> dict:
    """Name → edits (by file) of every variant built for the tree or, with
    ``parent``, for the parent's body, whose source gains
    ``gen_chain_attributes``."""
    own = PARENT_DIAGNOSTICS if parent else DIAGNOSTICS
    gen = PARENT_GEN_DIAGNOSTICS if parent else GEN_DIAGNOSTICS
    out = {"as_is": {}, **{n: {HEADER: e} for n, e in gen.items()},
           **{n: {SOURCE.name: e} for n, e in SOURCE_DIAGNOSTICS.items()},
           **{n: e if isinstance(e, dict) else {SOURCE.name: e} for n, e in own.items()}}
    if parent:
        add = f"{_ERROR_STRING} -> {PARENT_ATTRIBUTES}\n{_ERROR_STRING}"
        out = {n: {**e, SOURCE.name: " ;; ".join(filter(None, (e.get(SOURCE.name), add)))}
               for n, e in out.items()}
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("gen_chain_variants: no CUDA device", file=sys.stderr)
        return 1
    if argv and (len(argv) != 2 or argv[0] != "--parent"):
        print("gen_chain_variants takes no arguments but --parent DIR", file=sys.stderr)
        return 2
    parent = bool(argv)
    source = pathlib.Path(argv[1]) / SOURCE.name if parent else SOURCE
    dev = torch.device("cuda", 0)
    print(_variants.card())
    cap = load_capture()
    txc = F.tx_spectra(*(Cplx(*(torch.tensor(v, dtype=torch.float32, device=dev).contiguous()
                                for v in (a.real, a.imag))) for a in (cap.tx_packet, cap.tx_lptot)))
    tag = "parent" if parent else "tree"
    with tempfile.TemporaryDirectory() as tmp:
        built = _variants.build(source, variants(parent), pathlib.Path(tmp))
        for name, (_, regs, spills) in built.items():
            print(f"{tag} {name}: registers {regs}, spill stores {spills} "
                  "(instantiations in nvcc's order)")
        for name, (path, _, _) in built.items():
            lib = G.LIB.at(path)

            def run(model=None, stream=True):
                return G._launch(SEED, B, *txc, SNR_DB, torch.bfloat16, model, stream, lib=lib)

            ms = _variants.time_ms(run)
            ms16 = _variants.time_ms(lambda: run("E"))
            ms_full = _variants.time_ms(lambda: run(stream=False))
            print(f"{tag} {name}: B={B} stream {ms:.4f} ms, 16 taps {ms16:.4f} ms, full "
                  f"{ms_full:.4f} ms; {G.kernel_attributes(lib=lib)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
