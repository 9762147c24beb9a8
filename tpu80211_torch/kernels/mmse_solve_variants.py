"""What each part of the solve kernel costs on the card: build variants of
``csrc/mmse_solve.cu`` and time them beside the kernel as it is.

    python -m tpu80211_torch.kernels.mmse_solve_variants [NAME='OLD -> NEW ;; ...' ...]

A variant is the source with text replaced (``OLD -> NEW``, several joined
by `` ;; ``, ``\\n`` for a line break; ``_variants`` builds and times
them).  With no arguments the variants are
``DIAGNOSTICS``: the kernel without its per-step barriers (wrong results,
the time of the synchronization), without its back substitution, with
``sub_mul`` (LU's multiply-adds) written as ``a -= m * b`` (six
instructions each where four FMAs do), and without its launch bound (the
compiler's own register count).  For each variant the script prints nvcc's registers and spill
stores per instantiation, then its time per call at 262,144 and 8,192
systems for fused/dense × gauss/chol (CUDA events, median of 5 runs of 10
calls; bench.py's systems, σ² = 0.37) and its largest error against the
plain version on the first 2,048 systems.  Needs a CUDA card and nvcc;
the builds go to a temporary directory.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import torch

from tpu80211_torch.kernels import _build, _ffi, _variants
from tpu80211_torch.kernels import mmse_solve as M

SOURCE = _build.CSRC / "mmse_solve.cu"
DIAGNOSTICS = {
    "no_step_barrier": "  __syncthreads();\\n  float2 l[TILES]; -> float2 l[TILES];",
    "no_back_substitution": "  if (tid >= 32) return; -> return;",
    "six_instruction_cmac": (
        "  a.x = fmaf(-m.x, b.x, a.x);\\n  a.x = fmaf(m.y, b.y, a.x);\\n"
        "  a.y = fmaf(-m.x, b.y, a.y);\\n  a.y = fmaf(-m.y, b.x, a.y); -> "
        "  a.x -= m.x * b.x - m.y * b.y;\\n  a.y -= m.x * b.y + m.y * b.x;"),
    "no_launch_bound": "__launch_bounds__(THREADS, MIN_BLOCKS) -> __launch_bounds__(THREADS)",
}


def variant_source(edits: str) -> str:
    """The kernel's source with each ``OLD -> NEW`` of ``edits`` applied;
    raises if an OLD is not in it."""
    return _variants.variant_source(SOURCE, edits)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("mmse_solve_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = {"as_is": ""}
    variants.update(dict(a.split("=", 1) for a in argv) if argv else DIAGNOSTICS)
    dev = torch.device("cuda", 0)
    print(_variants.card())
    with tempfile.TemporaryDirectory() as tmp:
        built = _variants.build(SOURCE, variants, pathlib.Path(tmp))
        libs = {name: M.LIB.at(path) for name, (path, _, _) in built.items()}
        for name, (_, regs, spills) in built.items():
            print(f"{name}: registers {regs}, spill stores {spills} (instantiations in nvcc's order)")
        for n in (262144, 8192):
            gen = torch.Generator(device=dev).manual_seed(3)
            u, rx = (torch.complex(torch.randn(n, 53, generator=gen, device=dev),
                                   torch.randn(n, 53, generator=gen, device=dev)) for _ in range(2))
            ow2 = torch.full((n,), 0.37, device=dev)
            a, z = M.rank1_systems(u, ow2), torch.empty_like(rx)
            for name, lib in libs.items():
                cells = []
                for entry in ("fused", "dense"):
                    for method in M.METHODS:
                        mat, w = (u, ow2) if entry == "fused" else (a, None)

                        def run():  # raises if it does not launch
                            _ffi.launch(lib.mmse_solve_launch, [mat, rx, w, z], n,
                                        M.METHODS.index(method))

                        run()
                        ms = _variants.time_ms(run)
                        k = 2048
                        want = M.fused_rank1_plain(u[:k], rx[:k], ow2[:k], method)
                        err = float((z[:k] - want).abs().max() / want.abs().max())
                        cells.append(f"{entry} {method} {ms:.4f} ms (err {err:.2g})")
                print(f"n={n} {name}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
