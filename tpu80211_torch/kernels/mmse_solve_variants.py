"""What each part of the solve kernel costs on the card: build variants of
``csrc/mmse_solve.cu`` and time them beside the kernel as it is.

    python -m tpu80211_torch.kernels.mmse_solve_variants [NAME='OLD -> NEW ;; ...' ...]

A variant is the source with text replaced (``OLD -> NEW``, several joined
by `` ;; ``, ``\\n`` for a line break).  With no arguments the variants are
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

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

import torch

from tpu80211_torch.kernels import _build
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
    src = SOURCE.read_text()
    for edit in filter(None, edits.split(" ;; ")):
        old, new = (s.encode().decode("unicode_escape") for s in edit.split(" -> "))
        if old not in src:
            raise ValueError(f"not in {SOURCE.name}: {old!r}")
        src = src.replace(old, new)
    return src


def build(variants: dict, out: pathlib.Path) -> dict:
    """One nvcc per variant, all started together; returns name →
    (library, registers, spill stores), the last two per instantiation."""
    procs = {}
    for name, edits in variants.items():
        src = out / f"{name}.cu"
        src.write_text(variant_source(edits))
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.mmse_solve_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                                  ctypes.c_void_p]
        lib.mmse_solve_launch.restype = ctypes.c_int
        built[name] = (lib, re.findall(r"Used (\d+) registers", log),
                       re.findall(r"(\d+) bytes spill stores", log))
    return built


def time_ms(fn, calls: int = 10, reps: int = 5) -> float:
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


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("mmse_solve_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = {"as_is": ""}
    variants.update(dict(a.split("=", 1) for a in argv) if argv else DIAGNOSTICS)
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        built = build(variants, pathlib.Path(tmp))
        for name, (_, regs, spills) in built.items():
            print(f"{name}: registers {regs}, spill stores {spills} (instantiations in nvcc's order)")
        for n in (262144, 8192):
            gen = torch.Generator(device=dev).manual_seed(3)
            u, rx = (torch.complex(torch.randn(n, 53, generator=gen, device=dev),
                                   torch.randn(n, 53, generator=gen, device=dev)) for _ in range(2))
            ow2 = torch.full((n,), 0.37, device=dev)
            a, z = M.rank1_systems(u, ow2), torch.empty_like(rx)
            stream = torch.cuda.current_stream(dev).cuda_stream
            for name, (lib, _, _) in built.items():
                cells = []
                for entry in ("fused", "dense"):
                    for method in M.METHODS:
                        mat, w = (u, ow2) if entry == "fused" else (a, None)
                        args = (mat.data_ptr(), rx.data_ptr(), None if w is None else w.data_ptr(),
                                z.data_ptr(), n, M.METHODS.index(method), stream)
                        if lib.mmse_solve_launch(*args):
                            raise RuntimeError(f"variant {name}: {entry} {method} did not launch")
                        ms = time_ms(lambda: lib.mmse_solve_launch(*args))
                        k = 2048
                        want = M.fused_rank1_plain(u[:k], rx[:k], ow2[:k], method)
                        err = float((z[:k] - want).abs().max() / want.abs().max())
                        cells.append(f"{entry} {method} {ms:.4f} ms (err {err:.2g})")
                print(f"n={n} {name}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
