"""The machinery of the card probes (``*_variants``): build edited copies of
a source under ``csrc/`` and time them beside the kernel as it is.

A variant is the source with text replaced (``OLD -> NEW``, several joined
by `` ;; ``, ``\\n`` for a line break).  Each variant builds with its own
``nvcc`` into a temporary directory, all started together, and reports the
registers and spill stores that ``-Xptxas -v`` prints per instantiation.
Times are CUDA events around back-to-back calls.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess

import torch

from tpu80211_torch.kernels import _build


def variant_source(source: pathlib.Path, edits: str) -> str:
    """``source``'s text with each ``OLD -> NEW`` of ``edits`` applied;
    raises if an OLD is not in it."""
    src = source.read_text()
    for edit in filter(None, edits.split(" ;; ")):
        old, new = (s.encode().decode("unicode_escape") for s in edit.split(" -> "))
        if old not in src:
            raise ValueError(f"not in {source.name}: {old!r}")
        src = src.replace(old, new)
    return src


def build(source: pathlib.Path, variants: dict, out: pathlib.Path) -> dict:
    """One nvcc per variant of ``source``, all started together, into
    ``out`` (the source's own headers are found beside it); returns name →
    (library, registers, spill stores), the last two per instantiation in
    nvcc's order."""
    procs = {}
    for name, edits in variants.items():
        src = out / f"{name}.cu"
        src.write_text(variant_source(source, edits))
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent), "-Xptxas", "-v",
             "-o", str(out / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(out / f"{name}.so")),
                       re.findall(r"Used (\d+) registers", log),
                       re.findall(r"(\d+) bytes spill stores", log))
    return built


def time_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """ms per call: CUDA events around ``calls`` back-to-back calls, median
    of ``reps`` runs after a warm-up."""
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


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
