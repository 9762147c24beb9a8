"""The machinery of the card probes (``*_variants``): build edited copies of
a source under ``csrc/`` and time them beside the kernel as it is.

A variant is the source with text replaced (``OLD -> NEW``, several joined
by `` ;; ``, ``\\n`` for a line break), or a dict of such edits by file
name, to edit a header the source includes as well.  Each variant is written
to a directory of its own, the source and every header it edits: there a
quoted ``#include`` finds the edited header before the one in ``csrc/``.
Each builds with its own ``nvcc``, all started together, and reports the
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


def write_variant(source: pathlib.Path, edits, out: pathlib.Path) -> pathlib.Path:
    """The variant's files in the directory ``out``: ``source`` and each
    header beside it that ``edits`` names (a string edits ``source``; a dict
    maps file names to edits).  Returns the source's copy."""
    by_file = edits if isinstance(edits, dict) else {source.name: edits}
    out.mkdir(parents=True, exist_ok=True)
    for name in {source.name, *by_file}:
        (out / name).write_text(variant_source(source.parent / name, by_file.get(name, "")))
    return out / source.name


def build(source: pathlib.Path, variants: dict, out: pathlib.Path) -> dict:
    """One nvcc per variant of ``source``, all started together, each in its
    own directory under ``out`` (the headers it does not edit are found
    beside the source); returns name → (library, registers, spill stores),
    the last two per instantiation in nvcc's order."""
    procs = {}
    for name, edits in variants.items():
        src = write_variant(source, edits, out / name)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent), "-Xptxas", "-v",
             "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        built[name] = (ctypes.CDLL(str((out / name / source.name).with_suffix(".so"))),
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
