"""The machinery of the card probes (``*_variants``): build edited copies of
a source under ``csrc/`` and time them beside the kernel as it is.

A variant is the source with text replaced (``OLD -> NEW``, several joined
by `` ;; ``, ``\\n`` for a line break), or a dict of such edits by file
name, to edit a header the source includes as well.  Each variant is written
to a directory of its own, the source and every header it edits: there a
quoted ``#include`` finds the edited header before the one in ``csrc/``.
Each builds with its own ``nvcc``, all started together, and reports the
registers and spill stores that ``-Xptxas -v`` prints per instantiation; the
wrapper's `Library.at` of a build is its handle, which the wrapper's
``lib=`` takes.  Times are CUDA events around back-to-back calls.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import pathlib
import re
import subprocess


from tpu80211_torch.kernels import _build
from tpu80211_torch.utils.timing import card, time_ms  # noqa: F401  (the probes' clock)


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
    beside the source); returns name → (library path, registers, spill
    stores), the last two per instantiation in nvcc's order.  Every build
    includes ``csrc/ffi.cuh`` first, so a parent's body from before that
    header also exports ``ffi_error_string``."""
    procs = {}
    for name, edits in variants.items():
        src = write_variant(source, edits, out / name)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(source.parent),
             "--pre-include", str(_build.CSRC / "ffi.cuh"), "-Xptxas", "-v",
             "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        built[name] = ((out / name / source.name).with_suffix(".so"),
                       re.findall(r"Used (\d+) registers", log),
                       re.findall(r"(\d+) bytes spill stores", log))
    return built
