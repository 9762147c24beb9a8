"""What the script modules of ``tpu80211_torch.bench`` share.

Each module is the port of one measurement script of the JAX package
(``scripts/bench_*.py``): ``python -m tpu80211_torch.bench.<name>`` takes
the script's positional arguments with its defaults, runs on the card
(``--device cuda``, the default; without a card it exits 1, it never falls
back to the CPU) or rehearses on the plain versions (``--device cpu``),
gates before it times, prints the JSON lines the script prints, and ends
with one JSON object under `throughput.MAX_LINE` characters.  ``--out
PATH`` writes the document the script writes into ``artifacts/``; nothing
is written by default.

Every timed row goes through `throughput.measure` (both fences, both
clocks, the idle share); a row keeps the script's own keys, taken from the
loop fence on the host clock as the script takes them, and carries the
fences beside them (`fences`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.kernels import _build


def parser(name: str, doc: str) -> argparse.ArgumentParser:
    """A module's parser with ``--device`` and ``--out``."""
    ap = argparse.ArgumentParser(prog=f"python -m tpu80211_torch.bench.{name}",
                                 description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, a rehearsal on "
                    "the plain versions")
    ap.add_argument("--out", help="also write the script's document to this JSON file")
    return ap


def open_device(name: str, prog: str, kernels=()) -> torch.device | None:
    """``name`` as a device, its ``kernels`` (sources under ``csrc/``) built
    on a card; None, with the reason on stderr, when it names a card and
    there is none."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print(f"{prog}: no CUDA device (pass --device cpu for a rehearsal on the plain "
                  "versions)", file=sys.stderr)
            return None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if kernels:
            _build.build_all([_build.CSRC / f"{k}.cu" for k in kernels])
    return dev


def fences(m: dict) -> dict:
    """`throughput.measure`'s fences, carried beside a script's own keys:
    ms per step [event, host] on the loop and the batch fence (the latter
    prices B/2 items), their agreement, the idle share, the rate on events."""
    return {
        "loop_ms": [m["loop_ms"]["event"], m["loop_ms"]["host"]],
        "batch_ms": [m["batch_ms"]["event"], m["batch_ms"]["host"]],
        "fence_agreement": m["fence_agreement"], "idle_share": m["idle_share"],
        "per_s_event": m["per_s_event"], "marginals_s": m["marginals_s"],
        "single_s": m["single_s"],
    }


def busy(b: dict | None, host_ms: float) -> dict:
    """`throughput.device_busy`'s reading beside a row's host ms a step:
    busy ms and launches a step, and the idle share they give (None off
    the card)."""
    if b is None:
        return {"busy_ms": None, "launches_per_step": None, "idle_share_busy": None}
    return {"busy_ms": b["busy_ms"], "launches_per_step": b["launches"],
            "idle_share_busy": 1.0 - b["busy_ms"] / host_ms}


def single_s(m: dict) -> float:
    """The median host seconds of one n-step loop (a script's
    ``wall_s_single_*``)."""
    return statistics.median(m["single_s"])


def short(row: dict, keys=("loop_ms", "idle_share", "fence_agreement")) -> dict:
    """A row's fences for the last line, 4 significant digits."""
    return {k: TP.rounded(row[k], 4) for k in keys}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def finish(last: dict, doc: dict, out: str | None) -> int:
    """Write ``doc`` to ``out`` (when given), print ``last`` as the last line;
    1 if that line is not under `throughput.MAX_LINE` characters."""
    if out:
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    line = json.dumps(last, separators=(",", ":"))
    print(line, flush=True)
    return 0 if len(line) < TP.MAX_LINE else 1
