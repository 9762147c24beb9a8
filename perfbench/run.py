"""Run one cell of the benchmark once and print its result line.

    python -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine that holds the card(s) the cell
asks for.  The run makes its inputs on the card from the seed, sets the
program up and warms up every shape the cell uses (``setup_s``), drives the
cell's loop for ``--seconds``, then holds a seeded sample of the window's
outputs against the plain reference (``correct``).  With ``--trace 1`` the
last seconds of the window run under ``torch.profiler`` and the line carries
the per-layer metrics, ``busy_s``, ``window_s`` and ``breakdown``; with
``--trace 0`` the end-to-end metrics.  The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.

A cell on n > 1 cards runs one process a card (`perfbench/world.py`): this
process is rank 0, on ``cuda:0``, and prints the line, whose numbers pool
every rank's (frames, calls and the window over all cards, the fullest
card's peak, ``busy_s`` and ``window_s`` averaged over the cards, the check
over every rank's outputs); rank 0's own trace, spans and counters give the
one-card view.

It exits non-zero, printing no result, without the card(s), or if a module
of JAX or of the JAX package is loaded once the window has closed (on any
rank), or if any rank fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from perfbench import spec as S  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu80211")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``tpu80211_torch`` is neither)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: S.Cell, seed: int, seconds: float, trace: bool, device,
             call=None, t_start: float | None = None, world=None) -> dict | None:
    """One run of ``cell``: set-up, the window, the metrics, the check.
    ``call`` replaces the configuration's entry (the control, a planted
    fault).  ``world``: this rank's `perfbench.world.World` where the cell
    runs one rank a card.  Returns the result line's fields, ``checks``
    last; None on a rank above 0."""
    import torch

    from perfbench.reference.chain import no_tf32
    from perfbench.reference.compare import holds
    from perfbench.trace import Tracer, breakdown

    t_start = time.perf_counter() if t_start is None else t_start
    mod = cell.module
    state = mod.setup(cell.config, device)
    ranks = {} if world is None else {"world": world}
    loop = cell.loop.Loop(cell, state, call or mod.call, seed, device, **ranks)
    loop.prepare()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if world is not None:
        world.open_window(seconds)
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(trace, seconds, cell.traffic.get("trace_seconds", seconds), device)
    rec = loop.run(seconds, tracer)
    tr = tracer.finish()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traces = [tr]
    if world is not None:
        rec, traces, peak = world.pool(rec, tr, peak)

    batch = cell.traffic.get("batch", cell.config["batch"])
    serve = cell.traffic["loop"] == "serve"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    ctx = types.SimpleNamespace(cell=cell, records=rec, setup_s=setup_s, trace=tr,
                                traces=traces, kind=kind, work=mod.work(cell.config, batch, serve))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.entry["unit"]}

    loop.release()
    del state
    if cuda:
        torch.cuda.empty_cache()
    no_tf32()
    reference = mod.Reference(cell.config, device)
    numbers = loop.check(reference)
    if numbers is None:   # a rank above 0: its part of the check went to rank 0
        return None
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    missing = set(cell.limits) - set(numbers)
    correct = not missing and all(holds(c["value"], c["limit"]) for c in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1 if world is None else world.size,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": rec.calls, "failed": 0, "metrics": metrics,
           "device": dev}
    if tr is not None:
        live = [t for t in traces if t is not None]   # averaged over the cards
        dev.update(busy_s=sum(t.busy_s() for t in live) / len(live),
                   window_s=sum(t.window_s for t in live) / len(live))
        out["breakdown"] = breakdown(tr)
    out["trace_s"] = {"start": tracer.start_s, "reduce": tracer.reduce_s}
    out["checks"] = {k: {"value": (v["value"] if math.isfinite(v["value"]) else str(v["value"])),
                         "limit": v["limit"]} for k, v in checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m perfbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    chips = next((w["chips"] for w in S.benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    ranks = None
    if chips > 1:   # one rank a card, this process rank 0: the others start first
        from perfbench import world

        ranks = world.spawn(chips)
    cell = S.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        if ranks is not None:
            ranks.kill()
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    if ranks is not None:
        job = {"workload": args.workload, "seeds": [args.seed], "seconds": args.seconds,
               "trace": bool(args.trace)}
        out = world.run_lead(job, ranks, "cuda", t_start=T_START)[0]
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed {args.seed}: {card_limit()}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
