"""Readings for the limits and the serving rate, many seeds in one process.

    python -m perfbench.readings --workload <name> --seeds 1,2,3 --seconds 2 [--control]
        [--set key=value ...] [--config key=value ...] [--trace] [--out FILE]

Runs the cell once a seed, as `perfbench.run` does, with the set-up paid
once: the numbers compared with the program (the lower readings of the
limits) or with the control in its place (``--control``: the upper
readings), on the card at the cell's own sizes.  ``--set`` overrides a
parameter of the traffic file (``rate_per_s=0`` for the closed loop that
finds the rate the system sustains); ``--config`` one of the
configuration file (``storage=float8_e4m3fn``: the reference one
precision below).  A cell on n > 1 cards runs every seed in one world of n
ranks (`perfbench.world`).  One JSON line a seed on standard output, and
in ``--out`` if given.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import spec as S
from perfbench.run import card_limit, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m perfbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--config", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("perfbench.readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = S.load(args.workload)
    traffic, config = (dict(parse(kv) for kv in kvs) for kvs in (args.set, args.config))
    cell.traffic = {**cell.traffic, **traffic}
    cell.config = {**cell.config, **config}
    seeds = [int(s) for s in args.seeds.split(",")]
    chips = cell.workload["chips"]
    if chips > 1:
        from perfbench import world

        job = {"workload": args.workload, "seeds": seeds, "seconds": args.seconds,
               "trace": args.trace, "traffic": traffic, "config": config,
               "call": "control" if args.control else None}
        t = time.perf_counter()
        results = iter(world.run_lead(job, chips, "cuda"))
    out = open(args.out, "a") if args.out else None
    print(f"perfbench.readings: {card_limit()}", file=sys.stderr)
    for seed in seeds:
        if chips == 1:
            t = time.perf_counter()
            res = run_cell(cell, seed, args.seconds, args.trace, device,
                           call=cell.module.control if args.control else None, t_start=t)
        else:
            res = next(results)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "variant": "control" if args.control else "program",
                           "set": args.set, "config": args.config, "seconds": args.seconds,
                           "run_s": time.perf_counter() - t, **res})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


def parse(kv: str) -> tuple:
    k, v = kv.split("=", 1)
    try:
        return k, json.loads(v)
    except json.JSONDecodeError:   # a bare word: a string
        return k, v


if __name__ == "__main__":
    sys.exit(main())
