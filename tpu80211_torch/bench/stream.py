"""The device-resident streamed system on the card, frames/s per generator
(the port of ``scripts/bench_stream.py``).

    python -m tpu80211_torch.bench.stream                       # B=32,768, n=24, every generator
    python -m tpu80211_torch.bench.stream 32768 24 raw          # one generator (or --gen raw)
    python -m tpu80211_torch.bench.stream --device cpu 256 2    # a rehearsal on the plain versions

Each step of ``pipeline.stream.make_device_stream_step`` synthesizes a
fresh batch on the device, receives it and reduces it to summaries; steps
stay chained through the carried device state, as in JAX.  Generators:
``kernel`` (``gen_chain``), ``xla`` (torch synthesis, then the fused
chain), ``raw`` (torch synthesis, the placement kernel, then
``raw_chain``), ``kernel_raw`` (``raw_gen_chain``); ``all``, the default,
runs the four in turn.  SNR 20, the step's default.

The loop fence carries the state through the steps; the batch fence runs a
second step built at B/2 (`throughput.measure`).  ``idle_share`` is the
share of a step the card waits for the host, from the events; where a
step launches more than the card's queue holds, the events read the host's
pace (`throughput.device_busy`), so each row also carries
``idle_share_busy``: 1 − the profiler's busy ms a step over the host's
loop marginal, with ``busy_ms`` and ``launches_per_step``.

**Gates**, on the first batch before timing and on every timed batch's
summary after the loops (the summaries stay on the device until then):
every summary finite; ``raw`` and ``kernel_raw`` detection rate 1.0 and
timing in band >= 0.85 (bench.py's genraw gate at SNR 20); ``kernel`` and
``xla`` h_mmse NMSE < 0.1 (``chip_smoke.py``'s stream gate).  A failed
gate raises `throughput.GateError`.
"""

from __future__ import annotations

import sys

import torch

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.pipeline import stream as S

BATCH, N_BATCHES = 32768, 24
METRIC = ("device-resident streamed system (generate + fused chain + summaries) frames/s, "
          "serialized")
KERNELS = {"kernel": ("gen_chain",), "xla": ("fused_chain",), "raw": ("detect", "raw_chain"),
           "kernel_raw": ("raw_gen_chain",)}
IN_BAND_MIN = 0.85     # bench.py's genraw gate at SNR 20
NMSE_MAX = 0.1         # chip_smoke.py's h_mmse NMSE gate on a stream batch
RAW_GENS = ("raw", "kernel_raw")


def gate_summaries(gen: str, summaries: list[dict]) -> dict:
    """The gates over ``summaries`` (read back once, here): their values,
    or GateError."""
    keys = list(summaries[0])
    vals = torch.stack([torch.stack([s[k].float() for k in keys]) for s in summaries]).cpu()
    col = dict(zip(keys, vals.T))
    gates = {"batches": len(summaries), "finite": bool(torch.isfinite(vals).all())}
    TP.gate(gen, gates["finite"], gates, "a summary not finite")
    if gen in RAW_GENS:
        gates["detect_min"] = float(col["detect_rate"].min())
        gates["in_band_min"] = float(col["timing_in_band_rate"].min())
        TP.gate(gen, gates["detect_min"] == 1.0, gates, "a batch's detection rate below 1")
        TP.gate(gen, gates["in_band_min"] >= IN_BAND_MIN, gates,
                f"a batch's timing in band below {IN_BAND_MIN}")
    else:
        gates["h_mmse_nmse_max"] = float(col["h_mmse_nmse"].max())
        TP.gate(gen, gates["h_mmse_nmse_max"] < NMSE_MAX, gates,
                f"a batch's h_mmse NMSE not below {NMSE_MAX}")
    return gates


def stream_case(gen: str, batch: int, dev) -> tuple[TP.Case, list]:
    """The generator's step at B and at B/2, each carrying its own state, the
    first batch gated; and the list every later step appends its summary to."""
    seen = []

    def chained(b: int):
        fn, state0 = S.make_device_stream_step(b, gen=gen, device=dev)
        state = [state0]

        def step(i: int):
            summary, _, state[0] = fn(i, state[0])
            seen.append(summary)

        return step

    step = chained(batch)
    step(0)
    gates = gate_summaries(gen, seen)
    seen.clear()
    return TP.Case(gates, step, chained(batch // 2)), seen


def run_gen(gen: str, batch: int, n: int, dev) -> dict:
    """One generator gated and timed: the script's keys, the gates (first
    batch, and every timed one), the fences."""
    case, seen = stream_case(gen, batch, dev)
    m = TP.measure(case, batch, n, dev)
    busy = TP.device_busy(case.step, n, dev)
    gates = {"first": case.gates, "timed": gate_summaries(gen, seen)}
    ms = m["loop_ms"]["host"]
    return {
        "metric": METRIC, "generator": gen, "frames_per_s": batch / ms * 1e3,
        "ms_per_batch": ms, "batch": batch, "n_batches": n,
        "wall_s_single_run": CM.single_s(m), "device": TP.device_name(dev),
        "gates": gates, **CM.fences(m), **CM.busy(busy, ms),
    }


def main(argv: list[str] | None = None) -> int:
    choices = (*S.GENERATORS, "all")
    ap = CM.parser("stream", __doc__)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH, help=f"B (default {BATCH})")
    ap.add_argument("n_batches", nargs="?", type=int, default=N_BATCHES,
                    help=f"the loop length n (default {N_BATCHES})")
    ap.add_argument("gen", nargs="?", choices=choices, help="the generator (default: all)")
    ap.add_argument("--gen", dest="gen_opt", choices=choices, help="the generator, as an option")
    args = ap.parse_args(argv)
    gen = args.gen_opt or args.gen or "all"
    gens = S.GENERATORS if gen == "all" else (gen,)
    dev = CM.open_device(args.device, "stream", sorted({k for g in gens for k in KERNELS[g]}))
    if dev is None:
        return 1
    rows = {}
    for g in gens:
        rows[g] = run_gen(g, args.batch, args.n_batches, dev)
        CM.emit({k: v for k, v in rows[g].items() if k not in ("marginals_s", "single_s")})
    last = {
        "metric": "device stream frames/s per generator, gated, loop-length marginal (host)",
        "device": TP.device_name(dev), "batch": args.batch, "n_batches": args.n_batches,
        "rows": {g: {"frames_per_s": round(r["frames_per_s"]),
                     **CM.short(r, ("loop_ms", "idle_share", "idle_share_busy", "busy_ms",
                                    "launches_per_step", "fence_agreement"))}
                 for g, r in rows.items()},
    }
    return CM.finish(last, {"device": TP.device_name(dev), "rows": rows}, args.out)


if __name__ == "__main__":
    sys.exit(main())
