"""Serving latency against batch size: the per-frame-tx fused chain on the
card (the port of ``scripts/bench_latency.py``).

    python -m tpu80211_torch.bench.latency                  # iters 32, B = 512, 4,096, 32,768
    python -m tpu80211_torch.bench.latency 32 512,4096 --f32
    python -m tpu80211_torch.bench.latency --device cpu 2 128,256   # a rehearsal

For each B, `throughput.chain_case("fused", B)` (bf16 planes, or float32
with ``--f32``), gated by its slice against the plain version, then timed
by `throughput.measure`.  A row gives the serialized step's loop marginal
(median of 3 repeats) and its spread, the single loop's time per step
(the host's fixed dispatch cost included: at small B it is the serving
latency's floor) and frames/s.

The script's rule, kept on the host clock: frames/s is null (and the row
``unresolved``) where the marginal is under 50 µs a step or the repeats
spread over more than half the median.  Beside it, ``ms_per_step_event``
is the loop marginal on CUDA events, which times the device alone and
resolves what the host clock cannot.
"""

from __future__ import annotations

import sys

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP

ITERS = 32
BATCHES = (512, 4096, 32768)
REPEATS = TP.REPS
MIN_STEP_S = 50e-6       # the script's dispatch-jitter floor a step


def unresolved(margins_s: list[float], iters: int) -> tuple[float, float, bool]:
    """The script's rule (bench_latency.py:77-90) on the repeats' loop
    marginals (host seconds of ``iters`` steps): (median, spread, whether
    the step is not resolvable)."""
    margins = sorted(max(m, 1e-9) for m in margins_s)
    dt = margins[len(margins) // 2]
    spread = margins[-1] - margins[0]
    return dt, spread, dt / iters < MIN_STEP_S or spread > 0.5 * dt


def sweep_one(batch: int, iters: int, dev, f32: bool = False) -> dict:
    """One batch size gated and timed: the script's row, the gates, the
    fences."""
    case = TP.chain_case("fused", batch, dev, f32)
    m = TP.measure(case, batch, iters, dev)
    dt, spread, unres = unresolved([h for h, _ in m["marginals_s"]["loop"]], iters)
    row = {
        "batch": batch,
        "ms_per_step_marginal": 1e3 * dt / iters,
        "ms_per_step_marginal_spread": 1e3 * spread / iters,
        "repeats": REPEATS,
        "ms_per_step_single_loop": 1e3 * CM.single_s(m) / iters,
        "frames_per_s": batch * iters / dt,
        "ms_per_step_event": m["loop_ms"]["event"],
        "gates": case.gates, **CM.fences(m),
    }
    if unres:
        row["frames_per_s"] = None
        row["unresolved"] = True
    return row


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("latency", __doc__)
    ap.add_argument("iters", nargs="?", type=int, default=ITERS,
                    help=f"the loop length n (default {ITERS})")
    ap.add_argument("batches", nargs="?", default=",".join(map(str, BATCHES)),
                    help="comma-separated batch sizes (default %(default)s)")
    ap.add_argument("--f32", action="store_true", help="float32 planes in place of bf16")
    args = ap.parse_args(argv)
    dev = CM.open_device(args.device, "latency", ("fused_chain",))
    if dev is None:
        return 1
    rows = []
    for batch in (int(b) for b in args.batches.split(",")):
        rows.append(sweep_one(batch, args.iters, dev, args.f32))
        CM.emit({k: v for k, v in rows[-1].items() if k not in ("marginals_s", "single_s")})
    dtype = "f32" if args.f32 else "bf16"
    last = {
        "metric": "per-frame-tx fused chain ms a step against B, gated, loop marginal",
        "device": TP.device_name(dev), "dtype": dtype, "iters": args.iters,
        "rows": [{"batch": r["batch"], "frames_per_s": r["frames_per_s"] and round(r["frames_per_s"]),
                  "ms": TP.rounded([r["ms_per_step_event"], r["ms_per_step_marginal"]], 4),
                  "single_ms": TP.rounded(r["ms_per_step_single_loop"], 4),
                  "idle": TP.rounded(r["idle_share"], 3)} for r in rows],
    }
    doc = {"device": TP.device_name(dev), "dtype": dtype, "iters": args.iters, "rows": rows}
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
