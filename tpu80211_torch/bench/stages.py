"""Per-stage cost of the plain chain as the marginals between its prefixes
(the port of ``scripts/bench_stages.py``), in plain PyTorch on the card, as
the script times plain XLA.

    python -m tpu80211_torch.bench.stages                   # B=16,384 complex64 frames, n=24
    python -m tpu80211_torch.bench.stages --device cpu 64 2 # a rehearsal

`prefix_chain` (args, k) runs the first k of `STAGES` over the port's
``pipeline.sc`` pieces and reduces every output to one scalar, as the
script does, so each prefix's step computes what the script's does.
Each prefix is timed by `throughput.measure`; a stage's cost is its
prefix's loop marginal less the previous prefix's.

The script's rule, kept on the host clock: a stage's marginal is null
(with the jitter it failed to clear) unless it exceeds the spread of both
prefixes' repeats.  ``marginal_ms_event`` applies the same rule to CUDA
events.  On the card each prefix also carries the profiler's busy ms a
step (`throughput.device_busy`) and ``marginal_ms_busy``, the stage's
device time, which the host's pace does not hide.

Gate, before timing: the full chain (``sc.rx_chain``, the nine stages) on
these frames, a 1,024-frame slice against the same frames on the CPU and
all outputs finite (the ``plain`` row's gate of ``bench.throughput``).
Frames: `throughput.plain_frames` (standard complex normals, seed 0);
step i scales them by (1 + 1e-6·i).
"""

from __future__ import annotations

import sys

import torch

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.pipeline import sc

# the chain's prefixes: stage i adds STAGES[i] (pipeline/sc.py's order)
STAGES = [
    "front_end",   # preamble FFTs + noise power + block extraction
    "lt_ls",
    "ps_linear",
    "ps_cubic",
    "ps_sinc",
    "ps_spline",
    "ps_wiener",
    "ps_mmse_sm",
    "equalize",
]
BATCH, ITERS = 16384, 24
REPEATS = TP.REPS


def prefix_chain(args, n_stages: int, squash=torch.tanh) -> torch.Tensor:
    """The first ``n_stages`` stages on (tx_pkt, rx_pkt, tx_lp, rx_lp)
    complex frames, every output summed (real and imaginary parts) into
    one scalar: ``squash(total) · 1e-9``, the script's reduction."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = args
    tx_pre, rx_pre = sc.preamble_fft(tx_lp), sc.preamble_fft(rx_lp)
    ow2 = sc.noise_power(rx_lp)
    txb, rxb = sc.extract_blocks(tx_pkt), sc.extract_blocks(rx_pkt)
    outs = [tx_pre, rx_pre, txb, rxb, ow2]
    h_lt = h_lin = None
    for name in STAGES[1:n_stages]:
        if name == "lt_ls":
            h_lt = sc.lt_ls(tx_pre, rx_pre)
            outs.append(h_lt)
        elif name == "ps_mmse_sm":
            outs.append(sc.ps_mmse_sm(txb, rxb, ow2, h_lt))
        elif name == "equalize":
            outs.append(sc.equalize(rxb, h_lt, h_lin))
        else:
            h = sc.ps_interp(txb, rxb, name.removeprefix("ps_"))
            h_lin = h if name == "ps_linear" else h_lin
            outs.append(h)
    flat = torch.stack([o.real.sum() + o.imag.sum() if o.is_complex() else o.sum()
                        for o in outs])
    return squash(flat.sum()) * 1e-9


def prefix_case(ins: tuple, n_stages: int, gates: dict) -> TP.Case:
    batch = ins[0].shape[0]

    def make_step(n: int):
        args = tuple(x if n == batch else x[:n].contiguous() for x in ins)
        return lambda i: prefix_chain(tuple(x * (1.0 + 1e-6 * i) for x in args), n_stages)

    return TP.Case(gates, make_step(batch), make_step(batch // 2))


def _median_spread(vals: list[float], iters: int) -> tuple[float, float]:
    """Median and spread (max − min) of the repeats, seconds a step."""
    vals = sorted(max(v, 1e-9) / iters for v in vals)
    return vals[len(vals) // 2], vals[-1] - vals[0]


def _marginal(dt: float, spread: float, prev: tuple[float, float]) -> tuple[float | None, float]:
    """The script's rule: (the marginal in ms, or None under the jitter of
    both prefixes; that jitter in ms)."""
    jitter = max(spread, prev[1])
    marginal = dt - prev[0]
    return (1e3 * marginal if marginal > jitter else None), 1e3 * jitter


def run(batch: int, iters: int, dev) -> tuple[list[dict], dict]:
    """Every prefix gated and timed: (the script's rows with the fences, the
    gates)."""
    ins = TP.plain_frames(batch, dev)
    gates = TP.plain_gates("stages", ins, sc.rx_chain(*ins))
    rows, prev, prev_ev, prev_busy = [], (0.0, 0.0), (0.0, 0.0), 0.0
    for n in range(1, len(STAGES) + 1):
        case = prefix_case(ins, n, gates)
        m = TP.measure(case, batch, iters, dev)
        dt, spread = _median_spread([h for h, _ in m["marginals_s"]["loop"]], iters)
        marginal, jitter = _marginal(dt, spread, prev)
        row = {"stage": STAGES[n - 1], "prefix_ms": 1e3 * dt, "prefix_spread_ms": 1e3 * spread,
               "repeats": REPEATS, "marginal_ms": marginal}
        if marginal is None:
            row["marginal_below_jitter_ms"] = jitter
        prev = (dt, spread)
        if m["loop_ms"]["event"] is not None:
            ev = _median_spread([e for _, e in m["marginals_s"]["loop"]], iters)
            row["prefix_ms_event"] = 1e3 * ev[0]
            row["marginal_ms_event"] = _marginal(*ev, prev_ev)[0]
            prev_ev = ev
            row.update(CM.busy(TP.device_busy(case.step, iters, dev), 1e3 * dt))
            row["marginal_ms_busy"] = row["busy_ms"] - prev_busy
            prev_busy = row["busy_ms"]
        rows.append({**row, **CM.fences(m)})
        CM.emit({k: v for k, v in rows[-1].items() if k not in ("marginals_s", "single_s")})
    return rows, gates


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("stages", __doc__)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH, help=f"B (default {BATCH})")
    ap.add_argument("iters", nargs="?", type=int, default=ITERS,
                    help=f"the loop length n (default {ITERS})")
    args = ap.parse_args(argv)
    dev = CM.open_device(args.device, "stages")
    if dev is None:
        return 1
    rows, gates = run(args.batch, args.iters, dev)
    doc = {"device": TP.device_name(dev), "batch": args.batch, "iters": args.iters,
           "gates": gates, "rows": rows}
    last = {
        "metric": "plain chain stage cost: [stage, prefix ms, marginal ms (host; null under "
                  "jitter), marginal ms (events), marginal busy ms (profiler), launches]",
        "device": doc["device"], "batch": args.batch, "iters": args.iters,
        "rows": [[r["stage"], TP.rounded(r["prefix_ms"], 4), TP.rounded(r["marginal_ms"], 3),
                  TP.rounded(r.get("marginal_ms_event"), 3),
                  TP.rounded(r.get("marginal_ms_busy"), 3), r.get("launches_per_step")]
                 for r in rows],
        "gates": TP.rounded(gates, 2),
    }
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
