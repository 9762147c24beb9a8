"""The program's own spans and counters, as the readers of the
``program_span`` and ``program_counter`` metrics take them.

The program (``tpu80211_torch.utils.spans``) keeps its spans in a ring in
memory, stamped with ``time.time_ns()``, the clock of the profiler's
events, so a span is laid against the traced slice's window directly.  An
entry call is a top-level ``entry.*`` span; the spans directly inside it
(``check``, ``outputs``, ``launch``) share its ``call_id`` and name it as
their parent.  A program without that module gives nothing to read, and
every reader of it is silent.
"""

from __future__ import annotations

import statistics


def module():
    """The program's tracing module, or None where it has none."""
    try:
        from tpu80211_torch.utils import spans
    except ImportError:
        return None
    return spans


def entry_calls(ctx) -> list[tuple]:
    """(entry record, [records directly inside it]) of every entry call
    whose ``entry.*`` span started in the traced slice."""
    sp, tr = module(), ctx.trace
    if sp is None or tr is None:
        return []
    w0, w1 = tr.window
    recs = sp.records()
    calls = {r.call_id: (r, []) for r in recs
             if r.name.startswith("entry.") and r.parent is None and w0 <= r.start_ns < w1}
    for r in recs:
        call = calls.get(r.call_id)
        if call is not None and r.parent == call[0].name:
            call[1].append(r)
    return list(calls.values())


def part_us(ctx, name: str) -> float | None:
    """The median, over the slice's entry calls that hold a ``name`` span,
    of the µs a call spent in them."""
    per_call = [sum(r.end_ns - r.start_ns for r in inside if r.name == name)
                for _, inside in entry_calls(ctx) if any(r.name == name for r in inside)]
    return statistics.median(per_call) / 1e3 if per_call else None


def self_us(ctx) -> float | None:
    """The median, over the slice's entry calls, of the µs of the entry
    span that no span directly inside it covers."""
    per_call = []
    for entry, inside in entry_calls(ctx):
        covered, t = 0, entry.start_ns
        for s, e in sorted((max(r.start_ns, entry.start_ns), min(r.end_ns, entry.end_ns))
                           for r in inside):
            s = max(s, t)
            if e > s:
                covered += e - s
                t = e
        per_call.append(entry.end_ns - entry.start_ns - covered)
    return statistics.median(per_call) / 1e3 if per_call else None


def setup_s(ctx) -> float | None:
    """Seconds the process spent in the program's set-up spans: the union
    of every ``setup.*`` span (the outermost ones, where builds run side
    by side counted once)."""
    sp = module()
    if sp is None:
        return None
    iv = sorted((r.start_ns, r.end_ns) for r in sp.records() if r.name.startswith("setup."))
    total, t = 0, None
    for s, e in iv:
        if t is None or s > t:
            total += e - s
            t = e
        elif e > t:
            total += e - t
            t = e
    return total / 1e9 if iv else None


def launches_per_call(ctx) -> float | None:
    """Σ ``launch.*`` over Σ ``call.*`` of the program's counters, over the
    process."""
    sp = module()
    if sp is None:
        return None
    c = sp.counters.snapshot()
    calls = sum(v for k, v in c.items() if k.startswith("call."))
    launches = sum(v for k, v in c.items() if k.startswith("launch."))
    return launches / calls if calls else None
