"""The traced slice of a ``--trace 1`` run, and its reduction in memory.

The loops call `Tracer.tick` once an iteration.  In the last
``trace_seconds`` of the window the tracer runs ``torch.profiler`` over the
host and the card, and the loops wrap their host steps in spans of their
own (``bench.<step>``, `Tracer.span`).  Once the window has closed, `reduce`
turns the profiler's events into what the per-layer readers take: the
device's activity (kernels, copies, fills) clipped to the traced slice, the
host spans, and the number of calls in the slice.  Nothing is written to
disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

WARM_CALLS = 3  # calls under the profiler before the traced slice opens


@dataclasses.dataclass
class Trace:
    """The traced slice, in the profiler's nanoseconds."""

    window: tuple[int, int]
    device: list      # [(start, end, name)] of device activity, clipped to the window
    spans: list       # [(start, end, name)] of the loops' host spans in the window
    calls: int        # calls (batches or requests) that started in the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        its intervals, so overlapping copies and kernels count once."""
        return sum(e - s for s, e in union(self.device)) / 1e9

    def kernel_s(self, kernel: str) -> float:
        """Seconds the device ran kernels whose name holds ``kernel``."""
        return sum(e - s for s, e, name in self.device if kernel in name) / 1e9


def union(intervals) -> list[tuple[int, int]]:
    """The union of (start, end, …) intervals as sorted disjoint (start, end)."""
    out: list[list[int]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(window: tuple[int, int], busy: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The idle intervals of the window, given its busy union."""
    out, t = [], window[0]
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < window[1]:
        out.append((t, window[1]))
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (the loops' span that overlaps it; ``other``
    where none does), seconds each, at most ``top`` of each."""
    ops: dict[str, int] = {}
    for s, e, name in tr.device:
        ops[name] = ops.get(name, 0) + (e - s)
    idle: dict[str, int] = {}
    spans = sorted(tr.spans)   # the loops' spans do not overlap: ends sorted too
    first = 0
    for gs, ge in gaps(tr.window, union(tr.device)):
        while first < len(spans) and spans[first][1] <= gs:
            first += 1
        covered = 0
        for k in range(first, len(spans)):
            s, e, name = spans[k]
            if s >= ge:
                break
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                idle[name] = idle.get(name, 0) + ov
                covered += ov
        if ge - gs > covered:
            idle["other"] = idle.get("other", 0) + (ge - gs - covered)

    def rank(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


class Tracer:
    """Runs the profiler over the last ``trace_seconds`` of a window."""

    def __init__(self, enabled: bool, seconds: float, trace_seconds: float, device):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.start_at = max(0.0, seconds - trace_seconds)
        self.prof = None
        self.window_span = None
        self.warm = 0
        self.traced = False   # True once the profiler comes up
        self.reduce_s = 0.0   # seconds spent stopping the profiler and reducing
        self.start_s = 0.0    # seconds the loop paused to start the profiler
        self.device = device

    def tick(self, elapsed: float) -> float:
        """Once an iteration, before its call; returns the seconds it paused
        the loop, which the loop adds to its window.

        The first profiler of a process spends seconds bringing up CUPTI,
        which then slows every CUDA call a little: so it comes up only here,
        after the untraced calls, with the loop paused, and a short session
        pays for it before the traced one starts."""
        if not self.enabled:
            return 0.0
        if self.prof is None and elapsed >= self.start_at:
            t0 = time.perf_counter()
            self.traced = True
            with _profile():
                torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)
            self.prof = _profile()
            self.prof.start()
            self.start_s = time.perf_counter() - t0
            return self.start_s
        if self.prof is not None and self.window_span is None:
            self.warm += 1
            if self.warm > WARM_CALLS:
                self.window_span = torch.profiler.record_function("bench.window")
                self.window_span.__enter__()
        return 0.0

    def span(self, name: str):
        """A host span of the loop, recorded in the traced slice only."""
        if self.window_span is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def finish(self) -> Trace | None:
        """After the loop has drained the device: close the slice, stop the
        profiler and reduce its events."""
        if self.prof is None:
            return None
        if self.window_span is not None:
            self.window_span.__exit__(None, None, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.stop()
        tr = reduce(self.prof)
        self.reduce_s = time.perf_counter() - t0
        self.prof = None
        return tr


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof):
    """(name, device_type, start_ns, end_ns, annotation?) of every event."""
    res = prof.profiler.kineto_results
    out = []
    for e in res.events():
        s = e.start_ns()
        out.append((e.name(), e.device_type(), s, s + e.duration_ns(), e.is_user_annotation()))
    return out


def reduce(prof) -> Trace | None:
    """The profiler's events as a `Trace`; None without a traced slice."""
    cuda = torch.autograd.DeviceType.CUDA
    events = _events(prof)
    win = [(s, e) for name, dt, s, e, _ in events if name == "bench.window" and dt != cuda]
    if not win:
        return None
    w0, w1 = win[0]
    device, spans, calls = [], [], 0
    for name, dt, s, e, ann in events:
        if dt == cuda:
            if ann or name.startswith("bench."):
                continue
            s, e = max(s, w0), min(e, w1)
            if e > s:
                device.append((s, e, name))
        elif name.startswith("bench.") and name != "bench.window":
            if w0 <= s < w1:
                spans.append((s, min(e, w1), name[len("bench."):]))
                calls += name == "bench.call"
    return Trace((w0, w1), device, spans, calls)
