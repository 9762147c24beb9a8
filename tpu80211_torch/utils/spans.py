"""Spans and counters inside the program, on the profiler's clock.

The one tracing module of the port.  Four pieces:

* `span(name)`, a context manager for the hot path's outer spans (the
  entries).  Off, which means no ``torch.profiler`` session is running
  and `enable` was not called, it returns a shared null context after one
  flag check and records nothing.  On, it opens a profiler range named
  ``"tpu80211." + name``, so a profiler trace carries the span, and
  appends a `Record` to `ring` with ``time.time_ns()`` stamps taken just
  inside that range: the profiler's events carry the same epoch clock, so
  a record can be laid beside the device's activity of the same trace.
  The range is PyTorch's C++ one (``_RecordFunctionFast``), which costs
  about 0.7 µs a span under the profiler where
  ``torch.profiler.record_function`` costs 7, and whose bounds lie within
  a few µs of the stamps.
* `phase(name)`, the parts of the innermost open span (an entry's checks,
  output allocation and launch): it ends the part that is open and starts
  ``name`` (None: starts none), each part a record and a profiler range
  like a span's, whose parent is that span.  The span ends a part left
  open, also when an exception leaves it.  While no span records
  anywhere, a phase is one call and one test of a module global, about
  0.06 µs: a ``with`` block costs 0.3 even on a null context, and an
  entry has several parts.
* `setup_span(name)`, for one-off set-up work (the nvcc build, the library
  load, the constants): always recorded, a handful of records a process,
  kept in `setup_ring` apart from the hot path's so that a long traced
  run cannot push them out, and a profiler range too while one runs.
* `counters`, always on: ``counter("launch.fused_chain")`` gives a
  callable that adds one, bound once where the count is taken.

A record's ``parent`` is the name of the span open around it on the same
thread (None at the top), and every span and part inside one top-level
span shares that span's ``call_id``: the spans of one entry call share
its id.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Callable, NamedTuple

import torch

PREFIX = "tpu80211."      # the profiler's name of a span is PREFIX + name
RING_RECORDS = 65_536     # the ring keeps the newest records
SETUP_RECORDS = 4_096

_profiling = torch._C._autograd._profiler_enabled
_range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
_enabled = False
_recording = 0            # spans open and recording, over all threads
_lock = threading.Lock()
_calls = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    name: str
    start_ns: int          # time.time_ns(), the profiler's clock
    end_ns: int
    parent: str | None     # the enclosing span's name
    call_id: int           # shared by every span under one top-level span


ring: collections.deque[Record] = collections.deque(maxlen=RING_RECORDS)
setup_ring: collections.deque[Record] = collections.deque(maxlen=SETUP_RECORDS)


class Counters:
    """Named counts: ``launch.<kernel>`` once a kernel launch,
    ``launch.torch`` once a kernel a wrapper issues through PyTorch,
    ``call.<entry>`` once a public entry call.

    Each name counts with an `itertools.count`, whose ``next`` is one C
    call under the interpreter lock: it needs no lock of its own and loses
    no update between threads.  Its value is the number it would give
    next, which its repr, ``count(n)``, shows without taking it."""

    def __init__(self):
        self._counts: dict[str, itertools.count] = {}
        self._base: dict[str, int] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Callable[[], int]:
        """A callable that adds one to ``name``."""
        with self._lock:
            return self._counts.setdefault(name, itertools.count()).__next__

    def count(self, name: str, n: int = 1) -> None:
        step = self.counter(name)
        for _ in range(n):
            step()

    def snapshot(self) -> dict[str, int]:
        """Every nonzero count since the last `reset`."""
        with self._lock:
            items = [(k, int(repr(c)[6:-1]) - self._base.get(k, 0))
                     for k, c in self._counts.items()]
        return {k: v for k, v in items if v}

    def reset(self) -> None:
        with self._lock:
            self._base = {k: int(repr(c)[6:-1]) for k, c in self._counts.items()}


counters = Counters()
counter = counters.counter
count = counters.count


def enable() -> None:
    """Record spans with no profiler running (a profiler turns them on by
    itself)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def on() -> bool:
    """True while spans record: a profiler runs, or `enable` was called."""
    return _enabled or _profiling()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    """One open, recording span.  ``leaf`` spans are never the parent of
    another, so several may be open at once and close in any order."""

    __slots__ = ("name", "leaf", "into", "range", "parent", "call_id", "start", "part")

    def __init__(self, name: str, leaf: bool = False, into=ring):
        self.name, self.leaf, self.into = name, leaf, into

    def __enter__(self):
        global _recording
        self.range = self.part = None
        if _enabled or _profiling():
            self.range = _range(PREFIX + self.name)
            self.range.__enter__()
        with _lock:
            _recording += 1
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        self.call_id = top.call_id if top is not None else next(_calls)
        if not self.leaf:
            stack.append(self)
        self.start = time.time_ns()
        return self

    def phase(self, name: str | None) -> None:
        """Ends the open part, if any, and starts ``name``."""
        now = time.time_ns()
        if self.part is not None:
            part_name, start, rng = self.part
            self.into.append(Record(part_name, start, now, self.name, self.call_id))
            if rng is not None:
                rng.__exit__(None, None, None)
            self.part = None
        if name is not None:
            rng = None
            if self.range is not None:
                rng = _range(PREFIX + name)
                rng.__enter__()
            self.part = (name, time.time_ns(), rng)

    def __exit__(self, *exc):
        global _recording
        if self.part is not None:
            self.phase(None)
        end = time.time_ns()
        if not self.leaf:
            stack = _local.stack
            if stack[-1] is self:
                stack.pop()
            else:
                stack.remove(self)
        with _lock:
            _recording -= 1
        self.into.append(Record(self.name, self.start, end, self.parent, self.call_id))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()


def span(name: str):
    """A span of the hot path: a shared null context while spans are off."""
    if _enabled or _profiling():
        return _Span(name)
    return _NULL


def phase(name: str | None = None) -> None:
    """Ends the open part of the innermost open span on this thread and
    starts the part ``name`` (None: none).  Nothing while no span records."""
    if _recording:
        stack = _stack()
        if stack:
            stack[-1].phase(name)


def setup_span(name: str, leaf: bool = False) -> _Span:
    """A set-up span, ``setup.<name>``, recorded whether spans are on or
    not.  ``leaf``: it encloses no other span (builds that run side by
    side)."""
    return _Span("setup." + name, leaf, setup_ring)


def records() -> list[Record]:
    """The records of both rings, by start."""
    return sorted([*setup_ring, *ring], key=lambda r: r.start_ns)


def clear() -> None:
    """Empties both rings (the counters stay)."""
    ring.clear()
    setup_ring.clear()
