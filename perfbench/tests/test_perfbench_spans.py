"""The readers of the program's own spans and counters on synthetic rings
and traced slices: a call counts where its entry span starts in the
slice, the parts and the self time of an entry call, the union of set-up,
launches per call, and silence where there is nothing to read (a program
without the spans module included)."""

import builtins
import time
import types

import pytest

from perfbench import program_spans
from perfbench import spec as S
from perfbench.trace import Trace

NAMES = ("entry_check_us", "entry_outputs_us", "entry_launch_us", "entry_self_us",
         "setup_program_s", "entry_launches_per_call")
READERS = {n: S.load_module(S.HERE / "metrics" / f"{n}.py", f"spans_{n}") for n in NAMES}


def rec(name, start_us, end_us, parent=None, call_id=0):
    return types.SimpleNamespace(name=name, start_ns=int(start_us * 1e3),
                                 end_ns=int(end_us * 1e3), parent=parent, call_id=call_id)


def entry_call(call_id, t0, check=(1, 11), outputs=(12, 32), launch=(33, 53), end=60,
               entry="entry.fused_rx_chain_txconst"):
    """One entry call starting at ``t0`` µs, its parts at offsets from it."""
    out = [rec(entry, t0, t0 + end, None, call_id)]
    for name, (s, e) in (("check", check), ("outputs", outputs), ("launch", launch)):
        if s is not None:
            out.append(rec(name, t0 + s, t0 + e, entry, call_id))
    return out


def program(records=(), counts=None):
    return types.SimpleNamespace(records=lambda: sorted(records, key=lambda r: r.start_ns),
                                 counters=types.SimpleNamespace(snapshot=lambda: dict(counts or {})))


def ctx(window_us=None):
    tr = None if window_us is None else Trace(tuple(int(t * 1e3) for t in window_us), [], [], 0)
    return types.SimpleNamespace(trace=tr)


@pytest.fixture
def ring(monkeypatch):
    def use(records=(), counts=None):
        monkeypatch.setattr(program_spans, "module", lambda: program(records, counts))
    return use


def test_parts_are_medians_over_the_calls_in_the_slice(ring):
    recs = (entry_call(1, 0, check=(1, 6))                # before the slice: not counted
            + entry_call(2, 1000) + entry_call(3, 1100, check=(1, 31))
            + entry_call(4, 1200, check=(1, 21))
            + entry_call(5, 5000, check=(1, 101)))       # after the slice
    ring(recs)
    c = ctx((900, 2000))
    assert READERS["entry_check_us"].read(c) == pytest.approx(20.0)
    assert READERS["entry_outputs_us"].read(c) == pytest.approx(20.0)
    assert READERS["entry_launch_us"].read(c) == pytest.approx(20.0)


def test_a_call_that_ends_after_the_slice_still_counts_whole(ring):
    ring(entry_call(1, 1990, check=(1, 41), outputs=(42, 62), launch=(63, 73), end=80))
    c = ctx((1000, 2000))
    assert READERS["entry_check_us"].read(c) == pytest.approx(40.0)
    assert READERS["entry_self_us"].read(c) == pytest.approx(80 - 40 - 20 - 10)


def test_self_time_is_what_no_child_covers(ring):
    # children 1–11, 12–32, 33–53 of a 60 µs entry: 60 − 50 = 10 µs of self;
    # a grandchild under launch takes nothing more away
    recs = entry_call(1, 100) + [rec("setup.load.fused_chain", 140, 150, "launch", 1)]
    # overlapping children count once, and a child is clipped to its entry:
    # 0–40 and 50–80 of 80 µs, 10 of self
    recs += entry_call(2, 300, check=(0, 30), outputs=(20, 40), launch=(50, 100), end=80)
    # 10 µs of children in a 100 µs entry: 90 of self
    recs += entry_call(3, 500, check=(1, 6), outputs=(6, 8), launch=(8, 11), end=100)
    ring(recs)
    c = ctx((0, 1000))
    assert READERS["entry_self_us"].read(c) == pytest.approx(10.0)
    assert sorted(program_spans.entry_calls(c), key=lambda x: x[0].call_id)[2][0].call_id == 3


def test_parts_missing_from_a_call_are_not_read_as_zero(ring):
    # the CPU path records its entry span alone
    ring(entry_call(1, 100, check=(None, None), outputs=(None, None), launch=(None, None)))
    c = ctx((0, 1000))
    for name in ("entry_check_us", "entry_outputs_us", "entry_launch_us"):
        assert READERS[name].read(c) is None, name
    assert READERS["entry_self_us"].read(c) == pytest.approx(60.0)


def test_nested_entries_and_other_spans_are_not_calls(ring):
    recs = [rec("entry.x", 100, 200, "outer", 1), rec("outer", 90, 210, None, 1),
            rec("check", 110, 120, "outer", 1)]
    ring(recs)
    c = ctx((0, 1000))
    for name in ("entry_check_us", "entry_self_us"):
        assert READERS[name].read(c) is None, name


def test_setup_is_the_union_of_setup_spans(ring):
    # load 0–100 holding a build 10–90; two builds side by side 200–300 and
    # 250–400; constants 500–510; a hot span is not set-up
    ring([rec("setup.load.fused_chain", 0, 100),
          rec("setup.build.fused_chain", 10, 90, "setup.load.fused_chain"),
          rec("setup.build.raw_chain", 200, 300), rec("setup.build.detect", 250, 400),
          rec("setup.consts", 500, 510), rec("entry.fused_rx_chain_txconst", 600, 700)])
    assert READERS["setup_program_s"].read(ctx()) == pytest.approx((100 + 200 + 10) / 1e6)


def test_launches_per_call(ring):
    ring(counts={"call.fused_rx_chain_txconst": 10, "call.raw_rx_txconst_fused": 5,
                 "launch.fused_chain": 10, "launch.raw_chain": 5, "launch.torch": 5})
    assert READERS["entry_launches_per_call"].read(ctx()) == pytest.approx(20 / 15)
    ring(counts={"launch.detect": 3})
    assert READERS["entry_launches_per_call"].read(ctx()) is None


def test_silent_with_nothing_to_read(ring):
    ring()
    for name in NAMES:
        assert READERS[name].read(ctx((0, 1000))) is None, name
    ring(entry_call(1, 100))
    for name in NAMES[:4]:
        assert READERS[name].read(ctx()) is None, name     # no traced slice


def test_silent_without_the_spans_module(monkeypatch):
    """A program that has no ``tpu80211_torch.utils.spans`` (an older
    commit) gives every reader nothing, and none raises."""
    real = builtins.__import__

    def refuse(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "tpu80211_torch.utils" and "spans" in (fromlist or ()):
            raise ImportError("cannot import name 'spans'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", refuse)
    assert program_spans.module() is None
    for name in NAMES:
        assert READERS[name].read(ctx((0, 1000))) is None, name


def test_the_programs_own_ring_reads_through():
    """The real module: an entry call made with spans on is read back."""
    spans = pytest.importorskip("tpu80211_torch.utils.spans")
    spans.clear()
    spans.enable()
    try:
        t0 = time.time_ns()
        with spans.span("entry.e"):
            spans.phase("check")
            spans.phase()
        t1 = time.time_ns()
    finally:
        spans.disable()
    c = types.SimpleNamespace(trace=Trace((t0, t1 + 1), [], [], 0))
    assert READERS["entry_check_us"].read(c) is not None
    assert READERS["entry_self_us"].read(c) >= 0
    spans.clear()
