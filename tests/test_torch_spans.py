"""The program's spans and counters (``tpu80211_torch/utils/spans.py``) on
the CPU: off, spans and phases record nothing and open no profiler range;
on, each record lies on the profiler's own clock, spans and phases nest by
parent and call id, and the ring keeps its bound; set-up spans record with
spans off; the counters add up across threads."""

import statistics
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.utils import spans

from _torch_inputs import lane_major, make_frames, torch_planes

ENTRY = "entry.fused_rx_chain_txconst"


@pytest.fixture
def fresh():
    """Empty rings, spans off, before and after the test."""
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


@pytest.fixture(scope="module")
def chain_inputs():
    tx_pkt, rx_pkt, tx_lp, rx_lp = make_frames(11, 4, tx_const=True)
    txc = F.tx_spectra(torch_planes(tx_pkt[0]), torch_planes(tx_lp[0]))
    return txc, torch_planes(lane_major(rx_pkt)), torch_planes(lane_major(rx_lp))


def _call(chain_inputs):
    txc, rp, rl = chain_inputs
    return F.fused_rx_chain_txconst(*txc, rp, rl, serve=True)


def test_off_records_nothing_and_opens_no_range(fresh, chain_inputs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} opened with spans off")

    monkeypatch.setattr(spans, "_range", refuse)
    assert not spans.on()
    assert spans.span("a") is spans.span("b")   # the one shared null context
    with spans.span("a"):
        spans.phase("p")
        with spans.span("b"):
            pass
        spans.phase()
    _call(chain_inputs)
    assert spans.records() == [] and spans._recording == 0


def test_off_leaves_no_event_in_a_later_trace(fresh, chain_inputs):
    _call(chain_inputs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not any(n.startswith(spans.PREFIX) for n in names)
    assert spans.records() == []


def test_profiler_turns_spans_on_and_shares_its_clock(fresh, chain_inputs):
    """Under ``torch.profiler`` every record has its kineto event and lies
    inside it, and the two clocks agree: the median distance of the records'
    starts from their events' starts is within 50 µs, and so is that of the
    ends.  The median, since on a loaded CPU one record can be preempted
    between its range and its stamp."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.on()
        for _ in range(3):
            _call(chain_inputs)
            with spans.span("outer"):
                with spans.span("inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                spans.phase("part")
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert not spans.on()
    recs = spans.records()
    assert [r.name for r in recs].count(ENTRY) == 3
    assert [r.name for r in recs].count("part") == 3
    events: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            events.setdefault(e.name()[len(spans.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    starts, ends = [], []
    for name in {r.name for r in recs}:
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (s, e), (ks, ke) in zip(mine, theirs):
            assert ks <= s <= e <= ke, (name, s - ks, e - ke)
            starts.append(s - ks)
            ends.append(ke - e)
    assert statistics.median(starts) <= 50_000, sorted(starts)
    assert statistics.median(ends) <= 50_000, sorted(ends)


def test_parent_and_call_id_nest(fresh):
    """Phases and spans inside a span name it as their parent and share its
    call id; a phase ends where the next starts; a span inside a span
    nests under it; the next top-level span opens a new call."""
    spans.enable()
    with spans.span("entry.x"):
        spans.phase("check")
        spans.phase()
        spans.phase("outputs")
        spans.phase("launch")
        with spans.span("inner"):
            with spans.span("deep"):
                pass
        spans.phase()
    with spans.span("entry.x"):
        pass
    spans.disable()
    recs = spans.records()
    first, second = sorted({r.call_id for r in recs})
    by = {r.name: r for r in recs if r.call_id == first}
    assert set(by) == {"entry.x", "check", "outputs", "launch", "inner", "deep"}
    assert [r.name for r in recs if r.call_id == second] == ["entry.x"]
    assert by["entry.x"].parent is None
    for name in ("check", "outputs", "launch", "inner"):
        assert by[name].parent == "entry.x", name
        assert by["entry.x"].start_ns <= by[name].start_ns <= by[name].end_ns <= by["entry.x"].end_ns
    assert by["deep"].parent == "inner"
    assert by["outputs"].end_ns <= by["launch"].start_ns
    assert spans._recording == 0


def test_a_raising_call_closes_its_open_phase_and_keeps_the_nesting(fresh):
    spans.enable()
    with pytest.raises(ValueError):
        with spans.span("entry.x"):
            spans.phase("check")
            raise ValueError("bad plane")
    with spans.span("entry.y"):
        spans.phase("launch")
    spans.disable()
    recs = {r.name: r for r in spans.records()}
    assert recs["check"].parent == "entry.x" and recs["check"].end_ns <= recs["entry.x"].end_ns
    assert recs["launch"].parent == "entry.y"
    assert recs["entry.y"].parent is None and recs["entry.y"].call_id != recs["entry.x"].call_id
    assert spans._recording == 0


def test_a_phase_outside_any_span_records_nothing(fresh):
    spans.enable()
    spans.phase("check")
    spans.phase()
    spans.disable()
    assert spans.records() == []


def test_the_ring_keeps_its_bound(fresh):
    spans.enable()
    n = spans.RING_RECORDS + 100
    for _ in range(n):
        with spans.span("s"):
            pass
    spans.disable()
    recs = spans.records()
    assert len(spans.ring) == len(recs) == spans.RING_RECORDS
    first = recs[0].call_id
    assert [r.call_id - first for r in recs] == list(range(spans.RING_RECORDS))


def test_enable_and_disable(fresh):
    assert not spans.on()
    spans.enable()
    assert spans.on()
    with spans.span("a"):
        pass
    spans.disable()
    assert not spans.on()
    with spans.span("b"):
        pass
    assert [r.name for r in spans.records()] == ["a"]


def test_consts_setup_span_records_once_per_cache_miss(fresh):
    """With spans off, a cache miss of the chain's constants records one
    ``setup.consts`` span and a hit records none."""
    prior = ("C", 17.25)   # a prior no other test asks for: a miss here
    F.chain_consts("cpu", *prior)
    F.chain_consts("cpu", *prior)
    F.chain_consts(torch.device("cpu"), *prior)
    consts = [r for r in spans.records() if r.name == "setup.consts"]
    assert len(consts) == 1 and consts[0].parent is None
    assert spans.ring.maxlen == spans.RING_RECORDS and len(spans.ring) == 0
    F.chain_consts("cpu", "C", 17.5)
    assert [r.name for r in spans.records()].count("setup.consts") == 2


def test_tx_spectra_setup_span_encloses_its_consts(fresh):
    F._chain_consts.cache_clear()
    tx_pkt, _, tx_lp, _ = make_frames(12, 1, tx_const=True)
    F.tx_spectra(torch_planes(tx_pkt[0]), torch_planes(tx_lp[0]))
    recs = {r.name: r for r in spans.records()}
    assert recs["setup.consts"].parent == "setup.tx_spectra"
    assert recs["setup.consts"].call_id == recs["setup.tx_spectra"].call_id


def test_leaf_setup_spans_overlap_without_nesting(fresh):
    outer = spans.setup_span("load.x")
    with outer:
        a, b = spans.setup_span("build.a", leaf=True), spans.setup_span("build.b", leaf=True)
        a.__enter__()
        b.__enter__()
        a.__exit__(None, None, None)
        b.__exit__(None, None, None)
        with spans.setup_span("inner"):
            pass
    recs = {r.name: r for r in spans.records()}
    assert recs["setup.build.a"].parent == recs["setup.build.b"].parent == "setup.load.x"
    assert recs["setup.inner"].parent == "setup.load.x"
    assert recs["setup.build.a"].start_ns <= recs["setup.build.b"].start_ns
    assert recs["setup.build.a"].end_ns <= recs["setup.build.b"].end_ns


def test_counters_count_snapshot_and_reset():
    c = spans.Counters()
    step = c.counter("launch.x")
    c.counter("launch.never")
    step()
    c.count("launch.x", 2)
    c.count("call.e")
    snap = c.snapshot()
    assert snap == {"launch.x": 3, "call.e": 1}
    step()
    assert snap["launch.x"] == 3 and c.snapshot()["launch.x"] == 4
    c.reset()
    assert c.snapshot() == {}
    step()
    assert c.snapshot() == {"launch.x": 1}


def test_entry_calls_count_on_the_cpu(chain_inputs):
    before = spans.counters.snapshot()
    _call(chain_inputs)
    after = spans.counters.snapshot()
    assert after.get("call.fused_rx_chain_txconst", 0) == before.get(
        "call.fused_rx_chain_txconst", 0) + 1
    # the plain version launches nothing
    assert {k: v for k, v in after.items() if k.startswith("launch.")} == {
        k: v for k, v in before.items() if k.startswith("launch.")}


def test_counters_lose_no_update_across_threads():
    """More threads than cores, a short switch interval: every count lands."""
    c = spans.Counters()
    n_threads, n = 32, 2_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        step = c.counter("launch.x")

        def work():
            for _ in range(n):
                step()

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.snapshot() == {"launch.x": n_threads * n}
