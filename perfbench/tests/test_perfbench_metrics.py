"""The metric arithmetic: the trace's union, gaps and breakdown on
synthetic event lists, the readers, and a stall that lowers frames_per_s
and raises request_p95_ms."""

import time
import types

import pytest

from perfbench import spec as S
from perfbench.common import Records, Reservoir
from perfbench.peaks import least_time_s
from perfbench.run import run_cell
from perfbench.trace import Trace, breakdown, gaps, union

READERS = {m["name"]: S.load_module(S.HERE / "metrics" / f"{m['name']}.py", f"m_{m['name']}")
           for m in S.benchmark()["end_to_end"] + S.benchmark()["per_layer"]}


def ctx(trace=None, records=None, work=None):
    return types.SimpleNamespace(trace=trace, records=records or Records(), setup_s=1.5,
                                 kind="NVIDIA H100 80GB HBM3",
                                 work=work or {"ops": 0, "tc_ops": 0, "bytes": 3.35e9})


def test_union_counts_overlap_once():
    assert union([(0, 10, "a"), (5, 12, "b"), (20, 30, "c")]) == [(0, 12), (20, 30)]
    assert gaps((0, 40), [(0, 12), (20, 30)]) == [(12, 20), (30, 40)]


def test_trace_readers():
    # 4 calls in 100 ms; a kernel of 10 ms each, a copy overlapping one of them
    dev = [(i * 25_000_000, i * 25_000_000 + 10_000_000, "void raw_chain_kernel<1>(P)")
           for i in range(4)] + [(5_000_000, 15_000_000, "Memcpy DtoH")]
    spans = [(i * 25_000_000, i * 25_000_000 + 1_000_000, "call") for i in range(4)]
    spans += [(i * 25_000_000 + 15_000_000, i * 25_000_000 + 25_000_000, "sync") for i in range(4)]
    tr = Trace((0, 100_000_000), dev, spans, 4)
    assert tr.busy_s() == pytest.approx(0.045)
    assert tr.kernel_s("raw_chain_kernel") == pytest.approx(0.040)
    c = ctx(tr)   # least time 1 ms (3.35 GB at 3.35 TB/s)
    assert READERS["device_idle_pct"].read(c) == pytest.approx(55.0)
    assert READERS["kernel_roofline_pct"].read(c) == pytest.approx(100 * 0.001 / (0.045 / 4))
    assert READERS["raw_chain_roofline"].read(c) == pytest.approx(10.0)
    assert READERS["fused_chain_roofline"].read(c) is None    # silent: that kernel never ran
    assert READERS["launches_per_request"].read(c) == pytest.approx(5 / 4)
    b = breakdown(tr)
    assert b["device_ops"][0] == ["void raw_chain_kernel<1>(P)", pytest.approx(0.04)]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle["sync"] == pytest.approx(0.04) and idle["other"] == pytest.approx(0.015)
    assert sum(idle.values()) == pytest.approx(0.055)


def test_untraced_readers_are_silent():
    c = ctx()
    for name in ("kernel_roofline_pct", "device_idle_pct", "launches_per_request",
                 "fused_chain_roofline", "entry_host_us", "request_p95_ms", "frames_per_s"):
        assert READERS[name].read(c) is None, name
    assert READERS["setup_s"].read(c) == 1.5


def test_host_clock_readers():
    rec = Records(t_first=1.0, t_last=3.0, frames=1000, calls=10,
                  latencies=[0.001] * 95 + [0.010] * 5, entry_ns=[100_000, 300_000, 200_000])
    c = ctx(records=rec)
    assert READERS["frames_per_s"].read(c) == pytest.approx(500.0)
    assert READERS["entry_host_us"].read(c) == pytest.approx(200.0)
    assert 1.0 <= READERS["request_p95_ms"].read(c) <= 10.0


def test_least_time():
    assert least_time_s({"ops": 67e12, "tc_ops": 0, "bytes": 1.0}) == pytest.approx(1.0)
    assert least_time_s({"ops": 0, "tc_ops": 989e12, "bytes": 3.35e12}) == pytest.approx(1.0)


def test_reservoir_is_seeded_and_uniform_in_size():
    def kept(seed):
        r = Reservoir(3, seed)
        for i in range(100):
            r.offer(i)
        return sorted(r.items)

    assert kept(5) == kept(5) and len(kept(5)) == 3 and kept(5) != kept(6)


def stalled(call, at: int, seconds: float):
    n = [0]

    def wrapped(state, x, **kw):
        n[0] += 1
        if n[0] == at:
            time.sleep(seconds)
        return call(state, x, **kw)

    return wrapped


def small(name, **over):
    cell = S.load(name)
    cell.traffic = {**cell.traffic, **over}
    return cell


def test_a_stall_lowers_frames_per_s():
    cell = small("aligned_a40.bulk", batch=16, ring=2)
    base = run_cell(cell, 1, 1.0, False, "cpu")["metrics"]["frames_per_s"]["value"]
    # the stall comes after set-up's warm-up calls (one a ring batch)
    slow = run_cell(cell, 1, 1.0, False, "cpu", call=stalled(cell.module.call, 4, 0.5))
    assert slow["metrics"]["frames_per_s"]["value"] < 0.8 * base


def test_a_stall_raises_request_p95_ms():
    over = dict(batch=8, ring=4, warm_requests=2, sample_requests=4, rate_per_s=100)
    cell = small("aligned_a40.serve512", **over)
    base = run_cell(cell, 2, 1.0, False, "cpu")["metrics"]["request_p95_ms"]["value"]
    warm = 1 + over["warm_requests"]
    slow = run_cell(cell, 2, 1.0, False, "cpu", call=stalled(cell.module.call, warm + 5, 0.3))
    assert slow["metrics"]["request_p95_ms"]["value"] > max(100.0, 3 * base)
