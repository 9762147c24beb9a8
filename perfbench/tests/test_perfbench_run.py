"""A run on the CPU at a small size, past the harness's look for a card:
sound, it comes out correct; with the control in the program's place, or
with the timed path broken underneath, it does not.  Without a card the
command exits non-zero and prints no result."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec as S
from perfbench.run import forbidden_modules, run_cell

SMALL = {
    "aligned_a40.bulk": dict(batch=48, ring=2),
    "raw_a40.bulk": dict(batch=24, ring=2),
    "aligned_a40.serve512": dict(batch=16, ring=4, warm_requests=2, sample_requests=4,
                                 rate_per_s=40),
}
CELLS = [w["name"] for w in S.benchmark()["workloads"]]


def small(name):
    cell = S.load(name)
    cell.traffic = {**cell.traffic, **SMALL[name]}
    return cell


def run(cell, call=None, seed=2**31 + 5):
    return run_cell(cell, seed, 0.4, False, "cpu", call=call)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(small(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(S.load(name).limits)
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The program on int8 ADC words, the precision below bfloat16."""
    cell = small(name)
    out = run(cell, call=cell.module.control)
    assert not out["correct"], out["checks"]


def _alter(out: dict) -> dict:
    """One answer altered where it is produced: frame 0's eq, block 3."""
    eq = out["eq"]
    eq.re[3, 10, 0] += 0.5 * (eq.re[3, 10, 0].abs() + 1)
    return out


def _half(out: dict, cell) -> dict:
    """Half of the batch left out: the second half's outputs never written."""
    for v in out.values():
        for t in (v if isinstance(v, tuple) else (v,)):
            if t is not None and t.is_floating_point():
                t[..., t.shape[-1] // 2:] = 0
    return out


def faults(cell):
    call = cell.module.call
    prev = {}

    def altered(state, x, **kw):
        return _alter(call(state, x, **kw))

    def half(state, x, **kw):
        return _half(call(state, x, **kw), cell)

    def unchanged(state, x, **kw):
        """A step that returns its state unchanged: the first answer, again."""
        if "out" not in prev:
            prev["out"] = call(state, x, **kw)
        return prev["out"]

    return {"altered": altered, "half": half, "unchanged": unchanged}


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault):
    cell = small(name)
    out = run(cell, call=faults(cell)[fault])
    assert not out["correct"], (fault, out["checks"])


def test_no_card_exits_non_zero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "aligned_a40.bulk",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=S.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu80211_torch_extra", sys)
    assert "tpu80211_torch_extra" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu80211.ops", sys)
    assert "tpu80211.ops" in forbidden_modules()


def test_a_run_loads_no_jax():
    """A whole run (the program included) in a fresh process leaves no
    module of JAX or of the JAX package loaded."""
    code = ("import json, sys; from perfbench import spec as S; from perfbench.run import "
            "run_cell, forbidden_modules; c = S.load('raw_a40.bulk'); "
            "c.traffic = {**c.traffic, 'batch': 8, 'ring': 1}; "
            "out = run_cell(c, 1, 0.2, False, 'cpu'); "
            "print(json.dumps([out['correct'], forbidden_modules(), "
            "'tpu80211_torch' in sys.modules]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, [], True]
