"""A run one rank a card, on the CPU: two ranks in a gloo world at 128
streams a rank, started as the command starts them (`perfbench.world`),
past the harness's look for a card.  Sound, it is correct and pools both
ranks' streams; with a fault on one rank, or the exchange between the
ranks left out, it is not; a rank that raises ends the run non-zero with
no result line and no process left.  Each world has a time limit."""

import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import spec as S
from perfbench.run import run_cell

SMALL = {"batch": 128, "dp": 2, "warm_steps": 1, "count_steps": 3, "sample_steps": 1}
WORLD_S = 300   # a world's time limit


def world(call=None, seed=2**31 + 5):
    """Rank 0 of a two-rank run of montecarlo_a.dp4 at the small size, in a
    process of its own; returns it (stdout, stderr, returncode)."""
    job = {"workload": "montecarlo_a.dp4", "seeds": [seed], "seconds": 0.4, "trace": False,
           "traffic": SMALL, "call": call}
    code = ("import json, sys; from perfbench import world; "
            f"print(json.dumps(world.run_lead({job!r}, 2, 'cpu')[0]))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(S.ROOT),
                                                        os.environ.get("PYTHONPATH", "")])}
    return subprocess.run([sys.executable, "-c", code], cwd=S.ROOT, env=env, capture_output=True,
                          text=True, timeout=WORLD_S)


def result(p) -> dict:
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_sound_run_is_correct_and_pools_both_ranks():
    out = result(world())
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2
    assert set(out["checks"]) == set(S.load("montecarlo_a.dp4").limits)
    # every step ran on both ranks: each step's streams of both counted
    assert out["attempted"] % 2 == 0 and out["attempted"] > 0
    frames_per_s = out["metrics"]["frames_per_s"]["value"]
    assert frames_per_s > 0


@pytest.mark.parametrize("fault", ["altered_on_1", "control_on_1", "half_everywhere",
                                   "unchanged_everywhere", "no_exchange"])
def test_fault_is_not_correct(fault):
    out = result(world(f"perfbench.tests.rank_faults:{fault}"))
    assert not out["correct"], (fault, out["checks"])


def test_a_rank_that_raises_ends_the_run():
    p = world("perfbench.tests.rank_faults:raises_on_1")
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "a fault planted in rank 1's step" in p.stderr
    pids = [int(x) for x in re.search(r"pids \[([\d, ]+)\]", p.stderr).group(1).split(",")]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_frames_are_every_ranks_streams():
    """The pooled window: each rank's streams of every step, summed, over
    the window from the first rank's first dispatch to the last rank's
    last completion."""
    from perfbench.common import Records
    from perfbench.world import pooled

    rec = pooled([Records(t_first=1.0, t_last=2.0, frames=256, calls=2),
                  Records(t_first=0.5, t_last=3.0, frames=256, calls=2)])
    assert (rec.frames, rec.calls, rec.t_first, rec.t_last) == (512, 4, 0.5, 3.0)


def test_one_card_line_keeps_its_keys():
    cell = S.load("raw_a40.bulk")
    cell.traffic = {**cell.traffic, "batch": 8, "ring": 1}
    out = run_cell(cell, 1, 0.2, False, "cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "trace_s", "checks"]
    assert list(out["device"]) == ["platform", "kind", "count", "memory_peak_bytes"]
    assert out["device"]["count"] == 1
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
