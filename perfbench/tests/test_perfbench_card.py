"""On the card: each cell's command at its own sizes, and its control.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture).  On the card:

    python -m pytest perfbench/tests/test_perfbench_card.py -q
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec as S

CELLS = [w["name"] for w in S.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")


def cards(name) -> int:
    """The cards the cell asks for; skips where the machine has fewer."""
    chips = S.load(name).workload["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{name} needs {chips} CUDA devices")
    return chips


def command(*args) -> dict:
    p = subprocess.run([sys.executable, "-m", *args], cwd=S.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(card, name, trace):
    chips = cards(name)
    out = command("perfbench.run", "--workload", name, "--seed", str(2**31 + 11),
                  "--seconds", "3", "--trace", str(trace))
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == chips
    e2e, layer = S.cell_metrics(S.benchmark(), name)
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(out["metrics"]) <= want and out["metrics"]
    if trace:
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    """The cell's control: at least one number over its limit."""
    cards(name)
    out = command("perfbench.readings", "--workload", name, "--seeds", str(2**31 + 12),
                  "--seconds", "1", "--control")
    assert not out["correct"], out["checks"]
