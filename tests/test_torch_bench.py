"""The port's bench (``python -m tpu80211_torch.bench.throughput``) rehearsed
on the CPU, where every wrapper runs its plain version: the rows build,
gate and time at a small B; the last line's keys and length; a failed gate
and a missing card exit non-zero; the new modules import no JAX."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from tpu80211_torch.bench import throughput as TP

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROW_KEYS = {"per_s", "ms", "bms", "fa", "idle", "gates"}


def _bench(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "tpu80211_torch.bench.throughput", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})


def test_cli_rehearsal_prints_one_gated_line(tmp_path):
    """``--device cpu 256 2``: every default row at B=256, loop length 2,
    each gate passed and carried; the last line one JSON object under 1,500
    characters, headed by the tx-constant row; ``--out`` the full rows."""
    out = _bench("--device", "cpu", "256", "2", "--out", str(tmp_path / "rows.json"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) < 1500
    res = json.loads(lines[0])
    assert {"metric", "unit", "value", "vs_baseline", "device", "rows"} <= set(res)
    assert res["device"] == "cpu" and res["unit"] == "frames/s"
    assert list(res["rows"]) == list(TP.DEFAULT_ROWS)
    assert res["value"] == pytest.approx(res["rows"]["txconst"]["per_s"], rel=1e-3)
    for name, row in res["rows"].items():
        assert set(row) == ROW_KEYS, name
        assert row["ms"][0] is None and row["ms"][1] > 0 and row["bms"][1] > 0, name
        assert row["idle"] is None  # no events on the CPU: never a device number
    for name in ("txconst", "fused", "txserve", "txi8"):
        assert res["rows"][name]["gates"] == {"finite": True, "err": [0.0, 0.0, 0.0, 0.0]}
    for name in ("raw", "raw32"):
        g = res["rows"][name]["gates"]
        assert g["detect"] == 1.0 and -4 <= g["band"][0] <= g["band"][1] <= -2 and g["evm"] < 0.1
    g = res["rows"]["genraw"]["gates"]
    assert g["detect"] == 1.0 and g["in_band"] >= 0.85 and g["evm"] < 0.1 and g["finite"]
    assert res["rows"]["dense"]["gates"]["err"] < 5e-5
    full = json.loads((tmp_path / "rows.json").read_text())
    assert set(full) == {"meta", *TP.DEFAULT_ROWS}
    row = full["txconst"]
    assert {"per_s", "per_s_batch_marginal", "fence_agreement", "loop_ms", "batch_ms",
            "idle_share", "marginals_s", "gates", "unit", "batch", "iters"} <= set(row)
    assert (row["batch"], row["iters"]) == (256, 2) and len(row["marginals_s"]["loop"]) == 3


def test_cli_without_a_card_exits_nonzero():
    """No CUDA device and no ``--device cpu``: a message and exit 1, never a
    timing of the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run on it")
    out = _bench("--txconst", "256", "2", timeout=120)
    assert out.returncode != 0
    assert out.stdout == "" and "no CUDA device" in out.stderr


def test_plain_row_gates_and_fences():
    row = TP.run_row("plain", batch=64, iters=2, device="cpu")
    assert row["gates"] == {"finite": True, "err": [0.0, 0.0, 0.0]}
    assert row["unit"] == "frames/s" and row["per_s"] > 0
    assert row["loop_ms"]["event"] is None and row["loop_ms"]["host"] > 0
    assert row["fence_agreement"] == pytest.approx(row["per_s_batch_marginal"] / row["per_s"])


def test_a_failed_gate_raises_before_timing(monkeypatch):
    """A gate that fails stops its row before any timing."""
    timed = []
    monkeypatch.setattr(TP, "measure", lambda *a: timed.append(a) or {})
    monkeypatch.setitem(TP.CHAIN_TOL, "h", -1.0)
    with pytest.raises(TP.GateError, match="txconst: gate failed"):
        TP.run_row("txconst", batch=64, iters=1, device="cpu")
    monkeypatch.setattr(TP, "NOISE", 0.5)  # streams too noisy to detect every frame
    with pytest.raises(TP.GateError, match="raw"):
        TP.run_row("raw", batch=64, iters=1, device="cpu")
    assert timed == []


def test_genraw_refuses_a_batch_off_the_lane_granule():
    with pytest.raises(ValueError, match="multiples of 128"):
        TP.run_row("genraw", batch=384, iters=1, device="cpu")


def test_line_with_card_numbers_stays_under_the_limit():
    """Every default row with numbers of the widths the card gives (events,
    idle share, rates of 1e8) stays under 1,500 characters."""
    row = {"unit": "frames/s", "per_s": 123456789.123, "per_s_batch_marginal": 120000000.5,
           "fence_agreement": 0.97234567, "idle_share": 0.0123456789,
           "loop_ms": {"event": 0.60123456, "host": 0.61234567},
           "batch_ms": {"event": 0.30123456, "host": 0.31234567}}
    gates = {"txconst": {"finite": True, "err": [1.234567e-05, 2.345678e-05, 0.00312345,
                                                 1.234567e-05]},
             "raw": {"detect": 1.0, "band": [-4, -2], "evm": 0.0221234, "finite": True},
             "genraw": {"detect": 1.0, "in_band": 0.9041234, "evm": 0.0675123, "finite": True},
             "dense": {"err": 3.561234e-06, "systems": 8}}
    rows = {name: {**row, "gates": gates.get(name, gates["raw" if "raw" in name else "txconst"])}
            for name in TP.DEFAULT_ROWS}
    line = json.dumps(TP.summary(rows, "cpu"), separators=(",", ":"))
    assert len(line) < TP.MAX_LINE, len(line)


def test_new_modules_import_no_jax():
    """In a fresh interpreter, the modules this layer adds load neither
    ``jax`` nor ``tpu80211``."""
    mods = ["tpu80211_torch.utils.timing", "tpu80211_torch.utils.metrics",
            "tpu80211_torch.utils.checks", "tpu80211_torch.datasets.native_engine",
            "tpu80211_torch.pipeline.stream", "tpu80211_torch.bench.throughput",
            "tpu80211_torch.bench.quality"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'tpu80211' or m.startswith('tpu80211.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
