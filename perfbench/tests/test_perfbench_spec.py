"""BENCHMARK.json and the files it names: shape, names, units, and that a
cell, a mix or a metric is added as files without an edit."""

import copy
import json
import pathlib
import re
import shutil

import pytest

from perfbench import spec as S

BENCH = S.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # the whole check fits its time when 24 cells run at this length
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_keys_sources_and_bounds():
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_moves_is_reported_by_every_listed_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            e2e, _ = S.cell_metrics(BENCH, cell)
            assert m["moves"] in {x["name"] for x in e2e}, (m["name"], cell)


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e, layer = S.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer, w["name"]


def test_cells_configs_and_chips():
    work = BENCH["workloads"]
    assert 1 <= len(work) <= 24 and 1 <= len(BENCH["configs"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in work]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in work} == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] in (1, 4) for w in work)
    assert sum(w["chips"] == 4 for w in work) <= max(1, len(work) // 4)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((S.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = S.load(cell)
    assert hasattr(c.loop, "Loop") and hasattr(c.module, "call")
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader.read)
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())


def test_a_new_cell_mix_and_metric_are_files(tmp_path):
    """A copy of the folder takes a new traffic mix, a new metric and a new
    cell as new files and entries, with no file edited."""
    base = tmp_path / "perfbench"
    shutil.copytree(S.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((base / "traffic" / "bulk.json").read_text())
    mix.update(in_flight=1, ring=2)
    (base / "traffic" / "bulk1.json").write_text(json.dumps(mix))
    (base / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.records.calls)\n")
    (base / "limits" / "aligned_a40.bulk1.json").write_text(
        (base / "limits" / "aligned_a40.bulk.json").read_text())
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "aligned_a40.bulk1", "config": "aligned_a40",
                               "traffic": "bulk1", "chips": 1, "why": "one in flight"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "entry wrappers",
                               "moves": "frames_per_s", "workloads": ["aligned_a40.bulk1"]})
    cell = S.load("aligned_a40.bulk1", base=base, bench=bench)
    assert cell.traffic["in_flight"] == 1
    assert [m.name for m in cell.per_layer] == ["calls_seen"]
    assert pathlib.Path(cell.per_layer[0].reader.__file__).parent == base / "metrics"
