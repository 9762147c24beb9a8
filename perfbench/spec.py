"""A cell as ``BENCHMARK.json`` names it, and the files that belong to it.

Every piece is found by its name, so a later change adds a configuration,
a traffic mix, a loop or a metric as files of its own:

* ``configs/<config>.json`` (sizes, deployment, entry options) and
  ``configs/<config>.py`` (the entry it drives, the count of its work, its
  reference and comparison);
* ``traffic/<traffic>.json``, whose ``loop`` names ``loops/<loop>.py``;
* ``metrics/<metric>.py`` for every metric of the cell, each with
  ``read(ctx)``;
* ``limits/<workload>.json``, the limit of each number compared.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: pathlib.Path, name: str):
    """Imports a file by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Metric:
    name: str
    entry: dict
    reader: object   # a module with read(ctx) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    module: object   # configs/<config>.py
    traffic: dict
    loop: object     # loops/<loop>.py
    end_to_end: list
    per_layer: list
    limits: dict


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The cell's end-to-end metrics and its per-layer metrics: those that
    list it, and those with no list whose moved metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, cell) and m["moves"] in names]
    return e2e, layer


def load(name: str, base: pathlib.Path = HERE, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repository's
    BENCHMARK.json), its files read from ``base``."""
    bench = bench if bench is not None else benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(work)})")
    w = work[name]
    config = json.loads((base / "configs" / f"{w['config']}.json").read_text())
    module = load_module(base / "configs" / f"{w['config']}.py", f"perfbench_config_{w['config']}")
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    loop = load_module(base / "loops" / f"{traffic['loop']}.py", f"perfbench_loop_{traffic['loop']}")
    e2e, layer = cell_metrics(bench, name)

    def metric(m):
        return Metric(m["name"], m, load_module(base / "metrics" / f"{m['name']}.py",
                                                f"perfbench_metric_{m['name']}"))

    limits = json.loads((base / "limits" / f"{name}.json").read_text())
    return Cell(name, w, config, module, traffic, loop, [metric(m) for m in e2e],
                [metric(m) for m in layer], limits)
