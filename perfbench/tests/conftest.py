"""The small sizes and planted faults of the cells that drive the stream loop.

``test_perfbench_run.py`` runs every cell of ``BENCHMARK.json`` at a small
size on the CPU (its ``SMALL``), with the control and with three planted
faults of a call that returns a batch's outputs (its ``faults``).  A cell
of the stream loop has no such call: its call gives the program's step,
and the loop reads each step back.  So it brings its small size and its
three faults here (`rank_faults.altered`, ``half`` and ``unchanged``), and
the hook below hands them to that module.
"""

from __future__ import annotations

from perfbench.tests import rank_faults

# montecarlo_a.dp4 here: its mesh step in a world of one (dp 1); two ranks
# run in test_perfbench_ranks.py
STREAM_SMALL = {"montecarlo_a.single": dict(batch=128, warm_steps=1, sample_steps=1),
                "montecarlo_a.dp4": dict(batch=128, dp=1, warm_steps=1, count_steps=3,
                                         sample_steps=1)}


def stream_faults(cell) -> dict:
    return {name: rank_faults.wrap(cell.module.call, getattr(rank_faults, name))
            for name in ("altered", "half", "unchanged")}


def pytest_collection_modifyitems(session, config, items):
    for mod in {item.module for item in items if hasattr(item, "module")}:
        small, faults = getattr(mod, "SMALL", None), getattr(mod, "faults", None)
        if not (isinstance(small, dict) and callable(faults)) or STREAM_SMALL.keys() <= small.keys():
            continue
        small.update(STREAM_SMALL)

        def routed(cell, _bulk=faults):
            return stream_faults(cell) if cell.name in STREAM_SMALL else _bulk(cell)

        mod.faults = routed
