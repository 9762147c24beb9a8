"""The small sizes and planted faults of the cells that drive the stream loop.

``test_perfbench_run.py`` runs every cell of ``BENCHMARK.json`` at a small
size on the CPU (its ``SMALL``), with the control and with three planted
faults of a call that returns a batch's outputs (its ``faults``).  A cell
of the stream loop has no such call: its call gives the program's step,
and the loop reads each step back.  So it brings its small size and its
three faults here, and the hook below hands them to that module.  The
faults:

* ``altered``: one answer altered where it is produced, the first sampled
  h_mmse column at bin 10;
* ``half``: half the sampled columns never written (zero);
* ``unchanged``: a step that returns its first answer and state again.
"""

from __future__ import annotations

STREAM_SMALL = {"montecarlo_a.single": dict(batch=128, warm_steps=1, sample_steps=1)}


def stream_faults(cell) -> dict:
    call = cell.module.call

    def wrap(fault):
        def faulty(state, seed, batch):
            step, state0 = call(state, seed, batch)
            return fault(step), state0
        return faulty

    def altered(step):
        def s(i, st):
            summary, h, nxt = step(i, st)
            h.re[10, 0] += 0.5 * (h.re[10, 0].abs() + 1)
            return summary, h, nxt
        return s

    def half(step):
        def s(i, st):
            summary, h, nxt = step(i, st)
            n = h.re.shape[-1]
            h.re[:, n // 2:] = 0
            h.im[:, n // 2:] = 0
            return summary, h, nxt
        return s

    def unchanged(step):
        first = []

        def s(i, st):
            if not first:
                first.append(step(i, st))
            return first[0]
        return s

    return {name: wrap(f) for name, f in
            (("altered", altered), ("half", half), ("unchanged", unchanged))}


def pytest_collection_modifyitems(session, config, items):
    for mod in {item.module for item in items if hasattr(item, "module")}:
        small, faults = getattr(mod, "SMALL", None), getattr(mod, "faults", None)
        if not (isinstance(small, dict) and callable(faults)) or STREAM_SMALL.keys() <= small.keys():
            continue
        small.update(STREAM_SMALL)

        def routed(cell, _bulk=faults):
            return stream_faults(cell) if cell.name in STREAM_SMALL else _bulk(cell)

        mod.faults = routed
