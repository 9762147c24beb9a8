"""Planted faults of the stream cells' steps, and of a run one rank a card.

A step fault wraps the program's step ``step(i, state) -> (summary,
sample_h, next state)``:

* `altered`: one answer altered where it is produced, the first sampled
  h_mmse column at bin 10;
* `half`: half the sampled columns never written (zero);
* `unchanged`: a step that returns its first answer and state again.

A rank fault is named in a `perfbench.world` job as
``perfbench.tests.rank_faults:<name>``: ``<name>(cell, rank)`` gives the call
that rank drives (None: the configuration's own).
"""

from __future__ import annotations


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


def wrap(call, fault):
    """``call`` (the configuration's, or its control) with ``fault`` around
    the step it gives."""
    def faulty(state, seed, batch, **kw):
        step, state0 = call(state, seed, batch, **kw)
        return fault(step), state0
    return faulty


def altered_on_1(cell, rank):
    """Rank 1's first sampled column altered; rank 0 sound."""
    return wrap(cell.module.call, altered) if rank == 1 else None


def control_on_1(cell, rank):
    """The control (no CFO) on rank 1 alone."""
    return cell.module.control if rank == 1 else None


def half_everywhere(cell, rank):
    return wrap(cell.module.call, half)


def unchanged_everywhere(cell, rank):
    return wrap(cell.module.call, unchanged)


def no_exchange(cell, rank):
    """The exchange between the cards left out: the program's one collective
    (``parallel.mesh.all_reduce``) returns this rank's own sums."""
    from tpu80211_torch.parallel import mesh

    mesh.all_reduce = lambda t, group: t
    return None


def raises_on_1(cell, rank):
    """Rank 1's step raises at the first step of the window."""
    if rank != 1:
        return None
    first = cell.traffic["warm_steps"] + cell.traffic.get("count_steps", 0)

    def fault(step):
        def s(i, st):
            if i >= first:
                raise RuntimeError(f"a fault planted in rank 1's step {i}")
            return step(i, st)
        return s
    return wrap(cell.module.call, fault)
