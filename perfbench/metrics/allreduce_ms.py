"""allreduce_ms: the device time of the program's all-reduce a step (the
NCCL kernel that ``parallel/mesh.all_reduce`` runs, ``ncclDevKernel_
AllReduce_*``): on each card the median over the traced slice's steps, then
the largest over the cards.  The kernel spins until every rank has joined,
so a rank that comes late shows here.  Silent where no card ran one."""

import statistics


def read(ctx):
    per_card = []
    for tr in ctx.traces:
        times = [e - s for s, e, name in (tr.device if tr is not None else ())
                 if name.startswith("nccl") and "AllReduce" in name]
        if times:
            per_card.append(statistics.median(times))
    return max(per_card) / 1e6 if per_card else None
