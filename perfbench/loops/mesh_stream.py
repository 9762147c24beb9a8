"""The mesh stream loop: the stream loop over the program's mesh step, one
rank a card.

Each rank drives the configuration's call with ``mesh=make_mesh(dp=dp)``
(the program's ``make_device_stream_step(batch · dp, …, mesh=…)``) through
the program's own ``device_stream``, as `loops/stream.py` drives the step
on one card: ``batch`` streams a card (the traffic's, else the
configuration's), the summaries pooled by one all-reduce over dp a step.
The program starts its world from torchrun's environment, which
`perfbench.world` gives every rank; without it, a world of one.

The ranks run the same steps: a rank that stopped on its own clock would
leave the others waiting in the all-reduce.  After the warm steps every
rank runs ``count_steps`` more, timed on rank 0 (the median time from one
step's readback to the next); the window then runs ``--seconds`` over
that step time, rounded, on every rank, and the traced
slice opens at the same step on every rank.

Parameters (the traffic file): those of `loops/stream.py`, ``dp`` (ranks a
step, one a card) and ``count_steps`` (three or more).

Records: this rank's streams of every step read back in its window, from
its first dispatch to its last readback.  The check: each rank holds its
own streams of the kept steps against the reference, and rank 0 pools the
sums (the configuration's ``rank_part`` and ``pooled_numbers``).
"""

from __future__ import annotations

import itertools
import math
import statistics
import time
import warnings

import torch

from perfbench.common import sync
from perfbench.loops import stream


class Loop(stream.Loop):
    def __init__(self, cell, state, call, seed: int, device, world=None):
        super().__init__(cell, state, call, seed, device)
        self.world = world
        self.dp = cell.traffic["dp"]
        self.count = cell.traffic["count_steps"]

    def prepare(self) -> None:
        """The program's world and mesh, its step for this run's seed, the
        warm steps, then the timed ones that fix the window's step count."""
        import torch.distributed as dist

        from tpu80211_torch.parallel import mesh, multihost
        from tpu80211_torch.pipeline.stream import device_stream

        self.owned = self.world is None and not dist.is_initialized()
        with warnings.catch_warnings():
            if self.owned:   # no torchrun environment: the world of one is meant
                warnings.simplefilter("ignore")
            multihost.init_distributed(device=self.device)
        self.mesh = mesh.make_mesh(dp=self.dp, device=self.device)
        self.rank = mesh.axis(self.mesh, mesh.DP)[1]
        self.stream = device_stream
        self.step, state = self.call(self.state, self.seed, self.batch * self.dp, mesh=self.mesh)
        self.state_in = int(state)
        for _, _, self.state_in in device_stream(self.step, state, range(self.warm)):
            pass
        sync(self.device)
        state = torch.tensor(self.state_in, dtype=torch.int32, device=self.device)
        done = []
        for _, _, self.state_in in device_stream(self.step, state,
                                                 range(self.warm, self.warm + self.count)):
            done.append(time.perf_counter())
        sync(self.device)
        # the median step between readbacks that each came after a dispatch
        # (all but the last), so that one stall of the host does not shorten
        # the window
        step_s = statistics.median(b - a for a, b in zip(done[:-2], done[1:-1]))
        self.step_s = step_s if self.world is None else self.world.broadcast("step_s", step_s)
        self.warm += self.count

    def run(self, seconds: float, tracer):
        """`stream.Loop.run` over a fixed number of steps, the same on every
        rank, with the traced slice opened at a step, not on the clock."""
        steps = max(1, round(seconds / self.step_s))
        traced_from = min(int(tracer.start_at / self.step_s), steps // 2)
        drive = self.stream
        self.stream = lambda step, state, indices: drive(step, state,
                                                         itertools.islice(indices, steps))
        try:
            return super().run(math.inf, _AtStep(tracer, traced_from))
        finally:
            self.stream = drive

    def release(self) -> None:
        super().release()
        self.mesh = None
        if self.owned:
            import torch.distributed as dist

            dist.destroy_process_group()

    def check(self, reference) -> dict | None:
        """This rank's streams of the kept steps against the reference; on
        rank 0 the numbers over every rank's, None on the others."""
        kept = {k[0]: k for k in self.samples.items}
        if self.last is not None:
            kept[self.last[0]] = self.last
        mod = self.cell.module
        part = mod.rank_part(reference, self.cell.config, self.seed, self.rank, self.batch,
                             [kept[k] for k in sorted(kept)])
        parts = [part] if self.world is None else self.world.gather("check", part)
        if parts is None:
            return None
        return mod.pooled_numbers(parts, self.batch * self.dp, reference.evm_den)


class _AtStep:
    """The tracer, its slice opened at step ``first`` of the window rather
    than on the clock: at the same step on every rank, so that the
    profiler's start pauses every rank together."""

    def __init__(self, tracer, first: int):
        self.tracer, self.first, self.k = tracer, first, 0

    def tick(self, elapsed: float) -> float:
        k, self.k = self.k, self.k + 1
        return self.tracer.tick(math.inf if k >= self.first else -math.inf)

    def __getattr__(self, name):
        return getattr(self.tracer, name)
