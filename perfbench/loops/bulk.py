"""The bulk loop: one caller, the configuration's batch a call, at most
``in_flight`` calls queued on the card, the outputs left there.

Parameters (the traffic file): ``ring`` distinct input batches made at
set-up, ``in_flight``, ``sample_calls`` (calls kept for the check beside
the last one), ``trace_seconds``, and optionally ``batch`` (else the
configuration's).

Records: the frames of every call dispatched in the window, from the first
dispatch to the last completion (the device drained after the window).
"""

from __future__ import annotations

import collections
import time

import torch

from perfbench.common import Records, Reservoir, in_blocks, sync
from perfbench.inputs import frames
from perfbench.reference.compare import Numbers

REF_BLOCK = 8192  # frames a reference block


class Loop:
    def __init__(self, cell, state, call, seed: int, device):
        self.cell, self.state, self.call, self.seed = cell, state, call, seed
        self.device = torch.device(device)
        t = cell.traffic
        self.batch = t.get("batch", cell.config["batch"])
        self.ring_n, self.in_flight = t["ring"], t["in_flight"]
        self.samples = Reservoir(t["sample_calls"], seed)
        self.last = None

    def prepare(self) -> None:
        """The input ring, then every batch of it through the call once."""
        gen = frames.generator(self.seed, self.device)
        self.ring = [self.cell.module.make_batch(self.cell.config, gen, self.batch)
                     for _ in range(self.ring_n)]
        for x in self.ring:
            self.call(self.state, x)
        sync(self.device)

    def run(self, seconds: float, tracer) -> Records:
        rec = Records()
        cuda = self.device.type == "cuda"
        queued = collections.deque()
        i = 0
        rec.t_first = t0 = time.perf_counter()
        while True:
            if len(queued) == self.in_flight:
                with tracer.span("wait"):
                    queued.popleft().synchronize()
            t0 += tracer.tick(time.perf_counter() - t0)   # the window resumes after a pause
            if time.perf_counter() - t0 >= seconds:
                break
            x = self.ring[i % self.ring_n]
            with tracer.span("call"):
                a = time.perf_counter_ns()
                out = self.call(self.state, x)
                b = time.perf_counter_ns()
            with tracer.span("record"):
                if not tracer.traced:
                    rec.entry_ns.append(b - a)
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    queued.append(ev)
                self.samples.offer((i, out))
                self.last = (i, out)
            i += 1
        sync(self.device)
        rec.t_last = time.perf_counter()
        rec.calls, rec.frames = i, i * self.batch
        return rec

    def release(self) -> None:
        """Drops every output but the kept ones."""
        self.call = None

    def check(self, reference) -> dict:
        """The kept calls' outputs against the reference on their inputs."""
        kept = {i: out for i, out in self.samples.items}
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        num = Numbers()
        mod = self.cell.module
        for i, out in sorted(kept.items()):
            x = self.ring[i % self.ring_n]
            for sl in in_blocks(self.batch, REF_BLOCK):
                want = reference.outputs(x[:, sl].contiguous())
                got = {k: _cut(v, sl) for k, v in out.items() if v is not None}
                mod.compare(num, got, want, serve=False)
        return num.result()


def _cut(v, sl: slice):
    if isinstance(v, tuple):
        return tuple(t[..., sl] for t in v)
    return v[..., sl]
