"""The serving loop: requests of ``batch`` frames due at a fixed rate, as a
radio front end hands them on, served one at a time by one caller.

Per request: its samples lie in pinned host memory (a ring of ``ring``
requests made at set-up) from the moment it is due; it uploads them, calls
the entry in serving mode, copies the configuration's served outputs into
pinned host memory, and completes when the host holds them.  A request
that starts late waits, and its latency counts the wait: each is timed
from when it was due.

Parameters (the traffic file): ``batch``, ``ring``, ``rate_per_s`` (0: the
next request is due when the last completes, the closed loop a sweep uses
to find the rate the system sustains), ``sample_requests`` (answers kept
for the check), ``warm_requests``, ``trace_seconds``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from perfbench.common import Records, Reservoir, sync
from perfbench.inputs import frames
from perfbench.reference.compare import Numbers


class Loop:
    def __init__(self, cell, state, call, seed: int, device):
        self.cell, self.state, self.call, self.seed = cell, state, call, seed
        self.device = torch.device(device)
        t = cell.traffic
        self.batch, self.ring_n = t["batch"], t["ring"]
        self.rate = float(t["rate_per_s"])
        self.samples = Reservoir(t["sample_requests"], seed)
        self.served = cell.module.SERVED
        self.pin = self.device.type == "cuda"

    def prepare(self) -> None:
        """The request ring in pinned host memory, the pinned output buffers,
        then ``warm_requests`` whole requests."""
        gen = frames.generator(self.seed, self.device)
        x = self.cell.module.make_batch(self.cell.config, gen, self.batch * self.ring_n)
        self.ring = []
        for s in range(self.ring_n):
            h = x[:, s * self.batch:(s + 1) * self.batch].contiguous().to("cpu")
            self.ring.append(h.pin_memory() if self.pin else h)
        del x
        out = self.call(self.state, self.ring[0].to(self.device), serve=True)
        self.shapes = {k: [(t.shape, t.dtype) for t in _tensors(out[k])] for k in self.served}
        self.pool = [self._buffers() for _ in range(self.samples.k + 2)]
        for i in range(self.cell.traffic["warm_requests"]):
            self._request(self.ring[i % self.ring_n], self.pool[0],
                          lambda name: contextlib.nullcontext())

    def _buffers(self) -> dict:
        return {k: [torch.empty(shape, dtype=dt, pin_memory=self.pin) for shape, dt in v]
                for k, v in self.shapes.items()}

    def _request(self, slot, host: dict, span):
        with span("upload"):
            x = slot.to(self.device, non_blocking=True)
        with span("call"):
            a = time.perf_counter_ns()
            out = self.call(self.state, x, serve=True)
            b = time.perf_counter_ns()
        with span("download"):
            for k in self.served:
                for dst, src in zip(host[k], _tensors(out[k])):
                    dst.copy_(src, non_blocking=True)
        with span("sync"):
            sync(self.device)
        return b - a

    def run(self, seconds: float, tracer) -> Records:
        rec = Records()
        period = 1.0 / self.rate if self.rate > 0 else 0.0
        i = 0
        rec.t_first = t0 = time.perf_counter()
        due = t0
        while True:
            pause = tracer.tick(time.perf_counter() - t0)
            t0 += pause   # the schedule resumes after a pause of the tracer
            due = t0 + i * period if period else due + pause
            if due - t0 >= seconds:
                break
            with tracer.span("idle"):
                while time.perf_counter() < due:
                    pass
            host = self.pool.pop()
            ns = self._request(self.ring[i % self.ring_n], host, tracer.span)
            done = time.perf_counter()
            rec.latencies.append(done - due)
            if not tracer.traced:
                rec.entry_ns.append(ns)
            dropped = self.samples.offer((i, host))
            if dropped is not None:
                self.pool.append(dropped[1])
            if not period:
                due = done
            i += 1
        # requests complete in order: the last to complete is the last one
        rec.t_last = done if i else time.perf_counter()
        rec.calls, rec.frames = i, i * self.batch
        return rec

    def release(self) -> None:
        self.call = None
        self.pool = []

    def check(self, reference) -> dict:
        """Each kept request's host outputs against the reference on its
        request's samples."""
        num = Numbers()
        want = {}
        for i, host in sorted(self.samples.items, key=lambda kv: kv[0]):
            s = i % self.ring_n
            if s not in want:
                want[s] = reference.outputs(self.ring[s].to(self.device))
            got = {k: tuple(t.to(self.device) for t in v) if len(v) > 1 else v[0].to(self.device)
                   for k, v in host.items()}
            self.cell.module.compare(num, got, want[s], serve=True)
        return num.result()


def _tensors(v) -> list:
    return list(v) if isinstance(v, tuple) else [v]
