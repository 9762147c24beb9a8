"""The stream loop: one caller driving the program's own device stream.

The configuration's ``call(state, seed, batch)`` gives the program's step
and its first state; the program's own loop (``device_stream`` of
``tpu80211_torch.pipeline.stream``) dispatches each step ahead and reads
the step before it back behind it: its summaries, its sampled estimates
and the carried state.  Nothing but the seed enters a step from the host.

Parameters (the traffic file): ``warm_steps`` run through the same loop at
set-up (every SNR of the cycle, so every constant is made and the kernel
built), ``sample_steps`` (steps kept for the check beside the last one),
``trace_seconds``, and optionally ``batch`` (else the configuration's).

Records: the streams of every step read back in the window, from the first
dispatch to the last readback.
"""

from __future__ import annotations

import time

import torch

from perfbench.common import Records, Reservoir, sync


class Loop:
    def __init__(self, cell, state, call, seed: int, device):
        self.cell, self.state, self.call, self.seed = cell, state, call, seed
        self.device = torch.device(device)
        t = cell.traffic
        self.batch = t.get("batch", cell.config["batch"])
        self.warm = t["warm_steps"]
        self.samples = Reservoir(t["sample_steps"], seed)
        self.last = None

    def prepare(self) -> None:
        """The program's step for this run's seed, then the warm steps."""
        from tpu80211_torch.pipeline.stream import device_stream

        self.stream = device_stream
        self.step, state = self.call(self.state, self.seed, self.batch)
        self.state_in = int(state)
        for _, _, self.state_in in device_stream(self.step, state, range(self.warm)):
            pass
        sync(self.device)

    def run(self, seconds: float, tracer) -> Records:
        rec = Records()
        readback = []

        def indices():
            i = self.warm
            rec.t_first = t0 = time.perf_counter()
            while True:
                t0 += tracer.tick(time.perf_counter() - t0)   # the window resumes after a pause
                if time.perf_counter() - t0 >= seconds:
                    return
                yield i
                i += 1

        def step(i, state):
            with tracer.span("call"):
                a = time.perf_counter_ns()
                out = self.step(i, state)
                b = time.perf_counter_ns()
            if not tracer.traced:
                rec.entry_ns.append(b - a)
            rec.calls += 1
            span = tracer.span("readback")   # until the step before it is on the host
            span.__enter__()
            readback.append(span)
            return out

        state = torch.tensor(self.state_in, dtype=torch.int32, device=self.device)
        prev = self.state_in
        for i, record, after in self.stream(step, state, indices()):
            while readback:
                readback.pop().__exit__(None, None, None)
            with tracer.span("record"):
                kept = (i, prev, record)
                self.samples.offer(kept)
                self.last = kept
                prev = after
                rec.frames += self.batch
        sync(self.device)
        rec.t_last = time.perf_counter()
        return rec

    def release(self) -> None:
        self.step = self.call = None

    def check(self, reference) -> dict:
        """The kept steps' summaries and samples against the reference on
        the streams drawn from the seed word each of them used."""
        kept = {k[0]: k for k in self.samples.items}
        if self.last is not None:
            kept[self.last[0]] = self.last
        mod, cfg = self.cell.module, self.cell.config
        num = mod.Numbers(self.batch)
        for i, state_in, record in (kept[k] for k in sorted(kept)):
            want = reference.step(mod.seed_word(self.seed, i, state_in), mod.snr_of(cfg, i),
                                  self.batch, record["h_mmse_sample"].shape[0])
            mod.compare(num, record, want)
        return num.result()
