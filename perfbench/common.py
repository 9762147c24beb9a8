"""What the loops share: their records, the seeded sample of answers, and
the device's fence."""

from __future__ import annotations

import dataclasses
import random

import torch


@dataclasses.dataclass
class Records:
    """A window as the host clock saw it (seconds of ``time.perf_counter``)."""

    t_first: float = 0.0          # the first dispatch
    t_last: float = 0.0           # the last completion
    frames: int = 0               # frames (streams) whose outputs completed
    calls: int = 0                # calls (batches or requests) dispatched
    latencies: list = dataclasses.field(default_factory=list)   # s a request
    entry_ns: list = dataclasses.field(default_factory=list)    # host ns an untraced call

    @property
    def window_s(self) -> float:
        return self.t_last - self.t_first


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed as they come (reservoir sampling), so the whole window is covered
    without knowing its length in advance."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed % 2**64 ^ 0x5EED)
        self.items: list = []
        self.seen = 0

    def offer(self, item):
        """Offers one answer; returns the answer it drops (the offered one
        where it is not kept), or None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return None
        j = self.rng.randrange(self.seen)
        if j < self.k:
            out, self.items[j] = self.items[j], item
            return out
        return item


def sync(device) -> None:
    """Waits for the device (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def in_blocks(n: int, block: int):
    """Slices of ``n`` frames, ``block`` at a time."""
    for i in range(0, n, block):
        yield slice(i, min(i + block, n))
