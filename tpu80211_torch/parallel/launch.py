"""An n-rank ``torch.distributed`` world on this host, for tests, the dry
run and ``chip_smoke.py``.

`launch(fn, n, *args)` spawns n processes, starts each one's world through
a ``file://`` store in a temporary directory (no TCP port to pick, so
worlds started side by side never race for one), runs ``fn(*args)`` on
every rank, and returns rank 0's result.  ``fn`` and ``args`` are pickled
into each process (``fn`` by its import path).  A rank that raises ends
the world: the others are stopped and its traceback is raised here.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pathlib
import pickle
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from tpu80211_torch.parallel.multihost import TIMEOUT_S, init_distributed


def _rank_main(rank: int, n: int, tmp: str, fn: Callable, args: tuple, device, backend,
               env: dict) -> None:
    """One rank: its world, ``fn(*args)``, rank 0's result (or this rank's
    traceback) written under ``tmp``."""
    os.environ.update(env)
    # the ranks share this host's cores: each takes its share, where torch's
    # default (a thread per core in every process) oversubscribes them n-fold
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    tmp = pathlib.Path(tmp)
    try:
        init_distributed(f"file://{tmp / 'store'}", n, rank, backend=backend, device=device)
        result = fn(*args)
        if rank == 0:
            (tmp / "result.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        # written before the world goes down, so it precedes the errors
        # of the ranks that were waiting for this one
        (tmp / f"error.{rank}").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n: int, *args, device="cuda", backend: str | None = None,
           env: dict | None = None):
    """Run ``fn(*args)`` on every rank of a new n-process world and return
    rank 0's result.  ``device`` and ``backend`` go to `init_distributed`
    (NCCL on a card, gloo on the CPU, unless ``backend`` says otherwise);
    ``env`` is set in every rank before its world starts.  Raises
    RuntimeError with the failing rank's traceback, or TimeoutError after
    `multihost.TIMEOUT_S`; no process outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tpu80211-world-") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(rank, n, tmp, fn, args, device, backend, dict(env or {})))
                 for rank in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        running, failed = list(procs), False
        try:
            while running and not failed and time.monotonic() < deadline:
                multiprocessing.connection.wait([p.sentinel for p in running],
                                                max(deadline - time.monotonic(), 0.0))
                running = [p for p in procs if p.exitcode is None]
                failed = any(p.exitcode for p in procs)   # the others would wait for it
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join()
        tmp = pathlib.Path(tmp)
        # the first rank to fail; the others may fail after it, waiting for it
        errors = sorted(tmp.glob("error.*"), key=lambda f: f.stat().st_mtime_ns)
        if errors:
            raise RuntimeError(f"rank {errors[0].suffix[1:]} of {n} failed:\n"
                               + errors[0].read_text())
        if failed:
            raise RuntimeError(f"ranks exited with codes {[p.exitcode for p in procs]}")
        if running:
            raise TimeoutError(f"the {n}-rank world did not finish in {TIMEOUT_S} s")
        return pickle.loads((tmp / "result.pkl").read_bytes())
