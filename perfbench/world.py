"""One process a card for a cell whose ``chips`` is n > 1, and what the
ranks exchange.

The process the command started is rank 0, on ``cuda:0``: it reads the
program's spans and counters and prints the line, as a one-card run does.
`spawn` starts ranks 1 … n−1, one process each (``python -m
perfbench.world``), rank r on ``cuda:r`` (the CPU in the tests), each with
torchrun's environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), from which the
program starts its own world (``parallel.multihost.init_distributed``) as
under ``torchrun --nproc-per-node n``.  What the harness exchanges (the job,
the step time, the windows, the traces, the check's sums) goes through a
``TCPStore`` of its own that rank 0 serves, never through the program's
collectives.

Rank 0 starts the other ranks (`spawn`) before it loads torch or the cell,
so that their start overlaps its own.  Every rank runs the same job
(`run_job`): the same cell, seeds and steps.  A watchdog in every rank
bounds the waits: rank 0 ends the run, and every rank with it, with exit
code 5 and no result line, when a rank exits non-zero or a stage outlasts
its allowance; a rank above 0 ends itself when its allowance runs out, and
the kernel ends it when rank 0's process ends (``PR_SET_PDEATHSIG``).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import datetime
import importlib
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback

from perfbench import spec as S
from perfbench.run import forbidden_modules, run_cell

# torch is imported where it is used: a rank starts before it is loaded

SETUP_S = 1100.0   # a rank's set-up, the first run's nvcc build included
AFTER_S = 300.0    # past --seconds: the traced slice's reduction and the check
EXIT_S = 60.0      # for every rank to end once rank 0 has its results
ENDED = 5          # the exit code of a run that the watchdog ended


class World:
    """This rank's view of the run: its rank, the world's size, the
    harness's store, and (rank 0) the other ranks' processes."""

    def __init__(self, rank: int, size: int, store, procs=()):
        self.rank, self.size, self.store, self.procs = rank, size, store, list(procs)
        self.exchanges = 0
        self.deadline = time.monotonic() + SETUP_S
        self.done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def allow(self, seconds: float) -> None:
        """The current stage ends within ``seconds`` from now."""
        self.deadline = time.monotonic() + seconds

    def _watch(self) -> None:
        while not self.done.wait(0.2):
            why = None
            bad = [(r, p.poll()) for r, p in enumerate(self.procs, 1) if p.poll()]
            if bad:
                why = f"rank {bad[0][0]} exited with code {bad[0][1]}"
            if why is None and time.monotonic() > self.deadline:
                why = "a stage outlasted its allowance"
            if why is not None:
                self.end(why)

    def end(self, why: str) -> None:
        """Ends this rank's process, and on rank 0 every other rank's, with
        exit code `ENDED`."""
        print(f"perfbench: rank {self.rank}: {why}; the run ends", file=sys.stderr, flush=True)
        self.kill()
        os._exit(ENDED)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _key(self, name: str) -> str:
        # every rank makes the same exchanges in the same order
        self.exchanges += 1
        return f"{self.exchanges}.{name}"

    def gather(self, name: str, obj):
        """Every rank's ``obj`` in rank order on rank 0; None on the others."""
        key = self._key(name)
        if self.rank:
            self.store.set(f"{key}.{self.rank}", pickle.dumps(obj))
            return None
        keys = [f"{key}.{r}" for r in range(1, self.size)]
        if keys:
            self.store.wait(keys)
        return [obj, *(pickle.loads(self.store.get(k)) for k in keys)]

    def broadcast(self, name: str, obj=None):
        """Rank 0's ``obj`` on every rank."""
        key = self._key(name)
        if self.rank == 0:
            self.store.set(key, pickle.dumps(obj))
            return obj
        self.store.wait([key])
        return pickle.loads(self.store.get(key))

    def open_window(self, seconds: float) -> None:
        """Once every rank is set up: the window opens on every rank together
        and must end, its check with it, within `AFTER_S` past ``seconds``."""
        self.gather("ready", None)
        self.broadcast("open")
        self.allow(seconds + AFTER_S)

    def pool(self, rec, trace, peak: int):
        """The ranks' windows as one, on rank 0: the `pooled` records, every
        rank's trace (rank 0's first) and the fullest card's peak.  The
        other ranks get their own."""
        parts = self.gather("window", (rec, _compact(trace), peak))
        if parts is None:
            return rec, [trace], peak
        recs, traces, peaks = zip(*parts)
        return pooled(recs), [trace, *traces[1:]], max(peaks)

    def close(self) -> None:
        """The program's world closed; on rank 0, every other rank has ended
        with code 0 (else the run ends)."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        self.allow(EXIT_S)
        for p in self.procs:
            p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs, 1) if p.returncode]
        if bad:
            self.end(f"rank {bad[0][0]} exited with code {bad[0][1]}")
        self.done.set()


def pooled(recs):
    """The ranks' `Records` as one window: every rank's frames and calls,
    from the earliest first dispatch to the latest last completion (the
    rest rank 0's).  ``time.perf_counter`` is ``CLOCK_MONOTONIC`` on Linux,
    one clock for every process of the host, so the ranks' times compare
    directly."""
    return dataclasses.replace(recs[0], t_first=min(r.t_first for r in recs),
                               t_last=max(r.t_last for r in recs),
                               frames=sum(r.frames for r in recs),
                               calls=sum(r.calls for r in recs))


def _compact(trace):
    """``trace`` with its device names interned, so each name is pickled once."""
    if trace is None:
        return None
    return dataclasses.replace(trace, device=[(s, e, sys.intern(n)) for s, e, n in trace.device])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, size: int, master_port: int) -> dict:
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(size),
            "LOCAL_WORLD_SIZE": str(size), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(master_port)}


def _threads(size: int) -> int:
    """The ranks share the host's cores: each takes its share."""
    return max(1, (os.cpu_count() or 1) // size)


def _store(port: int, master: bool):
    """Rank 0's store, or a rank's client of it (which retries until rank 0
    serves it)."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", port, None, master,
                         timeout=datetime.timedelta(seconds=SETUP_S + AFTER_S),
                         wait_for_workers=False)


def _device(device_type: str, rank: int):
    import torch

    if device_type != "cuda":
        return torch.device(device_type)
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    return dev


def run_job(world: World, job: dict, device, t_start: float | None = None) -> list:
    """This rank's runs of ``job`` (``workload``, ``seeds``, ``seconds``,
    ``trace``; optionally ``traffic`` and ``config`` overrides, and ``call``:
    "control", or "module:factory" whose ``factory(cell, rank)`` gives this
    rank's call, None for the configuration's).  Rank 0 gets each seed's
    result line fields; the others Nones."""
    import torch

    cell = S.load(job["workload"])
    cell.traffic = {**cell.traffic, **job.get("traffic", {})}
    cell.config = {**cell.config, **job.get("config", {})}
    call = job.get("call")
    if call == "control":
        call = cell.module.control
    elif call is not None:
        mod, name = call.split(":")
        call = getattr(importlib.import_module(mod), name)(cell, world.rank)
    outs = []
    for seed in job["seeds"]:
        world.allow(SETUP_S)
        outs.append(run_cell(cell, seed, job["seconds"], job["trace"], device, call=call,
                             t_start=t_start, world=world))
        t_start = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return outs


@dataclasses.dataclass
class Spawned:
    """Ranks 1 … size−1, started, and the port of the store they will join."""

    size: int
    port: int
    procs: list

    def kill(self) -> None:
        for p in self.procs:
            p.kill()
            p.wait()


def spawn(size: int, device_type: str = "cuda") -> Spawned:
    """Starts ranks 1 … size−1 (``python -m perfbench.world``), each with
    torchrun's environment, and gives this process rank 0's."""
    port, master = _free_port(), _free_port()
    procs = []
    for r in range(1, size):
        env = {**os.environ, **torchrun_env(r, size, master),
               "OMP_NUM_THREADS": str(_threads(size)), "PERFBENCH_RANK0_PID": str(os.getpid())}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "perfbench.world", "--store", str(port), "--device",
             device_type], env=env, cwd=S.ROOT, stdin=subprocess.DEVNULL,
            stdout=sys.stderr.fileno()))
    os.environ.update(torchrun_env(0, size, master))
    print(f"perfbench: ranks 1-{size - 1}: pids {[p.pid for p in procs]}", file=sys.stderr,
          flush=True)
    return Spawned(size, port, procs)


def run_lead(job: dict, ranks: Spawned | int, device_type: str = "cuda",
             t_start: float | None = None) -> list[dict]:
    """Rank 0: runs ``job`` on every rank of ``ranks`` (started by `spawn`,
    or a number of ranks to start now) and returns rank 0's results once every
    rank has ended with code 0.  Any failure ends the process (exit
    non-zero, no result) and every rank."""
    import torch

    if isinstance(ranks, int):
        ranks = spawn(ranks, device_type)
    try:
        world = World(0, ranks.size, _store(ranks.port, True), ranks.procs)
    except BaseException:
        ranks.kill()
        raise
    try:
        torch.set_num_threads(_threads(ranks.size))
        world.broadcast("job", job)
        outs = run_job(world, job, _device(device_type, 0), t_start)
        world.close()
        return outs
    except BaseException:
        traceback.print_exc()
        world.end("raised")


def main(argv=None) -> int:
    """A rank above 0: joins the store, takes the job, runs it, checks its
    modules, and ends."""
    # ended by the kernel when rank 0's process ends, however it ends
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    if os.getppid() != int(os.environ["PERFBENCH_RANK0_PID"]):
        return ENDED   # rank 0 ended before this rank asked
    p = argparse.ArgumentParser(prog="python -m perfbench.world")
    p.add_argument("--store", type=int, required=True, help="the port of rank 0's store")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    import torch

    torch.set_num_threads(_threads(size))
    world = World(rank, size, _store(args.store, False))
    try:
        job = world.broadcast("job")
        run_job(world, job, _device(args.device, rank))
        found = forbidden_modules()
        if found:
            print(f"perfbench: rank {rank}: modules of JAX or the JAX package are loaded: "
                  f"{', '.join(found)}", file=sys.stderr, flush=True)
            os._exit(3)
        world.close()
        return 0
    except BaseException:
        traceback.print_exc()
        world.end("raised")


if __name__ == "__main__":
    sys.exit(main())
