"""Scaling of the receive step over mesh shapes (the counterpart of
``tpu80211/bench/scaling.py``, itself the analogue of the reference's
frame-group sweep, main_mpi.c:1032-1080), and the sweep's record (the port
of ``scripts/bench_scaling.py``).

`sweep` runs inside a process world, one process per device (every rank
calls it): for each (dp, blk) shape that fits the world, the ranks
0 … dp·blk − 1 form a sub-mesh and run ``parallel.rx_step_shardmap`` on
their shards of one batch; the other ranks wait for the next shape.  Rank
0's rows give frames/s and the efficiency against the one-device row
scaled linearly.

    python -m tpu80211_torch.bench.scaling                  # the record, and a card's world of one
    python -m tpu80211_torch.bench.scaling --device cpu --world 2   # the record alone, on the CPU
    torchrun --nproc-per-node=N -m tpu80211_torch.bench.scaling   # N cards, NCCL: the sweep

The record (`record`): the six `SHAPES` in a gloo world of ``--world`` (8)
CPU processes started by ``parallel.launch``, the counterpart of the
script's virtual 8-device CPU mesh, with each shape's all-reduces as one
step makes them (counted and grouped at ``parallel.mesh.all_reduce``, the
port's one collective; any other ``torch.distributed`` collective is
recorded too); a row of two gloo processes, dp = 2, whose dp all-reduce
crosses the process boundary; the reference's clock-tick table; and with
``--device cuda`` (the default; no card exits 1) the card's world of one
on NCCL.  As the script says of its own: the CPU rows time processes that
share this host's cores, a structure check, not a prediction for cards.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.datasets import synthetic
from tpu80211_torch.parallel import launch, make_mesh, pad_blocks, rx_step_shardmap, shard_batch
from tpu80211_torch.parallel import mesh as M
from tpu80211_torch.parallel.mesh import shard_blocks
from tpu80211_torch.parallel.multihost import init_distributed, rank_device
from tpu80211_torch.utils.timing import timeit

SHAPES = [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (2, 4)]
WORLD, BATCH, ITERS = 8, 4096, 5
TWO_BATCH = 1024        # the two-process row's frames
TWO_OW2 = 0.25
OTHER_COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_to_all", "all_to_all_single",
                     "reduce_scatter", "reduce_scatter_tensor", "broadcast", "reduce", "send",
                     "recv", "isend", "irecv")
# main_mpi.c:1032-1080: (MPI+OMP, pure MPI) elapsed clock ticks, groups x size over 20 ranks
REFERENCE_CLOCK_TICKS = {
    "comment": "main_mpi.c:1032-1080 (MPI+OMP / pure MPI elapsed, groups x size over 20 ranks)",
    "1x20": [10470000, 24160000], "2x10": [17430000, 38140000],
    "4x5": [26060000, 64840000], "5x4": [33950000, 80390000],
    "10x2": [57360000, 146370000], "20x1": [109650000, 274340000],
}
CAVEAT = ("the CPU rows time gloo processes sharing this host's cores - structure checks, not "
          "predictions for cards; the transferable property is the collective inventory (dp is "
          "collective-free; dp x blk has exactly the two intended all-reduces)")


def _inputs(batch: int, blk: int, nb_pad: int):
    """One batch on the host, every rank alike: (tx_pre, rx_pre, tx_blocks,
    rx_blocks padded to nb_pad, ow2)."""
    fb = synthetic.generate(torch.Generator().manual_seed(0), batch)
    return (fb.tx_preamble_fft, fb.rx_preamble_fft, pad_blocks(fb.tx_symb, blk)[:, :nb_pad],
            pad_blocks(fb.rx_symb, blk)[:, :nb_pad], fb.ow2)


def _shape_step(dp: int, blk: int, batch: int, device):
    """The shard-map step on the sub-mesh of ranks 0 … dp·blk − 1 and this
    rank's arguments; None on a rank outside it (every rank must call)."""
    mesh = make_mesh(dp=dp, blk=blk, ranks=range(dp * blk), device=device)
    if mesh.get_coordinate() is None:
        return None
    dev = rank_device(device)
    step, nb_pad = rx_step_shardmap(mesh)
    tx_pre, rx_pre, txb, rxb, ow2 = _inputs(batch, blk, nb_pad)
    pre = shard_batch(mesh, (tx_pre, rx_pre, ow2), dev)
    blocks = shard_blocks(mesh, (txb, rxb), dev)
    return step, (pre[0], pre[1], *blocks, pre[2])


def sweep(batch: int = 4096, iters: int = 5, shapes=None, device="cuda") -> list[dict]:
    """One dict per (dp, blk) shape that fits the world: frames/s, ms per
    step, and the efficiency against the one-device row scaled linearly
    (rank 0's clock: CUDA events on a card, the host clock on the CPU).
    Every rank of the world calls it; shapes larger than the world are
    skipped."""
    n = dist.get_world_size()
    if shapes is None:
        shapes = [(1, 1)] + [(n // b, b) for b in (1, 2, 4) if n % b == 0]
    dev = rank_device(device)
    rows, base_fps = [], None
    for dp, blk in shapes:
        ndev = dp * blk
        if ndev > n:
            continue
        made = _shape_step(dp, blk, batch, device)
        if made is None:
            continue
        step, args = made
        dt = timeit(step, *args, iters=iters, device=dev)
        fps = batch / dt
        if base_fps is None and ndev == 1:
            base_fps = fps
        eff = fps / (base_fps * ndev) if base_fps else None
        rows.append({
            "dp": dp, "blk": blk, "devices": ndev,
            "frames_per_s": round(fps, 1),
            "ms_per_step": round(dt * 1e3, 3),
            "scaling_efficiency": round(eff, 3) if eff is not None else None,
        })
    return rows


@contextlib.contextmanager
def _recording():
    """Record every collective made inside: the all-reduces' groups (through
    ``parallel.mesh.all_reduce``), and the names of any other
    ``torch.distributed`` collective called."""
    calls, others = [], []
    plain = M.all_reduce
    saved = {name: getattr(dist, name) for name in OTHER_COLLECTIVES if hasattr(dist, name)}

    def all_reduce(t, group):
        calls.append(tuple(dist.get_process_group_ranks(group)))
        return plain(t, group)

    def other(name):
        def call(*args, **kw):
            others.append(name)
            return saved[name](*args, **kw)
        return call

    M.all_reduce = all_reduce
    for name in saved:
        setattr(dist, name, other(name))
    try:
        yield calls, others
    finally:
        M.all_reduce = plain
        for name, fn in saved.items():
            setattr(dist, name, fn)


def inventory(shapes, batch: int, device) -> list[dict | None]:
    """Each shape's collectives in one step on this rank: {"all_reduce": its
    groups in call order, "other": other collectives}; None where the shape
    does not fit the world or this rank is outside its sub-mesh (every rank
    calls)."""
    res = []
    for dp, blk in shapes:
        made = _shape_step(dp, blk, batch, device) if dp * blk <= dist.get_world_size() else None
        if made is None:
            res.append(None)
            continue
        step, args = made
        with _recording() as (calls, others):
            step(*args)
        res.append({"all_reduce": calls, "other": others})
    return res


def _groups(records: list) -> list[str]:
    """The replica groups of each all-reduce, over every rank's record of one
    shape (the script's ``{{0,1},{2,3}}`` form)."""
    records = [r for r in records if r is not None]
    return ["{" + ",".join("{" + ",".join(map(str, g)) + "}"
                           for g in sorted({r["all_reduce"][k] for r in records})) + "}"
            for k in range(len(records[0]["all_reduce"]))]


def record_world(batch: int, iters: int, shapes) -> list[dict]:
    """Every rank of a CPU world: `sweep` over ``shapes`` and each shape's
    collective inventory; rank 0's rows with the inventory of every rank."""
    rows = sweep(batch, iters, shapes, device="cpu")
    inv = inventory(shapes, batch, "cpu")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, inv)
    if dist.get_rank() != 0:   # rank 0 is in every sub-mesh; the others' rows are partial
        return rows
    fits = [k for k, (dp, blk) in enumerate(shapes) if dp * blk <= dist.get_world_size()]
    base = rows[0]["frames_per_s"]
    for row, k in zip(rows, fits):
        records = [rank_inv[k] for rank_inv in every]
        row["speedup_vs_1dev"] = round(row["frames_per_s"] / base, 3)
        row["all_reduce_count"] = len(inv[k]["all_reduce"])
        row["all_reduce_groups"] = _groups(records)
        row["other_collectives"] = sorted({o for r in records if r for o in r["other"]})
    return rows


def two_process_world(batch: int = TWO_BATCH, iters: int = ITERS) -> dict:
    """Every rank of a two-process CPU world: the shard-map step over
    dp = 2 on synthetic frames (seed 7, σ² = 0.25), rank 0's row."""
    mesh = make_mesh(dp=2, blk=1, device="cpu")
    step, nb_pad = rx_step_shardmap(mesh)
    fb = synthetic.generate(torch.Generator().manual_seed(7), batch)
    ow2 = torch.full((batch,), TWO_OW2, dtype=torch.float32)
    pre = shard_batch(mesh, (fb.tx_preamble_fft, fb.rx_preamble_fft, ow2), "cpu")
    blocks = shard_blocks(mesh, tuple(pad_blocks(b, 1)[:, :nb_pad]
                                      for b in (fb.tx_symb, fb.rx_symb)), "cpu")
    args = (pre[0], pre[1], *blocks, pre[2])
    dt = timeit(step, *args, iters=iters, device="cpu")
    return {
        "config": "2-process torch.distributed (gloo), (dp=2, blk=1), the dp all-reduce "
                  "crosses the process boundary",
        "processes": 2, "devices": 2, "frames_per_s": round(batch / dt, 1),
        "ms_per_step": round(dt * 1e3, 3), "metric": float(step(*args)[1]),
    }


def run_sweep(batch: int = BATCH, iters: int = ITERS, device="cuda", shapes=None):
    """`sweep` in the world ``torchrun`` set up, or else in a world of one
    brought up in this process and taken down after: (rows, this rank)."""
    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if own and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_distributed(device=device)
        elif own:
            init_distributed(f"file://{tmp}/store", 1, 0, device=device)
        try:
            return sweep(batch=batch, iters=iters, shapes=shapes, device=device), dist.get_rank()
        finally:
            if own:
                dist.destroy_process_group()


def record(world: int = WORLD, batch: int = BATCH, iters: int = ITERS, device="cuda") -> dict:
    """The script's document, the card's world of one added on a card."""
    rows = launch.launch(record_world, world, batch, iters, SHAPES, device="cpu")
    two = launch.launch(two_process_world, 2, device="cpu")
    doc = {
        "metric": "shard-map RX step scaling sweep (dp x blk), the analogue of the reference's "
                  "frame-group table (main_mpi.c:1032-1080; BASELINE.md)",
        "backend": f"a gloo world of {world} CPU processes on one host",
        "caveat": CAVEAT, "rows": rows, "distributed_2process": two,
        "reference_sweep_clock_ticks": REFERENCE_CLOCK_TICKS,
    }
    if torch.device(device).type == "cuda":
        doc["card_world_of_one"] = {"device": TP.device_name(device), "backend": "nccl",
                                    "rows": run_sweep(batch, iters, device)[0]}
    return doc


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("scaling", __doc__)
    ap.add_argument("--world", type=int, default=WORLD,
                    help=f"processes of the CPU world (default {WORLD})")
    ap.add_argument("--batch", type=int, default=BATCH, help=f"frames a step (default {BATCH})")
    ap.add_argument("--iters", type=int, default=ITERS, help=f"steps timed (default {ITERS})")
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # under torchrun: the sweep
        rows, rank = run_sweep(args.batch, args.iters, args.device)
        if rank == 0:
            for row in rows:
                CM.emit(row)
        return 0
    if CM.open_device(args.device, "scaling") is None:
        return 1
    doc = record(args.world, args.batch, args.iters, args.device)
    for row in doc["rows"]:
        CM.emit(row)
    CM.emit(doc["distributed_2process"])
    last = {
        "metric": "scaling record: [dp, blk, frames/s, all-reduces] on the CPU world",
        "backend": doc["backend"],
        "rows": [[r["dp"], r["blk"], r["frames_per_s"], r["all_reduce_count"]]
                 for r in doc["rows"]],
        "two_process_frames_per_s": doc["distributed_2process"]["frames_per_s"],
    }
    if "card_world_of_one" in doc:
        card = doc["card_world_of_one"]
        last["card"] = {"device": card["device"],
                        "rows": [[r["dp"], r["blk"], r["frames_per_s"]] for r in card["rows"]]}
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
