"""Scaling of the receive step over mesh shapes (the counterpart of
``tpu80211/bench/scaling.py``, itself the analogue of the reference's
frame-group sweep, main_mpi.c:1032-1080).

`sweep` runs inside a process world, one process per device (every rank
calls it): for each (dp, blk) shape that fits the world, the ranks
0 … dp·blk − 1 form a sub-mesh and run ``parallel.rx_step_shardmap`` on
their shards of one batch; the other ranks wait for the next shape.  Rank
0's rows give frames/s and the efficiency against the one-device row
scaled linearly.

    torchrun --nproc-per-node=N -m tpu80211_torch.bench.scaling   # N cards, NCCL
"""

from __future__ import annotations

import json

import torch
import torch.distributed as dist

from tpu80211_torch.datasets import synthetic
from tpu80211_torch.parallel import make_mesh, pad_blocks, rx_step_shardmap, shard_batch
from tpu80211_torch.parallel.mesh import shard_blocks
from tpu80211_torch.parallel.multihost import init_distributed, rank_device
from tpu80211_torch.utils.timing import timeit


def _inputs(batch: int, blk: int, nb_pad: int):
    """One batch on the host, every rank alike: (tx_pre, rx_pre, tx_blocks,
    rx_blocks padded to nb_pad, ow2)."""
    fb = synthetic.generate(torch.Generator().manual_seed(0), batch)
    return (fb.tx_preamble_fft, fb.rx_preamble_fft, pad_blocks(fb.tx_symb, blk)[:, :nb_pad],
            pad_blocks(fb.rx_symb, blk)[:, :nb_pad], fb.ow2)


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
        mesh = make_mesh(dp=dp, blk=blk, ranks=range(ndev), device=device)
        if mesh.get_coordinate() is None:
            continue
        step, nb_pad = rx_step_shardmap(mesh)
        tx_pre, rx_pre, txb, rxb, ow2 = _inputs(batch, blk, nb_pad)
        pre = shard_batch(mesh, (tx_pre, rx_pre, ow2), dev)
        blocks = shard_blocks(mesh, (txb, rxb), dev)
        dt = timeit(step, pre[0], pre[1], *blocks, pre[2], iters=iters, device=dev)
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


if __name__ == "__main__":
    init_distributed()
    result = sweep()
    if dist.get_rank() == 0:
        for row in result:
            print(json.dumps(row))
    dist.destroy_process_group()
