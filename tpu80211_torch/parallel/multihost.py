"""Process worlds and hierarchical meshes (the counterpart of
``tpu80211/parallel/multihost.py``).

The JAX package runs one process per host over that host's chips and
brings the hosts together with ``jax.distributed``; the port runs one
process per device and brings them together with ``torch.distributed``:

* `init_distributed` starts this process's world (idempotent): from
  explicit arguments, from ``torchrun``'s environment, or, with neither, a
  world of one after a warning;
* `hierarchical_mesh` is the ('host', 'dp', 'blk') `DeviceMesh`, hosts
  counted as world size over ``LOCAL_WORLD_SIZE``;
* `frame_sharding_mh` is this rank's rows of a batch split jointly over
  ('host', 'dp').

On a card the backend is NCCL, which takes one rank per card; several
ranks on one card pass ``backend="gloo"`` (gloo's all-reduce takes CUDA
tensors, through host memory).
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu80211_torch.parallel.mesh import BLK, DP, frame_rows

HOST = "host"
TIMEOUT_S = 600.0   # how long a collective waits for the other ranks


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """This rank's device: ``device`` as given if it is the CPU or names its
    card; a bare "cuda" is card ``LOCAL_RANK`` (else the rank) modulo the
    cards present.  No card for a CUDA device raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is present "
                           "(pass device='cpu' to run on the CPU)")
    if dev.index is not None:
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device="cuda") -> None:
    """Start this process's ``torch.distributed`` world (idempotent).

    ``coordinator_address`` (``tcp://host:port``, ``host:port`` or
    ``file:///path``) with ``num_processes`` and ``process_id``: an explicit
    world, whose failure raises (a cluster that silently runs as one host
    is what this guards against).  Without them, ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); without that either, a
    warning and a world of one.  ``backend``: NCCL for a CUDA ``device``,
    gloo for the CPU, unless given.  On a card, this rank's card
    (`rank_device`) becomes the current one."""
    if coordinator_address is not None and (num_processes is None or process_id is None):
        raise ValueError("an explicit world needs num_processes and process_id")
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator_address is not None:
        if "://" not in coordinator_address:
            coordinator_address = "tcp://" + coordinator_address
        rank = process_id
        kw = dict(init_method=coordinator_address, world_size=num_processes, rank=process_id)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        kw = dict(init_method="env://")
    else:
        warnings.warn("no coordinator address and no torchrun environment: a world of one "
                      "process (pass coordinator_address, num_processes and process_id, or "
                      "start under torchrun, for more)", stacklevel=2)
        rank = 0
        kw = dict(store=dist.HashStore(), world_size=1, rank=0)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, rank))
    dist.init_process_group(backend, timeout=timeout, **kw)


def hierarchical_mesh(blk: int = 1, device="cuda") -> DeviceMesh:
    """('host', 'dp', 'blk') mesh over the whole world: ``LOCAL_WORLD_SIZE``
    ranks a host (all of them without it), ``dp`` = that over ``blk``.
    Every rank of the world calls it (it creates the groups)."""
    world = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % n_local or n_local % blk:
        raise ValueError(f"world {world}, {n_local} ranks a host, blk {blk}: no (host, dp, blk) mesh")
    ranks = torch.arange(world).reshape(world // n_local, n_local // blk, blk)
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=(HOST, DP, BLK))


def frame_sharding_mh(mesh: DeviceMesh, batch: int) -> slice:
    """This rank's rows of a ``batch``-frame array split jointly over
    ('host', 'dp'): every rank of the job takes batch / (hosts·dp) frames."""
    return frame_rows(mesh, batch, (HOST, DP))
