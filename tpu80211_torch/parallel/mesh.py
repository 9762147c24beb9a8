"""The ('dp', 'blk') mesh over a process world, and the receive step on it
(the counterpart of ``tpu80211/parallel/mesh.py``).

The JAX package runs one process over many chips: a `Mesh`, shardings,
and ``shard_map`` with ``lax.psum``.  The port runs one process per device
(``parallel/multihost.py`` starts the world), so the mesh is a
``torch.distributed`` `DeviceMesh` and every function here works on this
rank's shard:

* ``dp`` splits the frames: rank (d, b) holds rows d·B/dp … (d+1)·B/dp,
  the order ``P("dp")`` gives (`frame_sharding`, `shard_batch`);
* ``blk`` splits each frame's 15 OFDM blocks, padded to a multiple of
  ``blk`` (`pad_blocks`, `shard_blocks`): the order ``P("dp", "blk")``
  gives.

`rx_chain_dp` runs the chain on the rank's frames with no collective (frames
are independent).  `rx_step_shardmap` makes exactly two all-reduces a step,
as the JAX step's compiled program does: one over ``blk`` carrying the six
block sums of the 4-block average (XLA's combiner merges the JAX step's six
``psum`` into one; here they are packed into one tensor), and one over
``dp`` carrying the global metric.  Every collective of the port goes
through `all_reduce`, so a test can count them and read their groups.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import tree_map
from tpu80211_torch.kernels.mmse_solve import fused_rank1_solve
from tpu80211_torch.models.ps_interp import ps_interp_per_block
from tpu80211_torch.models.ps_mmse import vdot
from tpu80211_torch.pipeline import sc

DP, BLK = "dp", "blk"
SOLVERS = ("sm", "dense")
_KINDS = ("linear", "cubic", "sinc", "spline", "wiener")


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``group`` and return it: the one
    place the port calls a collective."""
    dist.all_reduce(t, group=group)
    return t


def axis(mesh: DeviceMesh, name: str):
    """(size, this rank's index, process group) of the mesh axis ``name``."""
    i = mesh.mesh_dim_names.index(name)
    return mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)


def make_mesh(dp: int | None = None, blk: int = 1, ranks: Sequence[int] | None = None,
              device="cuda") -> DeviceMesh:
    """A ('dp', 'blk') `DeviceMesh` over ``ranks`` (default: the whole
    world), ``dp`` defaulting to their number over ``blk``; ``device``'s type
    is the mesh's.  Every rank of the world calls it (it creates the groups);
    a rank outside ``ranks`` gets no coordinate."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if dp is None:
        dp = len(ranks) // blk
    if dp * blk != len(ranks):
        raise ValueError(f"dp {dp} × blk {blk} != {len(ranks)} ranks")
    return DeviceMesh(torch.device(device).type, torch.tensor(ranks).reshape(dp, blk),
                      mesh_dim_names=(DP, BLK))


def frame_rows(mesh: DeviceMesh, batch: int, dims: tuple[str, ...]) -> slice:
    """This rank's rows of ``batch`` frames split over the mesh axes
    ``dims`` jointly (the first the outer one)."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for name in dims:
        i = mesh.mesh_dim_names.index(name)
        idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} shards of {dims}")
    rows = batch // n
    return slice(idx * rows, (idx + 1) * rows)


def frame_sharding(mesh: DeviceMesh, batch: int) -> slice:
    """This rank's rows of a (batch, …) frame array: batch over dp, the
    rest whole (the rows ``P("dp")`` gives this rank)."""
    return frame_rows(mesh, batch, (DP,))


def shard_batch(mesh: DeviceMesh, tree, device):
    """This rank's rows of each (batch, …) tensor or numpy array of
    ``tree`` (`Cplx`, tuples and named tuples of them), on ``device``."""
    def rows(t):
        return t[frame_sharding(mesh, t.shape[0])].to(device)
    return tree_map(rows, tree)


def shard_blocks(mesh: DeviceMesh, tree, device):
    """This rank's rows and blocks of each (batch, nb_pad, …) block array of
    ``tree``, on ``device``: rows over dp, the padded block axis over blk
    (the slice ``P("dp", "blk")`` gives this rank)."""
    size, rank, _ = axis(mesh, BLK)

    def part(t):
        if t.shape[1] % size:
            raise ValueError(f"{t.shape[1]} blocks do not split over blk {size}: pad_blocks first")
        nb = t.shape[1] // size
        return t[frame_sharding(mesh, t.shape[0]), rank * nb:(rank + 1) * nb].to(device)
    return tree_map(part, tree)


def pad_blocks(x, blk: int):
    """Zero-pad the block axis (axis 1 of (B, 15, 53)) up to a multiple of
    ``blk``: numpy arrays and tensors."""
    nb = x.shape[1]
    nb_pad = -(-nb // blk) * blk
    if nb_pad == nb:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((x.shape[0], nb_pad - nb, *x.shape[2:]))], dim=1)
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, nb_pad - nb)
    return np.pad(x, pad)


# -- data-parallel chain: no collective -----------------------------------------------------


def rx_chain_dp(mesh: DeviceMesh, avg_blocks: int = C.N_AVG_BLOCKS):
    """The full receive chain (``sc.rx_chain``) on this rank's frames.
    Frames are independent, so there is no collective: each rank runs its
    shard.  Returns the callable (tx_pkt, rx_pkt, tx_lp, rx_lp) →
    RxOutputs of this rank's rows."""
    return functools.partial(sc.rx_chain, avg_blocks=avg_blocks)


# -- the step with explicit collectives over dp × blk ----------------------------------------


def rx_step_shardmap(mesh: DeviceMesh, avg_blocks: int = C.N_AVG_BLOCKS, solver: str = "sm",
                     method: str = "gauss"):
    """The receive step with explicit collectives, frames over ``dp`` and
    each frame's blocks over ``blk`` (the JAX ``shard_map`` step).

    ``solver``: "sm" (the rank-1 Sherman-Morrison closed form) or "dense"
    (the fused build-and-solve kernel, ``kernels/mmse_solve.fused_rank1_solve``,
    one 53×53 system per local block; ``method`` "gauss" or "chol").

    Returns ``(step, nb_pad)``.  ``step(tx_pre, rx_pre, tx_blocks,
    rx_blocks, ow2)`` takes this rank's shard: (b, 53), (b, 53), (b,
    nb_local, 53), (b, nb_local, 53) complex and (b,) real, where b =
    B / dp and nb_local = nb_pad / blk (`shard_batch`, `shard_blocks`), and
    returns (RxOutputs of this rank's rows, eq holding its blocks; the
    global mean |h_mmse|², a 0-d tensor alike on every rank).  The pilot and
    MMSE estimates are formed per local block, masked to the first
    ``avg_blocks`` global blocks with ``where`` (a pad block's tx is zero,
    so its pilot ratios are 0/0: dropped, not propagated), summed, and
    all-reduced over ``blk`` in one tensor; the metric is one all-reduce
    over ``dp`` of [Σ|h_mmse|², frames·53]."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    blk_size, blk_rank, blk_group = axis(mesh, BLK)
    _, _, dp_group = axis(mesh, DP)
    nb_pad = -(-C.N_BLOCKS // blk_size) * blk_size
    nb_local = nb_pad // blk_size

    def step(tx_pre, rx_pre, tx_blocks, rx_blocks, ow2):
        if tx_blocks.shape[-2] != nb_local or rx_blocks.shape != tx_blocks.shape:
            raise ValueError(f"want ({nb_local} local blocks) of {nb_pad} padded, got "
                             f"{tuple(tx_blocks.shape)} and {tuple(rx_blocks.shape)}")
        h_lt = sc.lt_ls(tx_pre, rx_pre)
        local_ids = blk_rank * nb_local + torch.arange(nb_local, device=tx_blocks.device)
        averaged = (local_ids < avg_blocks)[:, None]
        per_block = [ps_interp_per_block(tx_blocks, rx_blocks, kind) for kind in _KINDS]
        per_block.append(_mmse_per_block(tx_blocks, rx_blocks, ow2, h_lt, solver, method))
        sums = torch.stack([torch.where(averaged, h, 0).sum(dim=-2) for h in per_block])
        est = all_reduce(sums, blk_group) * (1.0 / avg_blocks)
        h_lin, h_cub, h_sin, h_spl, h_wie, h_mmse = est.unbind(0)
        # each local block blended with its global index (WiFi_Equalization.m:4)
        eq = sc.equalize(rx_blocks, h_lt, h_lin, block_ids=local_ids)
        # h_mmse is alike over blk after the reduction: only dp remains
        local_pow = (h_mmse.real.square() + h_mmse.imag.square()).sum()
        glob = all_reduce(torch.stack([local_pow, torch.full_like(local_pow, h_mmse.numel())]),
                          dp_group)
        return (sc.RxOutputs(h_lt, h_lin, h_cub, h_sin, h_spl, h_wie, h_mmse, eq, ow2),
                glob[0] / glob[1])

    return step, nb_pad


def _mmse_per_block(tx_blocks: torch.Tensor, rx_blocks: torch.Tensor, ow2: torch.Tensor,
                    h_lt: torch.Tensor, solver: str = "sm", method: str = "gauss") -> torch.Tensor:
    """Per-block (not averaged) MMSE estimates (…, nb, 53).  v = H_LT and
    u = tx⊙v; "sm": s = uᴴrx/(σ² + ‖u‖²); "dense": z = (σ²I + uuᴴ)⁻¹rx by
    the fused solve kernel, s = uᴴz.  Estimate v·s."""
    vb = h_lt[..., None, :]
    u = tx_blocks * vb
    if solver == "dense":
        s = vdot(u, fused_rank1_solve(u, rx_blocks, ow2[..., None], method))
    else:
        s = vdot(u, rx_blocks) / (ow2[..., None] + vdot(u, u).real)
    return vb * s[..., None]
