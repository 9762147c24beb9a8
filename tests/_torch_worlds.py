"""Rank functions for the port's multi-process CPU tests (not collected by
pytest).  ``parallel.launch`` pickles them by import path into each rank,
so this module imports no JAX.  Each runs on every rank of a gloo world,
gathers what the ranks computed with ``all_gather_object``, and returns the
gathered record (the test reads rank 0's)."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu80211_torch import constants as C
from tpu80211_torch.bench import scaling
from tpu80211_torch.parallel import mesh as M
from tpu80211_torch.parallel import multihost
from tpu80211_torch.pipeline import sc
from tpu80211_torch.pipeline import stream as S

EST = ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline", "h_wiener", "h_mmse")
OW2_DENSE = 0.25   # a well-conditioned σ² for the dense f32 solve (tests/test_mesh.py:118-121)


def gather(obj) -> list:
    """Every rank's ``obj``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def shardmap_global(mesh, freq: dict, solver: str) -> dict:
    """The step over ``mesh`` on ``freq``'s frames (tx_pre, rx_pre, txb, rxb,
    ow2 numpy arrays, batch-major), the ranks' outputs assembled into global
    arrays: h fields (B, 53) in dp order, eq (B, nb_pad, 53), and every
    rank's metric."""
    dp, _, _ = M.axis(mesh, M.DP)
    blk, _, _ = M.axis(mesh, M.BLK)
    step, nb_pad = M.rx_step_shardmap(mesh, solver=solver)
    ow2 = freq["ow2"] if solver == "sm" else np.full_like(freq["ow2"], OW2_DENSE)
    pre = M.shard_batch(mesh, (freq["tx_pre"], freq["rx_pre"], ow2), "cpu")
    blocks = M.shard_blocks(mesh, tuple(M.pad_blocks(freq[k], blk)[:, :nb_pad]
                                        for k in ("txb", "rxb")), "cpu")
    out, mse = step(pre[0], pre[1], *blocks, pre[2])
    parts = gather((mesh.get_coordinate(), {k: _np(getattr(out, k)) for k in (*EST, "eq")},
                    float(mse)))
    b = freq["ow2"].shape[0]
    rows, nb = b // dp, nb_pad // blk
    res = {k: np.zeros((b, C.N_SC), np.complex64) for k in EST}
    res["eq"] = np.zeros((b, nb_pad, C.N_SC), np.complex64)
    for (d, k), arrs, _ in parts:
        for name in EST:
            res[name][d * rows:(d + 1) * rows] = arrs[name]
        res["eq"][d * rows:(d + 1) * rows, k * nb:(k + 1) * nb] = arrs["eq"]
    res["mse"] = [m for _, _, m in parts]
    return res


def mesh_world(freq: dict, time_dom: tuple, layouts, solvers) -> dict:
    """tests/test_torch_mesh.py: the step for every layout and solver, and
    ``rx_chain_dp`` on the time-domain frames ``time_dom`` over dp = world."""
    res = {}
    for dp, blk in layouts:
        mesh = M.make_mesh(dp=dp, blk=blk, device="cpu")
        for solver in solvers:
            res[dp, blk, solver] = shardmap_global(mesh, freq, solver)
    mesh = M.make_mesh(blk=1, device="cpu")
    out = M.rx_chain_dp(mesh)(*M.shard_batch(mesh, tuple(time_dom), "cpu"))
    parts = gather({k: _np(getattr(out, k)) for k in EST})
    res["dp_chain"] = {k: np.concatenate([p[k] for p in parts]) for k in EST}
    return res


def _recording():
    """Route `parallel.mesh.all_reduce` through a recorder of each call's
    group (its ranks, as a tuple); returns the list it appends to."""
    calls = []
    plain = M.all_reduce

    def all_reduce(t, group):
        calls.append(tuple(dist.get_process_group_ranks(group)))
        return plain(t, group)

    M.all_reduce = all_reduce
    return calls


def collectives_world(freq: dict, time_dom: tuple, stream_batch: int) -> dict:
    """tests/test_torch_collectives.py: the all-reduces (their groups) of one
    shardmap step over (4, 2), of ``rx_chain_dp`` over dp = world, and of one
    mesh stream step per generator over dp = world; the stream steps'
    summaries, samples and next states by rank."""
    calls = _recording()
    res = {}
    mesh = M.make_mesh(dp=4, blk=2, device="cpu")
    step, nb_pad = M.rx_step_shardmap(mesh)
    pre = M.shard_batch(mesh, (freq["tx_pre"], freq["rx_pre"], freq["ow2"]), "cpu")
    blocks = M.shard_blocks(mesh, tuple(M.pad_blocks(freq[k], 2)[:, :nb_pad]
                                        for k in ("txb", "rxb")), "cpu")
    n0 = len(calls)
    step(pre[0], pre[1], *blocks, pre[2])
    res["shardmap"] = calls[n0:]
    dmesh = M.make_mesh(blk=1, device="cpu")
    n0 = len(calls)
    M.rx_chain_dp(dmesh)(*M.shard_batch(dmesh, tuple(time_dom), "cpu"))
    res["dp_chain"] = calls[n0:]
    for gen in S.MESH_GENERATORS:
        sstep, s0 = S.make_device_stream_step(stream_batch, snr_db=35.0 if gen == "kernel" else 30.0,
                                              gen=gen, mesh=dmesh, device="cpu")
        n0 = len(calls)
        summary, sample_h, s1 = sstep(0, s0)
        res[gen] = calls[n0:]
        again = sstep(0, s0)
        res[gen + "_out"] = {
            "summary": {k: float(v) for k, v in summary.items()},
            "sample": _np(sample_h.re), "state": int(s1),
            "deterministic": bool(torch.equal(sample_h.re, again[1].re)) and int(again[2]) == int(s1),
        }
    return gather(res)


def hierarchical_world(freq: dict, out_dir: str) -> dict:
    """tests/test_torch_distributed.py (tests/_dist_worker.py's counterpart):
    with LOCAL_WORLD_SIZE=2 in a 4-rank world, the ('host', 'dp', 'blk')
    mesh, the global mean |h_mmse|² of ``sc.rx_chain_freq`` over the rows of
    `frame_sharding_mh` (one all-reduce over the world), and the shardmap
    step's metric over (2, 2) meshes whose dp groups, then blk groups,
    cross the two hosts, with both solvers at σ² = 0.25 (as
    tests/_dist_worker.py runs them).  Then ``bench.scaling.sweep``
    over its default shapes (sub-meshes of 1, 2 and 4 ranks), and
    ``run_stream`` over dp = 4 writing each rank's shards under
    ``out_dir``."""
    hmesh = multihost.hierarchical_mesh(blk=1, device="cpu")
    shape = dict(zip(hmesh.mesh_dim_names, hmesh.mesh.shape))
    rows = multihost.frame_sharding_mh(hmesh, freq["ow2"].shape[0])
    out = sc.rx_chain_freq(*(torch.from_numpy(freq[k][rows])
                             for k in ("tx_pre", "rx_pre", "txb", "rxb", "ow2")))
    h = out.h_mmse
    glob = M.all_reduce(torch.stack([(h.real.square() + h.imag.square()).sum(),
                                     torch.tensor(float(h.numel()))]), dist.group.WORLD)
    res = {"shape": shape, "metric": float(glob[0] / glob[1]), "rows": (rows.start, rows.stop)}
    ranks = np.arange(4).reshape(2, 2)
    dense_ow2 = dict(freq, ow2=np.full_like(freq["ow2"], OW2_DENSE))   # both solvers at 0.25
    for name, layout in (("dp_cross", ranks), ("blk_cross", ranks.T)):
        mesh = M.make_mesh(dp=2, blk=2, ranks=layout.reshape(-1).tolist(), device="cpu")
        for solver in M.SOLVERS:
            res[name, solver] = shardmap_global(mesh, dense_ow2, solver)["mse"]
        res[name, "groups"] = (tuple(dist.get_process_group_ranks(M.axis(mesh, M.DP)[2])),
                               tuple(dist.get_process_group_ranks(M.axis(mesh, M.BLK)[2])))
    res["sweep"] = scaling.sweep(batch=64, iters=1, device="cpu")
    res["run_stream"] = S.run_stream(S.synthetic_batches(2, batch=8), mesh=M.make_mesh(device="cpu"),
                                     out_dir=out_dir, device="cpu")
    return gather(res)


def fail_on_rank_one() -> None:
    """Rank 1 raises while the others wait for it in a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()
