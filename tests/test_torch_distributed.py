"""Process worlds of the port on the CPU: tests/test_distributed.py's
counterpart, the world of one, the mesh stream step at dp = 1, the pooled
raw summary (C3), the scaling sweep, ``run_stream`` on a mesh and the dry
run.

A 4-rank gloo world with LOCAL_WORLD_SIZE=2 plays two hosts of two
devices (tests/_dist_worker.py's (host, dp, blk) = (2, 2, 1)); a world of
one runs in this process; ``dryrun_multichip`` spawns a world of its own.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu80211.cplx import Cplx as JCplx
from tpu80211.pipeline import sc as jsc
from tpu80211_torch import entry
from tpu80211_torch.bench import scaling
from tpu80211_torch.parallel import launch, make_mesh, multihost
from tpu80211_torch.pipeline import sc
from tpu80211_torch.pipeline import stream as S

import _torch_worlds as W
from _torch_inputs import jax_freq_batch

BATCH = 8   # tests/_dist_worker.py's


@pytest.fixture(scope="module")
def freq():
    return jax_freq_batch(7, BATCH)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_stream")


@pytest.fixture(scope="module")
def hosts(freq, shards):
    """Every rank's record from a 4-rank world of two 'hosts'."""
    return launch.launch(W.hierarchical_world, 4, freq, str(shards), device="cpu",
                         env={"LOCAL_WORLD_SIZE": "2"})


def _jax_metric(freq, ow2):
    out = jsc.rx_chain_freq(*(JCplx.from_complex(freq[k], jnp.float32)
                              for k in ("tx_pre", "rx_pre", "txb", "rxb")), jnp.asarray(ow2))
    return float(jnp.mean(out.h_mmse.abs2()))


def test_hierarchical_mesh_spans_two_hosts(hosts):
    """LOCAL_WORLD_SIZE=2 in a world of 4: (host, dp, blk) = (2, 2, 1), and
    the frames split jointly over (host, dp) in rank order."""
    assert all(r["shape"] == {"host": 2, "dp": 2, "blk": 1} for r in hosts)
    assert [r["rows"] for r in hosts] == [(0, 2), (2, 4), (4, 6), (6, 8)]


def test_global_metric_matches_single_process(hosts, freq):
    """The metric reduced across the 'hosts' is alike on every rank and
    equals the single-process value of both packages
    (tests/test_distributed.py:63-91)."""
    metrics = [r["metric"] for r in hosts]
    assert max(metrics) == pytest.approx(min(metrics), rel=1e-6)
    want = float((sc.rx_chain_freq(*(torch.from_numpy(freq[k]) for k in
                                     ("tx_pre", "rx_pre", "txb", "rxb", "ow2")))
                  .h_mmse.abs().square().mean()))
    assert metrics[0] == pytest.approx(want, rel=1e-4)
    assert metrics[0] == pytest.approx(_jax_metric(freq, freq["ow2"]), rel=1e-4)


@pytest.mark.parametrize("solver", ["sm", "dense"])
@pytest.mark.parametrize("layout", ["dp_cross", "blk_cross"])
def test_shardmap_step_across_hosts(hosts, freq, layout, solver):
    """The step's all-reduces cross the host boundary in both orientations
    (tests/test_distributed.py:68-78): alike on every rank, and equal to the
    single-process value at the workers' σ² = 0.25."""
    got = [m for r in hosts for m in r[layout, solver]]
    assert max(got) == pytest.approx(min(got), rel=1e-6)
    want = _jax_metric(freq, np.full((BATCH,), W.OW2_DENSE, np.float32))
    assert got[0] == pytest.approx(want, rel=1e-4)
    dp_group, blk_group = hosts[0][layout, "groups"]
    crossing = {"dp_cross": dp_group, "blk_cross": blk_group}[layout]
    assert crossing == (0, 2)   # rank 0 on 'host' 0 with rank 2 on 'host' 1


def test_scaling_sweep_rows(hosts):
    """bench/scaling.py's rows, with the JAX sweep's keys, for each default
    shape of a 4-rank world (sub-meshes of 1 and 4 ranks)."""
    rows = hosts[0]["sweep"]
    assert [(r["dp"], r["blk"]) for r in rows] == [(1, 1), (4, 1), (2, 2), (1, 4)]
    for r in rows:
        assert set(r) == {"dp", "blk", "devices", "frames_per_s", "ms_per_step",
                          "scaling_efficiency"}
        assert r["frames_per_s"] > 0 and r["devices"] == r["dp"] * r["blk"]
    assert rows[0]["scaling_efficiency"] == 1.0


def test_run_stream_on_a_mesh_writes_each_ranks_rows(hosts, shards):
    """Each rank runs its dp rows of every host batch and writes them to
    shards and a cursor of its own; together they are one process's run."""
    assert all(r["run_stream"]["frames"] == 2 * BATCH // 4 for r in hosts)
    want = sc.rx_chain_freq(*next(S.synthetic_batches(1, batch=BATCH)))
    for rank in range(4):
        assert (shards / f"cursor.rank{rank}.json").exists()
        shard = np.load(shards / f"h_est_000000.rank{rank}.npz")
        rows = slice(2 * rank, 2 * rank + 2)
        for k in W.EST:
            np.testing.assert_allclose(shard[k], getattr(want, k)[rows].numpy(), rtol=1e-5,
                                       atol=1e-6 * float(getattr(want, k).abs().max()))


# -- a world of one, in this process ---------------------------------------------------------


@pytest.fixture(scope="module")
def one():
    """init_distributed with no arguments and no torchrun environment: a
    world of one after a warning; a second call is a no-op."""
    with pytest.MonkeyPatch.context() as mp:
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            mp.delenv(k, raising=False)
        with pytest.warns(UserWarning, match="world of one"):
            multihost.init_distributed(device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            multihost.init_distributed(device="cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one(one):
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert dict(zip(one.mesh_dim_names, one.mesh.shape)) == {"dp": 1, "blk": 1}


@pytest.mark.parametrize("gen", S.MESH_GENERATORS)
def test_mesh_stream_step_at_dp1_is_the_single_chip_step(one, gen):
    """At dp = 1 the mesh step's seed, summary, sample and next state are
    the single-chip step's, bit for bit, over two chained batches."""
    kw = dict(snr_db=30.0, gen=gen, device="cpu")
    mstep, m0 = S.make_device_stream_step(256, mesh=one, **kw)
    step, s0 = S.make_device_stream_step(256, **kw)
    for i in range(2):
        msum, msample, m0 = mstep(i, m0)
        ssum, ssample, s0 = step(i, s0)
        assert set(msum) <= set(ssum)
        for k in msum:
            assert torch.equal(msum[k], ssum[k]), (i, k)
        assert torch.equal(msample.re, ssample.re) and torch.equal(msample.im, ssample.im)
        assert torch.equal(m0, s0)


def test_mesh_stream_step_checks_its_arguments(one):
    with pytest.raises(ValueError, match="in-kernel generator"):
        S.make_device_stream_step(128, gen="xla", mesh=one, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        S.make_device_stream_step(192, mesh=one, device="cpu")


def test_scaling_sweep_in_a_world_of_one(one):
    """The JAX sweep's default shapes for one device: (1, 1) twice."""
    rows = scaling.sweep(batch=32, iters=1, device="cpu")
    assert [(r["dp"], r["blk"], r["devices"]) for r in rows] == [(1, 1, 1)] * 2
    assert rows[0]["scaling_efficiency"] == 1.0


# -- C3: the pooled raw summary --------------------------------------------------------------


def _raw_out(detected, evm_sums, start):
    return {"detected": torch.tensor(detected), "start": torch.tensor(start, dtype=torch.int32),
            "evm_sums": torch.tensor(evm_sums, dtype=torch.float32)}


def test_pooled_raw_summary_is_over_detected_streams():
    """C3: two ranks' packs, summed as the all-reduce sums them, give the
    single-process summary of the concatenated batch (EVM over the detected
    streams of both ranks), not the JAX mesh step's Σ over every stream /
    batch (tpu80211/pipeline/stream.py:432-440)."""
    offs = torch.full((4,), 100, dtype=torch.int32)
    ranks = [_raw_out([True, True, False, True], [2.0, 4.0, 1e6, 6.0], [97, 97, -1, 90]),
             _raw_out([False, True, True, False], [5e5, 3.0, 5.0, 7e5], [-1, 98, 97, -1])]
    evm_den = 2.0
    pooled = S._raw_rates(sum(S._raw_pack(r, offs) for r in ranks), 8, evm_den)
    cat = {k: torch.cat([r[k] for r in ranks]) for k in ranks[0]}
    h = S.Cplx(torch.ones(53, 8), torch.zeros(53, 8))
    cat["h_mmse"] = h
    want = S._raw_summary(cat, torch.cat([offs, offs]), h, evm_den)
    for k, v in pooled.items():
        assert float(v) == pytest.approx(float(want[k]), rel=1e-7), k
    assert float(pooled["detect_rate"]) == 5 / 8
    assert float(pooled["timing_in_band_rate"]) == 4 / 8
    assert float(pooled["evm_rms"]) == pytest.approx(np.sqrt(20.0 / (5 * evm_den)))
    jax_formula = np.sqrt(float(cat["evm_sums"].sum()) / (8 * evm_den))
    assert abs(jax_formula - float(pooled["evm_rms"])) > 100


def test_kernel_seed_adds_the_rank_as_the_jax_mesh_step():
    """tpu80211/pipeline/stream.py:422-425: int32 seed + 65537·i +
    state·(2654435761 mod 2³¹) + rank·97003, wrapping."""
    for seed, i, state, rank in ((0, 0, 0, 1), (7, 3, 65535, 7), (2 ** 30, 9, 51234, 3)):
        want = (jnp.asarray(seed + i * 65537, jnp.int32)
                + jnp.asarray(state, jnp.int32) * jnp.asarray(2654435761 % (2 ** 31), jnp.int32)
                + jnp.asarray(rank, jnp.int32) * jnp.asarray(97003, jnp.int32))
        got = S.kernel_seed(seed, i, torch.tensor(state, dtype=torch.int32), rank)
        assert got.dtype == torch.int32 and int(got) == int(want)


# -- init_distributed, devices, the dry run --------------------------------------------------


def test_init_distributed_needs_a_whole_explicit_world():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.init_distributed("localhost:1", device="cpu")


def test_rank_device(monkeypatch):
    """The CPU as given; a card by LOCAL_RANK modulo the cards; no card for
    a CUDA device raises (no fallback to the CPU)."""
    assert multihost.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.rank_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.rank_device("cuda") == torch.device("cuda", 1)


def test_launch_raises_a_ranks_error():
    """A rank that raises ends the world; its traceback reaches the caller."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank one fails"):
        launch.launch(W.fail_on_rank_one, 2, device="cpu")


def test_entry_is_the_chain():
    fn, args = entry.entry(device="cpu")
    out = fn(*args)
    assert fn is sc.rx_chain and out.h_mmse.shape == (64, 53) and out.eq.shape == (64, 15, 53)


def test_dryrun_multichip_on_four_cpu_ranks():
    """The five checks of the dry run in a 4-rank gloo world (blk = 2)."""
    entry.dryrun_multichip(4, device="cpu")
