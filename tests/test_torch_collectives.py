"""The port's collective inventory, the counterpart of
tests/test_collectives.py's compiled-HLO assertions.

The port routes every collective through ``parallel.mesh.all_reduce``; an
8-rank gloo world (spawned once for the module) records each call's group
on every rank.  The dp×blk step must make exactly two all-reduces, over
the groups the JAX test reads from the HLO (blk {0,1},{2,3},{4,5},{6,7};
dp {0,2,4,6},{1,3,5,7}); ``rx_chain_dp`` none; each mesh stream step one,
over dp.  The mesh stream steps' summaries are also held to the same
batches received in one process with each rank's seed and pooled.
"""

import numpy as np
import pytest
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import gen_chain as G
from tpu80211_torch.kernels import raw_gen_chain as RG
from tpu80211_torch.ops.detect import lts_time_symbol
from tpu80211_torch.parallel import launch
from tpu80211_torch.pipeline import stream as S

import _torch_worlds as W
from _torch_inputs import jax_freq_batch, make_frames, torch_planes

N_RANKS = 8
LOCAL = 128                      # stream frames a rank
STREAM_BATCH = LOCAL * N_RANKS
SNR = {"kernel": 35.0, "kernel_raw": 30.0}   # collectives_world's


@pytest.fixture(scope="module")
def ranks():
    """Every rank's record from one 8-rank world."""
    return launch.launch(W.collectives_world, N_RANKS, jax_freq_batch(7, 16),
                         make_frames(seed=3, b=16), STREAM_BATCH, device="cpu")


def test_shardmap_step_makes_exactly_the_two_intended_all_reduces(ranks):
    """One over the rank's blk group, then one over its dp group: the
    groups XLA's compiled step uses (tests/test_collectives.py:106-123)."""
    for rec in ranks:
        assert len(rec["shardmap"]) == 2, rec["shardmap"]
    assert {rec["shardmap"][0] for rec in ranks} == {(0, 1), (2, 3), (4, 5), (6, 7)}
    assert {rec["shardmap"][1] for rec in ranks} == {(0, 2, 4, 6), (1, 3, 5, 7)}


def test_dp_chain_makes_no_collective(ranks):
    """Frames are independent: the data-parallel chain has no collective
    (tests/test_collectives.py:66-77)."""
    assert all(rec["dp_chain"] == [] for rec in ranks)


@pytest.mark.parametrize("gen", S.MESH_GENERATORS)
def test_mesh_stream_step_makes_one_dp_all_reduce(ranks, gen):
    """The summaries and the checksum travel in one packed all-reduce over
    dp (the JAX test allows at most two)."""
    assert all(rec[gen] == [tuple(range(N_RANKS))] for rec in ranks)


@pytest.mark.parametrize("gen", S.MESH_GENERATORS)
def test_mesh_stream_step_is_alike_on_every_rank_and_deterministic(ranks, gen):
    """Every rank reports the same summary and next state; the same
    (i, state) gives the same batch; each rank's sample is its own frames."""
    outs = [rec[gen + "_out"] for rec in ranks]
    assert all(o["summary"] == outs[0]["summary"] and o["state"] == outs[0]["state"] for o in outs)
    assert all(o["deterministic"] for o in outs)
    assert all(o["sample"].shape == (C.N_SC, LOCAL) for o in outs)
    assert not np.array_equal(outs[0]["sample"], outs[1]["sample"])


def _consts():
    """The tx-constant spectra, the detector's LTS and the EVM denominator,
    as ``make_device_stream_step`` makes them."""
    cap = load_capture()
    txs, tpre = F.tx_spectra(torch_planes(cap.tx_packet), torch_planes(cap.tx_lptot))
    lts = torch_planes(lts_time_symbol(cap.tx_lptot).numpy())
    evm_den = float((txs.re[:, :C.N_BLOCKS].double() ** 2
                     + txs.im[:, :C.N_BLOCKS].double() ** 2).sum())
    return txs, tpre, lts, evm_den


@pytest.mark.parametrize("gen", S.MESH_GENERATORS)
def test_mesh_stream_step_pools_the_ranks(ranks, gen):
    """The mesh summary is the pool of the eight ranks' batches, each drawn
    in one process with its rank's seed: the kernel NMSEs from the pooled
    error sums, and (C3) the raw EVM over the detected streams of every
    rank.  f32 sums in another order than gloo's: rel 1e-5; the next state,
    |Σ checksum|·1e3 mod 2¹⁶, within 1e3 × 8 f32 ulps of that sum (~2e5:
    an ulp of it is 0.03, i.e. 31 states)."""
    txs, tpre, lts, evm_den = _consts()
    zero = torch.zeros((), dtype=torch.int32)
    packs, totals = [], []
    for rank in range(N_RANKS):
        seed = S.kernel_seed(0, 0, zero, rank)
        if gen == "kernel":
            out = G.fused_gen_chain(seed, LOCAL, txs, tpre, snr_db=SNR[gen], stream_sums=True)
            packs.append(out["sums"].sum(-1))
        else:
            out = RG.gen_raw_system(seed, LOCAL, txs, tpre, lts, snr_db=SNR[gen])
            packs.append(S._raw_pack(out, out["offsets"]))
        totals.append(out["checksum"].sum())
    pooled = torch.stack(packs).sum(0)
    if gen == "kernel":
        want = {n + "_nmse": float(pooled[k] / pooled[-1]) for k, n in enumerate(S._STREAM_ESTS)}
    else:
        want = {k: float(v) for k, v in S._raw_rates(pooled, STREAM_BATCH, evm_den).items()}
    got = ranks[0][gen + "_out"]
    assert set(got["summary"]) == set(want)
    for k, v in want.items():
        assert got["summary"][k] == pytest.approx(v, rel=1e-5), k
    total = torch.stack(totals).sum()
    spread = 1e3 * 8 * torch.finfo(torch.float32).eps * float(total.abs())
    assert abs(got["state"] - int(S._state_of(total))) <= spread + 1


def test_mesh_stream_statistics_match_the_single_process_step(ranks):
    """tests/test_collectives.py:80-103: the channel recovered at SNR 35,
    and statistics within 0.05 of one process's step over the whole batch
    (other seeds: another draw of the same distribution)."""
    got = ranks[0]["kernel_out"]["summary"]
    assert got["h_lt_nmse"] < 0.1
    step, s0 = S.make_device_stream_step(STREAM_BATCH, snr_db=SNR["kernel"], device="cpu")
    one, _, _ = step(0, s0)
    assert abs(got["h_lt_nmse"] - float(one["h_lt_nmse"])) < 0.05
