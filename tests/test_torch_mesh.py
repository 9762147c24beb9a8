"""The port's mesh step against the JAX package's, on the CPU.

tests/test_mesh.py runs ``tpu80211.parallel`` on the conftest's virtual
8-device CPU mesh; here the same numpy frames also go through the port's
``parallel`` in an 8-rank gloo world (one process per device, spawned once
for the module), and the ranks' outputs, concatenated in dp order, are
held to the JAX step's: every estimate and eq within 1e-4 relative, the
metric within 1e-4 (tests/test_mesh.py:94-105; f32 sums in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211 import constants as JC
from tpu80211.cplx import Cplx as JCplx
from tpu80211.parallel import make_mesh as jmake_mesh
from tpu80211.parallel import pad_blocks as jpad_blocks
from tpu80211.parallel import rx_step_shardmap as jrx_step_shardmap
from tpu80211.pipeline import sc as jsc
from tpu80211_torch import parallel
from tpu80211_torch.parallel import launch

import _torch_worlds as W
from _torch_inputs import jax_freq_batch, make_frames, rel

LAYOUTS = [(8, 1), (4, 2), (2, 4)]
SOLVERS = ("sm", "dense")
N_RANKS = 8


def _jc(x):
    return JCplx.from_complex(np.asarray(x), jnp.float32)


@pytest.fixture(scope="module")
def freq():
    """tests/test_mesh.py's batch (16 frames, PRNGKey(7)) as numpy arrays."""
    return jax_freq_batch(7, 16)


@pytest.fixture(scope="module")
def time_dom():
    """16 time-domain frames (tx packet, rx packet, tx preamble, rx preamble)."""
    return make_frames(seed=3, b=16)


@pytest.fixture(scope="module")
def world(freq, time_dom):
    """The port in an 8-rank gloo world: rank 0's gathered record."""
    return launch.launch(W.mesh_world, N_RANKS, freq, time_dom, LAYOUTS, SOLVERS, device="cpu")


def _jax_step(freq, dp, blk, solver, ow2=None):
    """The JAX step over (dp, blk): at the frames' σ² with "sm" and at
    σ² = 0.25 with "dense" (the port's world does the same), unless ``ow2``."""
    mesh = jmake_mesh(dp=dp, blk=blk)
    step, nb_pad = jrx_step_shardmap(mesh, solver=solver)
    if ow2 is None:
        ow2 = freq["ow2"] if solver == "sm" else np.full_like(freq["ow2"], W.OW2_DENSE)
    out, mse = step(_jc(freq["tx_pre"]), _jc(freq["rx_pre"]),
                    _jc(jpad_blocks(freq["txb"], blk)[:, :nb_pad]),
                    _jc(jpad_blocks(freq["rxb"], blk)[:, :nb_pad]), jnp.asarray(ow2))
    return out, float(mse)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("dp,blk", LAYOUTS)
def test_shardmap_step_matches_jax(world, freq, dp, blk, solver):
    """Every estimate, eq on the real blocks, and the metric: the port's
    step over (dp, blk) against the JAX step over the same mesh shape."""
    want, want_mse = _jax_step(freq, dp, blk, solver)
    got = world[dp, blk, solver]
    for name in W.EST:
        assert rel(got[name], getattr(want, name).to_complex()) < 1e-4, name
    eq_want = np.asarray(want.eq.to_complex())[:, :JC.N_BLOCKS]
    assert rel(got["eq"][:, :JC.N_BLOCKS], eq_want) < 1e-4
    # the metric is alike on every rank, and the JAX one
    assert len(set(got["mse"])) == 1
    np.testing.assert_allclose(got["mse"][0], want_mse, rtol=1e-4)


@pytest.mark.parametrize("dp,blk", LAYOUTS[:2])
def test_dense_solver_matches_sm(world, freq, dp, blk):
    """tests/test_mesh.py:108-132 across the packages: the port's fused
    build-and-solve MMSE on the sharded layout equals the JAX step's closed
    form at σ² = 0.25."""
    want, want_mse = _jax_step(freq, dp, blk, "sm", np.full_like(freq["ow2"], W.OW2_DENSE))
    dense = world[dp, blk, "dense"]
    assert rel(dense["h_mmse"], want.h_mmse.to_complex()) < 1e-4
    np.testing.assert_allclose(dense["mse"][0], want_mse, rtol=1e-4)


def test_dp_chain_matches_jax(world, time_dom):
    """``rx_chain_dp`` over dp = 8 (each rank its two frames, no collective)
    == the JAX package's ``sc.rx_chain`` on all 16 (tests/test_mesh.py:40-70's
    tolerances: h_mmse carries 1/σ² magnitudes)."""
    want = jsc.rx_chain(*(_jc(x) for x in time_dom))
    for name, tol in (("h_lt", 1e-5), ("h_linear", 1e-5), ("h_wiener", 1e-5), ("h_mmse", 1e-4)):
        assert rel(world["dp_chain"][name], getattr(want, name).to_complex()) < tol, name


@pytest.mark.parametrize("blk", [1, 2, 4, 6])
def test_pad_blocks_matches_jax(freq, blk):
    """numpy and tensors, padded as the JAX ``pad_blocks`` pads."""
    want = jpad_blocks(freq["txb"], blk)
    np.testing.assert_array_equal(parallel.pad_blocks(freq["txb"], blk), want)
    np.testing.assert_array_equal(parallel.pad_blocks(torch.from_numpy(freq["txb"]), blk).numpy(),
                                  want)
