"""The port's raw-stream receiver against the JAX package, on the CPU, at
B = 128 streams of NS = 2048 samples (the capture's frame at a random
offset in each, over 1e-4 AWGN per plane: bench.py's raw workload).

The JAX side runs as its own tests run it: ``raw_rx_txconst`` stages its
detection fallback and the fused chain in interpret mode, and
``raw_rx_txconst_fused`` falls back to that staged pipeline off the TPU.
The port's wrappers run their plain versions; the CUDA kernel is held
against ``raw_chain_plain`` in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.cplx import Cplx as JCplx
from tpu80211.kernels import fused_chain as JF
from tpu80211.kernels.raw_chain import raw_rx_txconst_fused as jax_raw_fused
from tpu80211.pipeline.raw import raw_rx_txconst as jax_raw_staged
from tpu80211_torch import constants as C
from tpu80211_torch import convert
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import raw_chain as TR
from tpu80211_torch.pipeline import raw as TP

from _torch_inputs import TOL, assert_matches, lts_taps, make_streams, rel, to_np

B = 128  # one of the JAX kernel's 128-lane tiles


@pytest.fixture(scope="module")
def workload():
    """(JAX streams, port streams, offsets, JAX (lts, txs, tpre), port
    (lts, TxConst)); f32 lane-major planes of the same samples."""
    x, offs = make_streams(seed=1, b=B)
    xt = np.ascontiguousarray(x.T)
    re, im = xt.real.astype(np.float32), xt.imag.astype(np.float32)
    cap = load_capture()
    h = lts_taps()
    txs, tpre = JF.tx_spectra(JCplx.from_complex(cap.tx_packet, jnp.float32),
                              JCplx.from_complex(cap.tx_lptot, jnp.float32))
    jax_side = (JCplx(jnp.asarray(h.real), jnp.asarray(h.imag)), txs, tpre)
    port_side = (convert.lts_ref(h.real, h.imag, device="cpu"),
                 convert.tx_spectra(*(np.asarray(a) for a in (txs.re, txs.im, tpre.re, tpre.im)),
                                    device="cpu"))
    return (JCplx(jnp.asarray(re), jnp.asarray(im)), Cplx(torch.tensor(re), torch.tensor(im)),
            offs, jax_side, port_side)


def test_staged_matches_jax(workload):
    jx, tx, offs, (jlts, txs, tpre), (tlts, ttx) = workload
    want = jax_raw_staged(jx, jlts, txs, tpre)
    got = TP.raw_rx_txconst(tx, tlts, *ttx)
    np.testing.assert_array_equal(got["start"].numpy(), np.asarray(want["start"]))
    assert got["detected"].all()
    err = got["start"].numpy() - offs
    assert (err >= -4).all() and (err <= -2).all(), err  # bench.py:287
    # the same aligned f32 samples through the chain: the fused chain's f32 tolerances
    assert_matches(got, want, B, TOL["f32"])
    np.testing.assert_allclose(got["metric"].numpy(), np.asarray(want["metric"]), rtol=1e-5)


FUSED_CASES = {
    "stream-sums-sync-mmse": dict(stream_sums=True, sync=True, equalize_with="h_mmse"),
    "serve-wiener-dec32": dict(serve=True, equalize_with="h_wiener", decimate=32),
    "full-res-eps": dict(decimate=False, eps=0.01),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_raw_chain_plain_matches_jax(workload, case):
    """raw_chain_plain against the JAX entry's staged fallback.  That
    fallback detects at full resolution whatever ``decimate`` says; on this
    workload the decimated fine timing lands on the same starts."""
    jx, tx, _, (jlts, txs, tpre), (tlts, ttx) = workload
    kw = FUSED_CASES[case]
    want = jax_raw_fused(jx, jlts, txs, tpre, **kw)
    got = TR.raw_rx_txconst_fused(tx, tlts, *ttx, **kw)
    np.testing.assert_array_equal(got["start"].numpy(), np.asarray(want["start"]))
    np.testing.assert_array_equal(got["detected"].numpy(), np.asarray(want["detected"]))
    assert (got["eq"] is None) == bool(kw.get("stream_sums"))
    # with stream_sums both eq are None and assert_matches holds evm_sums:
    # f32 storage, so the fallback's eq is f32 and both sums run over the
    # same f32 terms in another order
    assert_matches(got, want, B, TOL["f32"])


def test_bf16_stream_sums_against_the_fallbacks_sum(workload):
    """bf16 streams: the kernel (and raw_chain_plain) sums the EVM from eq in
    f32 after CPE; the JAX fallback sums it from eq rounded to the storage
    dtype (raw_chain.py:178-190).  The two differ by the bf16 rounding of
    eq: 2⁻⁹ of |eq| per element is ~10% of a residual |eq − tx| (~2% of
    |tx| on this channel), so its square adds ~1% to a stream's sum on
    average and up to ~2% (measured); 5e-2 relative per stream."""
    _, tx, _, _, (tlts, ttx) = workload
    x = tx.map(lambda t: t.to(torch.bfloat16))
    kw = dict(equalize_with="h_mmse", sync=True)
    sums = TR.raw_rx_txconst_fused(x, tlts, *ttx, stream_sums=True, **kw)
    full = TR.raw_rx_txconst_fused(x, tlts, *ttx, **kw)
    assert full["eq"].re.dtype == torch.bfloat16 and sums["eq"] is None
    txb = (ttx.txs.re[:, :C.N_BLOCKS].T + 1j * ttx.txs.im[:, :C.N_BLOCKS].T)[:, :, None]
    fallback = (full["eq"].to_complex(torch.complex128) - txb.to(torch.complex128)).abs().square()
    np.testing.assert_allclose(sums["evm_sums"].numpy(), fallback.sum((0, 1)).numpy(), rtol=5e-2)
    for k in ("h_mmse", "h_wiener", "checksum", "cfo", "start"):
        a, b = sums[k], full[k]
        for u, v in zip(*(c if isinstance(c, Cplx) else (c,) for c in (a, b))):
            assert torch.equal(u, v), k


def test_int8_streams(workload):
    """int8 ADC words with their step: the chain reproduces the f32 run
    within the 8-bit quantization floor (tests/test_fused_chain.py:185),
    the detection lands on the same starts, and eq comes out bf16."""
    _, tx, _, _, (tlts, ttx) = workload
    lsb = max(float(tx.re.abs().max()), float(tx.im.abs().max())) / 127
    q = tx.map(lambda t: torch.clamp(torch.round(t / lsb), -127, 127).to(torch.int8))
    got = TR.raw_rx_txconst_fused(q, tlts, *ttx, lsb=lsb, decimate=32)
    ref = TR.raw_rx_txconst_fused(tx, tlts, *ttx, decimate=32)
    assert got["eq"].re.dtype == torch.bfloat16
    assert torch.equal(got["start"], ref["start"])
    for k in ("h_lt", "h_linear", "h_mmse", "h_wiener"):
        assert rel(to_np(got[k]), to_np(ref[k])) < 0.05, k


def test_ragged_batch(workload):
    """B = 100 (no multiple of a kernel block) runs through the port and
    gives each stream what it gets in the batch of 128."""
    _, tx, _, _, (tlts, ttx) = workload
    part = tx.map(lambda t: t[:, :100].contiguous())
    got = TR.raw_rx_txconst_fused(part, tlts, *ttx, stream_sums=True)
    want = TR.raw_rx_txconst_fused(tx, tlts, *ttx, stream_sums=True)
    assert torch.equal(got["start"], want["start"][:100])
    # the same f32 arithmetic in batched products of another width
    for k in ("h_mmse", "h_wiener"):
        assert rel(to_np(got[k]), to_np(want[k])[:, :100]) < 1e-5, k
    np.testing.assert_allclose(got["evm_sums"].numpy(), want["evm_sums"][:100].numpy(), rtol=1e-5)


def test_wrapper_never_falls_back(workload):
    _, tx, _, _, (tlts, ttx) = workload
    meta = lambda c: c.map(lambda t: t.to("meta"))  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        TR.raw_rx_txconst_fused(meta(tx), meta(tlts), meta(ttx.txs), meta(ttx.tpre))
