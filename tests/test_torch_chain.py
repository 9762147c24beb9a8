"""The port's plain chain (tpu80211_torch.pipeline.sc) against
tpu80211.pipeline.sc, on the same numpy-seeded frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.config import EstimatorMode as JMode
from tpu80211.cplx import Cplx as JCplx
from tpu80211.pipeline import sc as jsc
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.pipeline import sc

from _torch_inputs import jax_planes, make_frames, rel, to_np

# f32 on both sides: the tolerances of tests/test_fused_chain.py:53-61
# (h_mmse carries 1/σ² magnitudes, so f32 reduction order shows more)
TOL = {"h_lt": 1e-5, "h_linear": 1e-5, "h_cubic": 1e-5, "h_sinc": 1e-5,
       "h_spline": 1e-5, "h_wiener": 1e-5, "h_mmse": 1e-3, "eq": 1e-4}


@pytest.fixture(scope="module")
def frames():
    """6 frames with their own tx, as complex64 numpy arrays."""
    return make_frames(seed=2, b=6)


@pytest.fixture(scope="module")
def jax_in(frames):
    return tuple(jax_planes(x) for x in frames)


@pytest.fixture(scope="module")
def torch_in(frames):
    return tuple(torch.tensor(x, dtype=torch.complex64) for x in frames)


@pytest.fixture(scope="module")
def freq(jax_in, torch_in):
    """Frequency-domain inputs, (JAX, port) each: pre tx/rx, blocks tx/rx, ow2."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = jax_in
    j = (jsc.preamble_fft(tx_lp), jsc.preamble_fft(rx_lp), jsc.extract_blocks(tx_pkt),
         jsc.extract_blocks(rx_pkt), jsc.noise_power(rx_lp))
    tx_pkt, rx_pkt, tx_lp, rx_lp = torch_in
    t = (sc.preamble_fft(tx_lp), sc.preamble_fft(rx_lp), sc.extract_blocks(tx_pkt),
         sc.extract_blocks(rx_pkt), sc.noise_power(rx_lp))
    return j, t


def test_front_end_matches(freq):
    j, t = freq
    for jj, tt, name in zip(j[:4], t[:4], ("tx_pre", "rx_pre", "tx_blocks", "rx_blocks")):
        assert tt.dtype == torch.complex64
        assert tuple(tt.shape) == jj.shape, name
        # an f32 DFT of 64 samples in another summation order
        assert rel(to_np(tt), to_np(jj)) < 1e-5, name
    assert t[4].dtype == torch.float32
    np.testing.assert_allclose(to_np(t[4]), to_np(j[4]), rtol=1e-4)  # σ², f32 sums


def test_lt_ls_and_pilot_ratios_match(freq):
    (jtp, jrp, jtb, jrb, _), (ttp, trp, ttb, trb, _) = freq
    h = sc.lt_ls(ttp, trp)
    assert rel(to_np(h), to_np(jsc.lt_ls(jtp, jrp))) < 1e-5  # f32 ratios
    assert to_np(h)[:, 26].tolist() == [0] * h.shape[0]      # DC forced to 0
    assert rel(to_np(sc.pilot_ratios(ttb, trb)), to_np(jsc.pilot_ratios(jtb, jrb))) < 1e-5


@pytest.mark.parametrize("mode", [EstimatorMode.MATH, EstimatorMode.C_PARITY])
@pytest.mark.parametrize("kind", ["linear", "cubic", "sinc", "spline", "wiener"])
def test_ps_interp_matches(freq, kind, mode):
    (_, _, jtb, jrb, _), (_, _, ttb, trb, _) = freq
    got = sc.ps_interp(ttb, trb, kind, mode)
    want = jsc.ps_interp(jtb, jrb, kind, JMode(mode.value))
    assert rel(to_np(got), to_np(want)) < 1e-5  # f32, as the pipeline tolerance


def test_ps_interp_wiener_prior_matches(freq):
    (_, _, jtb, jrb, _), (_, _, ttb, trb, _) = freq
    got = sc.ps_interp(ttb, trb, "wiener", channel_model="D", snr_db=12.0)
    want = jsc.ps_interp(jtb, jrb, "wiener", channel_model="D", snr_db=12.0)
    assert rel(to_np(got), to_np(want)) < 1e-5


@pytest.mark.parametrize("mode", [EstimatorMode.MATH, EstimatorMode.MATLAB])
def test_ps_mmse_sm_matches(freq, mode):
    (jtp, jrp, jtb, jrb, jow2), (ttp, trp, ttb, trb, tow2) = freq
    got = sc.ps_mmse_sm(ttb, trb, tow2, sc.lt_ls(ttp, trp), mode=mode)
    want = jsc.ps_mmse_sm(jtb, jrb, jow2, jsc.lt_ls(jtp, jrp), mode=JMode(mode.value))
    # MATH: the pipeline's 1e-3; MATLAB divides by σ² once more, which
    # magnifies f32 rounding in the difference of two dots
    assert rel(to_np(got), to_np(want)) < (1e-3 if mode == EstimatorMode.MATH else 1e-2)


@pytest.mark.parametrize("block_ids", [None, [0, 7, 14, 20]])
def test_equalize_matches(freq, block_ids):
    (jtp, jrp, jtb, jrb, _), (ttp, trp, ttb, trb, _) = freq
    th, jh = sc.lt_ls(ttp, trp), jsc.lt_ls(jtp, jrp)
    tps, jps = sc.ps_interp(ttb, trb, "linear"), jsc.ps_interp(jtb, jrb, "linear")
    if block_ids is None:
        got, want = sc.equalize(trb, th, tps), jsc.equalize(jrb, jh, jps)
    else:  # a block-sharded caller's 4 local blocks; id 20 is padding
        got = sc.equalize(trb[:, :4], th, tps, torch.tensor(block_ids))
        want = jsc.equalize(jrb[:, :4], jh, jps, jnp.asarray(block_ids))
    assert rel(to_np(got), to_np(want)) < 1e-4
    assert np.all(to_np(got)[..., 26] == 0)


@pytest.mark.parametrize("equalize_with", ["h_linear", "h_wiener", "h_mmse"])
def test_rx_chain_matches(jax_in, torch_in, equalize_with):
    got = sc.rx_chain(*torch_in, equalize_with=equalize_with)
    want = jsc.rx_chain(*jax_in, equalize_with=equalize_with)
    np.testing.assert_allclose(to_np(got.ow2), to_np(want.ow2), rtol=1e-4)
    for name, tol in TOL.items():
        g, w = to_np(getattr(got, name)), to_np(getattr(want, name))
        assert g.shape == w.shape, name
        assert rel(g, w) < tol, (name, rel(g, w))


def test_rx_chain_freq_wiener_prior_matches(freq):
    j, t = freq
    got = sc.rx_chain_freq(*t, equalize_with="h_wiener", wiener_model="B", wiener_snr_db=15.0)
    want = jsc.rx_chain_freq(*j, equalize_with="h_wiener", wiener_model="B", wiener_snr_db=15.0)
    for name, tol in TOL.items():
        assert rel(to_np(getattr(got, name)), to_np(getattr(want, name))) < tol, name


def test_rx_chain_complex128_capture_anchors(capture):
    """The shipped capture through the complex128 chain: the f64 anchors of
    the JAX package (h_lt[0], median |eq − tx| per equalizer blend)."""
    args = [torch.tensor(x, dtype=torch.complex128) for x in (
        capture.tx_packet, capture.rx_packet, capture.tx_lptot, capture.rx_lptot)]
    out = sc.rx_chain(*args)
    assert out.eq.dtype == torch.complex128
    assert abs(complex(out.h_lt[0]) - (0.009035 + 0.000925j)) < 1e-6
    tx = torch.tensor(capture.tx_symb)
    assert abs(float((out.eq - tx).abs().median()) - 0.2876) < 5e-4
    out = sc.rx_chain(*args, equalize_with="h_mmse")
    assert abs(float((out.eq - tx).abs().median()) - 0.1877) < 5e-4
    # and against the JAX chain on float64 planes: its sc casts the DFT
    # matrices to float32, so the two agree to f32 rounding only
    want = jsc.rx_chain(*(JCplx.from_complex(a.numpy(), jnp.float64) for a in args),
                        equalize_with="h_mmse")
    assert rel(out.eq.numpy(), to_np(want.eq)) < 1e-5


def test_rx_chain_sync_not_ported(jax_in, torch_in):
    """sync=True used to raise here; the CFO/CPE stages are ported now, and
    on CFO-free frames the synced chain matches the JAX one (the tests of
    real CFO are in test_torch_cfo.py)."""
    got = sc.rx_chain(*torch_in, sync=True)
    want = jsc.rx_chain(*jax_in, sync=True)
    for name, tol in TOL.items():
        assert rel(to_np(getattr(got, name)), to_np(getattr(want, name))) < tol, name
