"""The port's numpy builders and constants against tpu80211's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211 import constants as JC
from tpu80211.config import EstimatorMode as JMode
from tpu80211.datasets import loader as jloader
from tpu80211.kernels import fused_chain as JF
from tpu80211.ops import channel as jchannel
from tpu80211.ops import interp as jinterp
from tpu80211.ops import specmats as jspec
from tpu80211_torch import constants as TC
from tpu80211_torch import convert
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.datasets import loader as tloader
from tpu80211_torch.kernels import fused_chain as TF
from tpu80211_torch.ops import channel as tchannel
from tpu80211_torch.ops import interp as tinterp
from tpu80211_torch.ops import specmats as tspec

from _torch_inputs import jax_planes, torch_planes

# both sides build in float64 numpy from the same formulas: 1e-12 leaves
# room only for a different order of float64 operations
TOL = 1e-12


@pytest.mark.parametrize("name", ["block_dft", "dft53", "idft53"])
def test_specmats_equal(name):
    for got, want in zip(getattr(tspec, name)(), getattr(jspec, name)()):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", list(EstimatorMode))
@pytest.mark.parametrize("kind", ["linear", "cubic", "sinc", "spline", "wiener"])
def test_interp_matrix_equal(kind, mode):
    got = tinterp.interp_matrix(kind, mode)
    want = jinterp.interp_matrix(kind, JMode(mode.value))
    assert got.shape == want.shape == (4, 53)
    assert np.iscomplexobj(got) == np.iscomplexobj(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("model", [None, "A", "B", "C", "D", "E"])
@pytest.mark.parametrize("snr_db", [20.0, 7.5])
def test_wiener_matrix_for_equal(model, snr_db):
    np.testing.assert_allclose(tinterp.wiener_matrix_for(model, snr_db),
                               jinterp.wiener_matrix_for(model, snr_db), rtol=0, atol=TOL)


@pytest.mark.parametrize("model", [None, "A", "B", "C", "D", "E"])
def test_channel_profiles_equal(model):
    assert tchannel.rms_samples(model) == jchannel.rms_samples(model)
    assert tchannel.n_taps_for(model) == jchannel.n_taps_for(model)
    np.testing.assert_allclose(tchannel.pdp(model), jchannel.pdp(model), rtol=0, atol=TOL)


def test_interp_matrix_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown interpolation kind"):
        tinterp.interp_matrix("nearest")


def test_constants_are_a_copy():
    names = [n for n in dir(JC) if n.isupper()]
    assert names == [n for n in dir(TC) if n.isupper()]
    for n in names:
        np.testing.assert_array_equal(getattr(TC, n), getattr(JC, n), err_msg=n)


def test_loader_reads_the_same_capture():
    got, want = tloader.load_capture(), jloader.load_capture()
    for field in ("tx_preamble_fft", "rx_preamble_fft", "tx_symb", "rx_symb",
                  "tx_packet", "rx_packet", "tx_lptot", "rx_lptot"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.ow2 == want.ow2


@pytest.mark.parametrize("model,snr", [(None, None), ("C", 10.0)])
def test_convert_const_specs_round_trip(model, snr):
    """JAX's fused-chain constants, carried across, equal the port's own:
    both cast the same float64 matrices to float32, so exactly."""
    _, (wre, wim, win_re, win_im) = JF._const_specs(model, snr)
    got = convert.chain_consts(*(np.asarray(a) for a in (wre, wim, win_re, win_im)))
    want = TF.chain_consts("cpu", model, snr)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_convert_tx_spectra_round_trip(capture):
    """JAX's tx_spectra, carried across, match the port's tx_spectra: both
    are f32 DFTs of the same samples, so within f32 summation order
    (5e-6 of the largest bin)."""
    jtxs, jtpre = JF.tx_spectra(jax_planes(capture.tx_packet), jax_planes(capture.tx_lptot))
    got = convert.tx_spectra(*(np.asarray(a) for a in (jtxs.re, jtxs.im, jtpre.re, jtpre.im)))
    want = TF.tx_spectra(torch_planes(capture.tx_packet), torch_planes(capture.tx_lptot))
    assert got.txs.re.shape == (53, 16) and got.tpre.re.shape == (53, 1)
    for g, w in ((got.txs, want.txs), (got.tpre, want.tpre)):
        scale = float(w.to_complex().abs().max())
        for gp, wp in zip(g, w):
            torch.testing.assert_close(gp, wp, rtol=0, atol=5e-6 * scale)
    assert np.asarray(jtxs.re).dtype == jnp.float32
