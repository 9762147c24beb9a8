"""The port's frame generators against the JAX package, on the CPU.

jax.random and torch draw different numbers from one seed, so each JAX
generator's normals are rebuilt here by repeating its own key splits and
handed to the port's assembly (``assemble_rx``, ``assemble_raw``,
``synthetic.assemble``): both sides then build frames from the very same
draws.  The port's own draws (a ``torch.Generator``) are checked for their
contract and statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.cplx import Cplx as JCplx
from tpu80211.datasets import synthetic as JS
from tpu80211.datasets import synthetic_sc as JSC
from tpu80211.kernels import fused_chain as JF
from tpu80211.utils.metrics import pam_levels as jax_pam_levels
from tpu80211_torch import convert
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets import synthetic as TS
from tpu80211_torch.datasets import synthetic_sc as TSC
from tpu80211_torch.ops import channel

from _torch_inputs import rel, to_np

B = 128
NS = 2048
# bf16 samples: both sides round the same f32 IDFT sums to bf16, but the sums
# run in another order, so an f32 difference of one ulp can flip a rounding:
# one bf16 ulp is at most 2⁻⁷ of the value
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def spectra():
    """(JAX (txs, tpre), the port's TxConst) of the shipped capture."""
    from tpu80211.datasets.loader import load_capture

    cap = load_capture()
    txs, tpre = JF.tx_spectra(JCplx.from_complex(cap.tx_packet, jnp.float32),
                              JCplx.from_complex(cap.tx_lptot, jnp.float32))
    port = convert.tx_spectra(*(np.asarray(a) for a in (txs.re, txs.im, tpre.re, tpre.im)),
                              device="cpu")
    return (txs, tpre), port


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _pair(key, shape) -> Cplx:
    """The JAX generators' complex normals: re and im from a split key."""
    kr, ki = jax.random.split(key)
    return Cplx(_t(jax.random.normal(kr, shape, jnp.float32)),
                _t(jax.random.normal(ki, shape, jnp.float32)))


def _rx_draws(key, b, model, noise=True) -> TSC.RxDraws:
    """generate_rx_lane_major's draws (synthetic_sc.py:124-165)."""
    k_ch, k_np, k_nl = jax.random.split(key, 3)
    taps = _pair(k_ch, (channel.n_taps_for(model), b))
    if not noise:
        return TSC.RxDraws(taps, None, None)
    return TSC.RxDraws(taps, _pair(k_np, (1200, b)), _pair(k_nl, (160, b)))


def _assert_samples(got: Cplx, want: JCplx, dtype) -> None:
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape
    if dtype == torch.float32:
        assert rel(g, w) < 1e-5
        return
    assert got.re.dtype == torch.bfloat16
    # at most one bf16 ulp of each value apart, and nearly all bit-equal
    assert (np.abs(g - w) <= BF16_ULP * np.abs(w) + 1e-12).all()
    assert (g == w).mean() > 0.99


def test_matrices_equal_jax():
    for n in (8, 12, 16):
        for got, want in zip(TSC._synth_mats(n), JSC._synth_mats(n)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TS._lts_spectrum(), JS._lts_spectrum())
    for m in (4, 16, 64):
        np.testing.assert_array_equal(TS.pam_levels(m), jax_pam_levels(m))
    with pytest.raises(ValueError):
        TS.pam_levels(8)


@pytest.mark.parametrize("model", [None, "A", "D"])
def test_channel_cfr_matches_jax(model):
    key = jax.random.PRNGKey(11)
    want = JSC.channel_cfr(key, B, model)
    got = TSC.cfr_from_draws(_pair(key, (channel.n_taps_for(model), B)), model)
    # an f32 sum of ≤ 16 taps, in another order
    assert rel(to_np(got), to_np(want)) < 1e-6


RX_CASES = {"bf16-legacy": (torch.bfloat16, None, 20.0), "f32-A": (torch.float32, "A", 30.0),
            "bf16-E": (torch.bfloat16, "E", 10.0)}


@pytest.mark.parametrize("case", list(RX_CASES))
def test_generate_rx_matches_jax(spectra, case):
    dtype, model, snr = RX_CASES[case]
    (jtxs, jtpre), port = spectra
    key = jax.random.PRNGKey(5)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    wp, wl, wh = JSC.generate_rx_lane_major(key, B, jtxs, jtpre, snr_db=snr, dtype=jdt,
                                            channel_model=model)
    gp, gl, gh = TSC.assemble_rx(_rx_draws(key, B, model), *port, snr_db=snr, dtype=dtype,
                                 channel_model=model)
    assert rel(to_np(gh), to_np(wh)) < 1e-6
    _assert_samples(gp, wp, dtype)
    _assert_samples(gl, wl, dtype)


def test_generate_rx_without_noise_matches_jax(spectra):
    (jtxs, jtpre), port = spectra
    key = jax.random.PRNGKey(8)
    wp, wl, _ = JSC.generate_rx_lane_major(key, B, jtxs, jtpre, dtype=jnp.float32, noise=False)
    gp, gl, _ = TSC.assemble_rx(_rx_draws(key, B, None, noise=False), *port,
                                dtype=torch.float32)
    _assert_samples(gp, wp, torch.float32)
    _assert_samples(gl, wl, torch.float32)


@pytest.mark.parametrize("model", [None, "C"])
def test_generate_raw_matches_jax(spectra, model):
    """generate_raw_lane_major's draws (synthetic_sc.py:192-216): the frame,
    the offsets, the two noise planes; placement by each side's own."""
    (jtxs, jtpre), port = spectra
    key = jax.random.PRNGKey(3)
    wx, wh, woffs = JSC.generate_raw_lane_major(key, B, jtxs, jtpre, ns=NS, snr_db=25.0,
                                                channel_model=model)
    k_f, k_o, k_nr, k_ni = jax.random.split(key, 4)
    taps = _rx_draws(k_f, B, model, noise=False).taps
    offs = _t(jax.random.randint(k_o, (B,), 40, NS - 1360, dtype=jnp.int32))
    noise = Cplx(_t(jax.random.normal(k_nr, (NS, B), jnp.float32)),
                 _t(jax.random.normal(k_ni, (NS, B), jnp.float32)))
    gx, gh, goffs = TSC.assemble_raw(TSC.RawStreamDraws(taps, offs, noise), *port, snr_db=25.0,
                                     channel_model=model)
    np.testing.assert_array_equal(goffs.numpy(), np.asarray(woffs))
    assert rel(to_np(gh), to_np(wh)) < 1e-6
    _assert_samples(gx, wx, torch.bfloat16)


def test_own_draws_contract_and_statistics(spectra):
    """A seeded generator gives the same batch again; the channel has unit
    power on average; offsets lie in [40, NS − 1360); the device is the
    generator's."""
    _, port = spectra
    x, h, offs = TSC.generate_raw_lane_major(torch.Generator().manual_seed(1), 512, *port, ns=NS)
    again, _, offs2 = TSC.generate_raw_lane_major(torch.Generator().manual_seed(1), 512, *port,
                                                  ns=NS)
    assert torch.equal(x.re, again.re) and torch.equal(offs, offs2)
    assert x.re.shape == (NS, 512) and x.re.dtype == torch.bfloat16 and x.re.device == h.re.device
    assert int(offs.min()) >= 40 and int(offs.max()) < NS - 1360
    # 512 frames × 53 bins: the mean of |H|² has a standard error of ~3%
    assert abs(float((h.re ** 2 + h.im ** 2).mean()) - 1.0) < 0.15
    pkt, lp, h = TSC.generate_rx_lane_major(torch.Generator().manual_seed(2), B, *port)
    assert pkt.re.shape == (1200, B) and lp.re.shape == (160, B) and h.re.shape == (53, B)
    with pytest.raises(ValueError, match="shorter"):
        TSC.raw_draws(torch.Generator(), B, ns=1360)


# -- datasets/synthetic.py --------------------------------------------------------------------


def _frame_draws(key, b, model, modulation) -> TS.FrameDraws:
    """generate's draws (synthetic.py:110-157)."""
    k_ch, k_data, k_n1, k_n2, _ = jax.random.split(key, 5)
    taps = _pair(k_ch, (b, channel.n_taps_for(model)))
    shape = (b, 15, 53)
    if modulation == "qpsk":
        data = _t(jax.random.bernoulli(k_data, 0.5, shape + (2,)))
    else:
        n = {"qam16": 4, "qam64": 8}[modulation]
        ki, kq = jax.random.split(k_data)
        data = torch.stack([_t(jax.random.randint(k, shape, 0, n)) for k in (ki, kq)], -1)
    n1, n2 = _pair(k_n1, shape), _pair(k_n2, (b, 53))
    return TS.FrameDraws(taps.re, taps.im, data, n1.re, n1.im, n2.re, n2.im)


GEN_CASES = {"qpsk": dict(), "qam16-A": dict(modulation="qam16", channel_model="A"),
             "qam64-fo": dict(modulation="qam64", fo_hz=20e3, snr_db=25.0),
             "qpsk-E-fo": dict(channel_model="E", fo_hz=-5e3)}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_matches_jax(case):
    """Every field of the FrameBatch, complex64 on both sides (the JAX side
    may carry its noise in complex128 under x64): within f32 rounding."""
    kw = GEN_CASES[case]
    key = jax.random.PRNGKey(21)
    want = JS.generate(key, B, **kw)
    got = TS.assemble(_frame_draws(key, B, kw.get("channel_model"), kw.get("modulation", "qpsk")),
                      **kw)
    for name in TS.FrameBatch._fields:
        g, w = to_np(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        assert rel(g, w) < 1e-6, (name, rel(g, w))
    assert got.rx_symb.dtype == torch.complex64


def test_generate_own_draws():
    """The port's draws: deterministic per generator seed; QAM symbols of
    unit average power; pilots +1 and DC empty; the modulation is checked."""
    fb = TS.generate(torch.Generator().manual_seed(4), 256, modulation="qam64", snr_db=80.0)
    again = TS.generate(torch.Generator().manual_seed(4), 256, modulation="qam64", snr_db=80.0)
    assert torch.equal(fb.rx_symb, again.rx_symb)
    pilot = torch.tensor(TS.C.PILOT_MASK)
    dc = torch.arange(TS.C.N_SC) == TS.C.DC_IDX
    assert torch.equal(fb.tx_symb[..., pilot], torch.ones_like(fb.tx_symb[..., pilot]))
    assert float(fb.tx_symb[..., dc].abs().max()) == 0.0
    # 256 · 15 · 48 symbols of 64-QAM: the mean power's standard error is ~0.3%
    power = float(fb.tx_symb[..., ~pilot & ~dc].abs().square().mean())
    assert abs(power - 1.0) < 0.02
    with pytest.raises(ValueError, match="modulation"):
        TS.generate(torch.Generator(), 4, modulation="bpsk")


@pytest.mark.parametrize("lead", [(), (3,)])
def test_time_views_match_jax(lead):
    rng = np.random.default_rng(9)
    symb = rng.standard_normal(lead + (15, 53)) + 1j * rng.standard_normal(lead + (15, 53))
    pre = rng.standard_normal(lead + (53,)) + 1j * rng.standard_normal(lead + (53,))
    t_symb, t_pre = torch.tensor(symb), torch.tensor(pre)
    np.testing.assert_allclose(TS.synthesize_time(t_symb).numpy(),
                               np.asarray(JS.synthesize_time(jnp.asarray(symb))), atol=1e-12)
    np.testing.assert_allclose(TS.synthesize_preamble_time(t_pre).numpy(),
                               np.asarray(JS.synthesize_preamble_time(jnp.asarray(pre))),
                               atol=1e-12)
    x = TS.synthesize_time(t_symb)
    np.testing.assert_allclose(TS.apply_time_cfo(x, 1e-3, start=160).numpy(),
                               np.asarray(JS.apply_time_cfo(jnp.asarray(x.numpy()), 1e-3,
                                                            start=160)), atol=1e-12)
    with pytest.raises(ValueError):
        TS.synthesize_time(t_symb[..., :52])
