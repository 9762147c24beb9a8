"""The port's generative raw system against the JAX package, on the CPU.

The JAX package's ``gen_raw_system`` off the TPU composes another generator
(jax.random, placement, the staged receiver), so the TPU kernel
``_gen_raw_kernel`` has no CPU twin to run.  Its reference here is composed
from the JAX package's own pieces, fed the port's draws: ``_cfr_mats`` and
``_pdp_scale`` for the channel, ``_idft_mats`` and the layout of
raw_gen_chain.py:117-135 for the frame, bf16 rounding, placement at the
offset, the CFO ramp and the noise, ``detect_kernel._detect_core``
(decimated), and the fused chain's kernel body in interpret mode on the
aligned bf16 rows with ``sync``, ``evm_sums`` and serving.  The CUDA kernel
is held against ``gen_raw_plain`` in test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.cplx import Cplx as JCplx
from tpu80211.kernels import detect_kernel as JD
from tpu80211.kernels import fused_chain as JF
from tpu80211.kernels import gen_chain as JG
from tpu80211.kernels import raw_gen_chain as JR
from tpu80211_torch import convert
from tpu80211_torch.kernels import raw_gen_chain as TR
from tpu80211_torch.ops import channel

from _torch_inputs import TOL, assert_matches, lts_taps, rel, to_np

B = 128
NS = 2048


@pytest.fixture(scope="module")
def consts():
    """(JAX txs, tpre, LTS; the port's TxConst and LTS), float32."""
    from tpu80211.datasets.loader import load_capture

    cap = load_capture()
    txs, tpre = JF.tx_spectra(JCplx.from_complex(cap.tx_packet, jnp.float32),
                              JCplx.from_complex(cap.tx_lptot, jnp.float32))
    h = lts_taps()
    port = convert.tx_spectra(*(np.asarray(a) for a in (txs.re, txs.im, tpre.re, tpre.im)),
                              device="cpu")
    return (txs, tpre, h), (port, convert.lts_ref(h.real, h.imag, device="cpu"))


def test_idft_mats_equal_jax():
    for got, want in zip(TR._idft_mats(), JR._idft_mats()):
        np.testing.assert_array_equal(got, want)


def _jax_chain(txs, tpre, pkt, lp, model, snr, sync, equalize_with):
    """_gen_raw_kernel's chain call (raw_gen_chain.py:195-200) in interpret
    mode: the tx-constant body on bf16 rows, serve, eq stub, evm_sums."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    b = pkt[0].shape[-1]
    mem = pltpu.VMEM
    vspec = lambda dim: pl.BlockSpec((dim, JF.LANES), lambda i: (0, i), memory_space=mem)  # noqa: E731
    cspec = lambda r, c: pl.BlockSpec((r, c), lambda i: (0, 0), memory_space=mem)  # noqa: E731
    cspecs, cvals = JF._const_specs(model, snr)
    out_specs, out_shape = JF._out_specs_shapes(b, jnp.bfloat16, serve=True, eq_stub=True,
                                                evm_sums=True)
    outs = pl.pallas_call(
        functools.partial(JF._kernel, tx_const=True, sync=sync, evm_sums=True,
                          equalize_with=equalize_with),
        grid=(b // JF.LANES,),
        in_specs=[cspec(53, JF.NB_PAD)] * 2 + [cspec(53, 1)] * 2 + [vspec(1200)] * 2
        + [vspec(160)] * 2 + cspecs,
        out_specs=out_specs, out_shape=out_shape, interpret=True,
    )(txs.re, txs.im, tpre.re, tpre.im, *pkt, *lp, *cvals,
      jnp.zeros((1, 1), jnp.float32), jnp.ones((1, 1), jnp.float32))
    return JF._pack_outputs(outs, serve=True, eq_stub=True, evm_sums=True)


def _jax_reference(draws, jconsts, snr, model, equalize_with, cfo_khz):
    """_gen_raw_kernel composed from the JAX package's pieces on ``draws``."""
    f32, f64 = np.float32, np.float64
    txs, tpre, h_lts = jconsts
    z = to_np(draws.taps)
    ts = JG._pdp_scale(model)
    t_re, t_im = z.real.astype(f32) * ts, z.imag.astype(f32) * ts
    wcr, wci = (a.astype(f64) for a in JG._cfr_mats(ts.shape[0]))
    h_re = (wcr @ t_re.astype(f64) - wci @ t_im.astype(f64)).astype(f32)
    h_im = (wcr @ t_im.astype(f64) + wci @ t_re.astype(f64)).astype(f32)
    vre, vim = (a.astype(f64) for a in JR._idft_mats())

    def idft(sr, si):  # (53, B) f32 → (64, B), bf16-rounded as the kernel places it
        tr = (vre @ sr.astype(f64) - vim @ si.astype(f64)).astype(f32)
        ti = (vre @ si.astype(f64) + vim @ sr.astype(f64)).astype(f32)
        return tuple(np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))
                     for t in (tr, ti))

    # the layout of raw_gen_chain.py:117-135: [last 32 | rep | rep], then [CP | 64] × 15
    tp_r, tp_i = np.asarray(tpre.re), np.asarray(tpre.im)
    p64 = idft(tp_r * h_re - tp_i * h_im, tp_r * h_im + tp_i * h_re)
    pieces = [[p[-32:], p, p] for p in p64]
    for b in range(15):
        tb_r, tb_i = np.asarray(txs.re)[:, b:b + 1], np.asarray(txs.im)[:, b:b + 1]
        blk = idft(tb_r * h_re - tb_i * h_im, tb_r * h_im + tb_i * h_re)
        for part, t in zip(pieces, blk):
            part += [t[-16:], t]
    frame = [np.concatenate(p) for p in pieces]                       # (1360, B)
    offs = 40 + (draws.offset_word.numpy() & 0x7FFFFFFF) % (NS - 1360 - 40)
    sig = [np.zeros((NS, B), f32) for _ in range(2)]
    for lane, o in enumerate(offs):
        for s, fr in zip(sig, frame):
            s[o:o + 1360, lane] = fr[:, lane]
    eps = np.zeros(B, f32)
    if cfo_khz > 0:
        u = (draws.cfo_word.numpy() >> 8).astype(f32) * f32(2.0 ** -24)
        eps = (f32(2.0) * u - f32(1.0)) * f32(cfo_khz * 1e3 / 20e6)
        ang = (f32(2 * np.pi) * eps)[None, :] * np.arange(NS, dtype=f32)[:, None]
        c, s_ = np.cos(ang.astype(f64)).astype(f32), np.sin(ang.astype(f64)).astype(f32)
        sig = [sig[0] * c - sig[1] * s_, sig[0] * s_ + sig[1] * c]
    nsc = f32(np.sqrt((10.0 ** (-snr / 10.0)) / 64 / 2.0))
    n = to_np(draws.noise)
    x = [sig[0] + nsc * n.real.astype(f32), sig[1] + nsc * n.imag.astype(f32)]

    wrr, wri = JD._mf_bands((tuple(map(float, h_lts.real)), tuple(map(float, h_lts.imag))))
    det, _, start, metric = JD._detect_core(jnp.asarray(x[0]), jnp.asarray(x[1]),
                                            jnp.asarray(wrr), jnp.asarray(wri), ns=NS,
                                            threshold=0.5, search=192, advance=4, decimate=True)
    det = np.asarray(det[0]) > 0
    s0 = np.clip(np.where(det, np.asarray(start[0]), 0), 0, NS - 1360)
    rows = s0[None, :] + np.arange(1360)[:, None]
    cut = [jnp.asarray(np.take_along_axis(v, rows, 0)).astype(jnp.bfloat16) for v in x]
    out = _jax_chain(txs, tpre, (cut[0][160:], cut[1][160:]), (cut[0][:160], cut[1][:160]),
                     model, snr, cfo_khz > 0, equalize_with)
    out.update(detected=det, start=np.where(det, np.asarray(start[0]), -1),
               metric=np.asarray(metric[0]), offsets=offs, h_true=h_re + 1j * h_im,
               cfo_true=eps, field=x)
    return out


REF_CASES = {
    "snr20-mmse": dict(snr=20.0, model=None, equalize_with="h_mmse", cfo_khz=0.0),
    "cfo40-sync": dict(snr=30.0, model=None, equalize_with="h_mmse", cfo_khz=40.0),
    "A-linear": dict(snr=25.0, model="A", equalize_with="h_linear", cfo_khz=0.0),
}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_plain_matches_jax_composition(consts, case):
    """The field bit for bit (the same f32 roundings on both sides), the
    detection rows exactly, the chain's outputs at the bf16 tolerances (both
    chains read the same bf16 rows and sum in other orders)."""
    kw = REF_CASES[case]
    jconsts, (port, lts) = consts
    draws = TR.raw_draws(11, B, channel.n_taps_for(kw["model"]), NS, device="cpu")
    want = _jax_reference(draws, jconsts, kw["snr"], kw["model"], kw["equalize_with"],
                          kw["cfo_khz"])
    got = TR.gen_raw_assemble(draws, *port, lts, snr_db=kw["snr"], channel_model=kw["model"],
                              equalize_with=kw["equalize_with"], cfo_khz=kw["cfo_khz"],
                              return_field=True)
    for g, w in zip(got["field"], want["field"]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got["offsets"].numpy(), want["offsets"])
    np.testing.assert_array_equal(got["cfo_true"].numpy(), want["cfo_true"])
    assert rel(to_np(got["h_true"]), want["h_true"]) < 1e-6
    np.testing.assert_array_equal(got["detected"].numpy(), want["detected"])
    np.testing.assert_array_equal(got["start"].numpy(), want["start"])
    # the port's detector sums in f64, _detect_core in f32 (test_torch_detect.py)
    assert rel(got["metric"].numpy(), want["metric"]) < 1e-6
    assert got["eq"] is None and got["h_lt"] is None
    if not kw["cfo_khz"]:
        assert_matches(got, want, B, TOL["bf16"])
        return
    # With sync, JAX's CFO estimate goes through its polynomial _atan2 (a
    # Mosaic workaround, ≤ 2e-7 rad) and the port's through atan2 in f64:
    # eps differs by ~4e-10.  That moves derotated samples by an f32 ulp and
    # flips a few of their bf16 roundings, each moving an eq element by one
    # bf16 ulp (2⁻⁸).  The estimates average that away (bf16 tolerances
    # hold); the checksum moves by ~2e-4 of the largest, and a stream's EVM
    # sum, a residual ~3% of |tx|, by up to ~2% (measured): 1e-3 and 5e-2.
    np.testing.assert_allclose(to_np(got["cfo"]), to_np(want["cfo"]), rtol=0, atol=1e-8)
    for name in ("h_wiener", "h_mmse"):
        assert rel(to_np(got[name]), to_np(want[name])) < TOL["bf16"][name if name in
                                                                      TOL["bf16"] else "h"]
    np.testing.assert_allclose(to_np(got["ow2"]), to_np(want["ow2"]), rtol=1e-4)
    assert rel(to_np(got["checksum"]), to_np(want["checksum"])) < 1e-3
    np.testing.assert_allclose(to_np(got["evm_sums"]), to_np(want["evm_sums"]), rtol=5e-2)


def test_span_is_checked(consts):
    """The TPU kernel takes its offset modulo ns − 1400 unchecked; the port
    raises where that is not positive."""
    _, (port, lts) = consts
    with pytest.raises(ValueError, match="no room"):
        TR.gen_raw_system(0, B, *port, lts, ns=1344)
    assert TR.span_of(2048) == 648


@pytest.mark.parametrize("cfo_khz", [0.0, 40.0])
def test_plain_runs_at_the_least_length(consts, cfo_khz):
    """1,408 rows, the least multiple of 64 that holds a frame, run through
    the plain synthesis and the plain detection of the field: every frame
    found, timing mostly in [−4, −2] (the channel is dispersive, as in
    test_detection_timing_and_mmse_equalizer); 1,344 rows and 1,410 are
    refused."""
    _, (port, lts) = consts
    out = TR.gen_raw_plain(5, B, *port, lts, ns=1408, snr_db=30.0, cfo_khz=cfo_khz,
                           return_field=True)
    assert out["field"].re.shape == (1408, B)
    assert out["detected"].all()
    band = (out["start"] - out["offsets"]).numpy()
    assert np.mean((band >= -4) & (band <= -2)) > 0.7, band
    assert torch.isfinite(out["evm_sums"]).all()
    for ns in (1344, 1410):
        with pytest.raises(ValueError):
            TR.gen_raw_plain(5, B, *port, lts, ns=ns)


# -- statistics of the port's own draws (tests/test_stream.py:108-190) ---------------------------


def _evm(out, port, mask=None) -> float:
    den = float((port.txs.re[:, :15].double() ** 2 + port.txs.im[:, :15].double() ** 2).sum())
    s = out["evm_sums"].double()
    s = s if mask is None else s[mask]
    return float(torch.sqrt(s.sum() / (s.numel() * den)))


def test_detection_timing_and_mmse_equalizer(consts):
    """Every stream detected at SNR 30, timing mostly in [−4, −2] (a
    dispersive channel moves the fine timing inside the CP); the MMSE
    estimate equalizes the channel the PS-Linear blend cannot."""
    _, (port, lts) = consts
    lin = TR.gen_raw_system(7, B, *port, lts, snr_db=30.0)
    mmse = TR.gen_raw_system(7, B, *port, lts, snr_db=30.0, equalize_with="h_mmse")
    assert lin["detected"].all()
    err = (lin["start"] - lin["offsets"]).numpy()
    assert ((err >= -4) & (err <= -2)).mean() > 0.7
    assert torch.equal(lin["start"], mmse["start"])
    e_lin, e_mmse = _evm(lin, port), _evm(mmse, port)
    assert e_mmse < 0.1 and e_mmse < e_lin / 10.0, (e_lin, e_mmse)
    # the sampled channel is unit power on average
    assert abs(float(lin["h_true"].to_complex().abs().square().mean()) - 1.0) < 0.15


def test_cfo_impairment_and_recovery(consts):
    """cfo_khz=40: per-stream offsets up to ±40 kHz, recovered by the
    chain's Moose CFO and pilot CPE within 200 Hz (median); EVM < 0.15."""
    _, (port, lts) = consts
    out = TR.gen_raw_system(3, B, *port, lts, snr_db=30.0, equalize_with="h_mmse",
                            cfo_khz=40.0)
    assert out["detected"].all()
    assert float(out["cfo_true"].abs().max()) <= 40e3 / 20e6
    assert float(out["cfo_true"].abs().max()) > 20e3 / 20e6
    err_hz = ((out["cfo"] - out["cfo_true"]).abs() * 20e6).numpy()
    assert np.median(err_hz) < 200.0, np.median(err_hz)
    assert _evm(out, port) < 0.15


def test_streams_depend_on_seed_and_stream_only(consts):
    """Stream l's draws depend on (seed, l): the first 128 streams of a batch
    of 256 are the batch of 128; another seed moves every offset."""
    _, (port, lts) = consts
    small = TR.gen_raw_system(5, B, *port, lts)
    big = TR.gen_raw_system(5, 2 * B, *port, lts)
    for k in ("offsets", "start", "detected", "cfo_true"):
        assert torch.equal(small[k], big[k][:B]), k
    assert torch.equal(small["h_true"].re, big["h_true"].re[:, :B])
    np.testing.assert_allclose(small["evm_sums"].numpy(), big["evm_sums"][:B].numpy(), rtol=1e-5)
    other = TR.gen_raw_system(6, B, *port, lts)
    assert not torch.equal(other["offsets"], small["offsets"])


def test_wrapper_never_falls_back(consts):
    _, (port, lts) = consts
    meta = [c.map(lambda t: t.to("meta")) for c in (*port, lts)]
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        TR.gen_raw_system(0, B, *meta)
