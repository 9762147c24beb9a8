"""The port's fused chain against the JAX fused-chain kernel.

On the CPU the port's wrapper runs its plain version (fused_chain_plain);
the JAX side runs its Pallas kernel in interpret mode, as its own tests do.
Both get the same numpy-seeded frames and the very same tx-constant
spectra (carried across by tpu80211_torch.convert).  The CUDA kernel
itself is held against the plain version in test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu80211.kernels import fused_chain as JF
from tpu80211_torch import convert
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import fused_chain as TF
from tpu80211_torch.pipeline import sc

from _torch_inputs import (TOL, assert_matches, jax_planes, lane_major, make_frames, rel,
                           to_np, torch_planes)

B_MAX = 256  # two of the JAX kernel's 128-lane tiles
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.float32, torch.float32)}

CASES = {
    "txconst-f32": dict(mode="txconst", dtype="f32", b=6),
    "txconst-bf16-b256": dict(mode="txconst", dtype="bf16", b=B_MAX),
    "txconst-int8": dict(mode="txconst", dtype="int8", b=6),
    "txconst-serve": dict(mode="txconst", dtype="f32", b=6, serve=True),
    "txconst-eps": dict(mode="txconst", dtype="f32", b=6, eps=0.01),
    "txconst-eq-wiener": dict(mode="txconst", dtype="f32", b=6, equalize_with="h_wiener"),
    "txconst-eq-mmse": dict(mode="txconst", dtype="bf16", b=6, equalize_with="h_mmse"),
    "txconst-wiener-prior": dict(mode="txconst", dtype="f32", b=6, wiener_model="C",
                                 wiener_snr_db=10.0),
    "lane-f32-b256": dict(mode="lane", dtype="f32", b=B_MAX),
    "lane-bf16": dict(mode="lane", dtype="bf16", b=6),
    "batch-f32": dict(mode="batch", dtype="f32", b=6),
}


@pytest.fixture(scope="module")
def frames():
    """Per-frame-tx frames and tx-constant frames, batch-major complex64."""
    return make_frames(seed=2, b=B_MAX), make_frames(seed=3, b=B_MAX, tx_const=True)


def _jax_spectra(const_frames):
    tx_pkt, _, tx_lp, _ = const_frames
    return JF.tx_spectra(jax_planes(tx_pkt[0]), jax_planes(tx_lp[0]))


def _port_spectra(const_frames):
    txs, tpre = _jax_spectra(const_frames)
    return convert.tx_spectra(*(np.asarray(a) for a in (txs.re, txs.im, tpre.re, tpre.im)))


def _run(case, frames, side):
    """Run one case through the JAX kernel (side="jax") or the port."""
    c = dict(CASES[case])
    mode, dtype, b = c.pop("mode"), c.pop("dtype"), c.pop("b")
    jdt, tdt = DTYPES[dtype]
    tx_pkt, rx_pkt, tx_lp, rx_lp = (x[:b] for x in frames[mode == "txconst"])
    if side == "jax":
        lane = lambda x: jax_planes(lane_major(x, JF.LANES), jdt)  # noqa: E731
        if mode == "txconst":
            rp, rl = lane(rx_pkt), lane(rx_lp)
            if dtype == "int8":
                rp, lsb = JF.quantize_i8(rp)
                rl, _ = JF.quantize_i8(rl, lsb)
                c["lsb"] = lsb
            return JF.fused_rx_chain_txconst(*_jax_spectra(frames[1]), rp, rl, **c)
        if mode == "lane":
            return JF.fused_rx_chain_lane_major(lane(tx_pkt), lane(rx_pkt), lane(tx_lp),
                                                lane(rx_lp), **c)
        return JF.fused_rx_chain(*(jax_planes(x, jdt) for x in (tx_pkt, rx_pkt, tx_lp, rx_lp)))
    lane = lambda x: torch_planes(lane_major(x), tdt)  # noqa: E731
    if mode == "txconst":
        rp, rl = lane(rx_pkt), lane(rx_lp)
        if dtype == "int8":
            rp, lsb = TF.quantize_i8(rp)
            rl, _ = TF.quantize_i8(rl, lsb)
            c["lsb"] = lsb
        return TF.fused_rx_chain_txconst(*_port_spectra(frames[1]), rp, rl, **c)
    if mode == "lane":
        return TF.fused_rx_chain_lane_major(lane(tx_pkt), lane(rx_pkt), lane(tx_lp),
                                            lane(rx_lp), **c)
    return TF.fused_rx_chain(*(torch_planes(x, tdt) for x in (tx_pkt, rx_pkt, tx_lp, rx_lp)))


@pytest.fixture(scope="module")
def results(frames):
    return functools.lru_cache(maxsize=None)(lambda case, side: _run(case, frames, side))


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_kernel(case, results):
    got, want = results(case, "port"), results(case, "jax")
    c = CASES[case]
    eq_dtype = torch.float32 if c["dtype"] == "f32" else torch.bfloat16
    assert got["eq"].re.dtype == eq_dtype
    assert_matches(got, want, c["b"], TOL[c["dtype"]], batch_major=c["mode"] == "batch")


def test_quantize_i8_matches_jax(frames):
    """The port's int8 quantizer gives JAX's words and ADC step exactly."""
    rx = frames[1][1][:6]
    got, lsb = TF.quantize_i8(torch_planes(lane_major(rx)))
    want, jlsb = JF.quantize_i8(jax_planes(lane_major(rx)))
    assert got.re.dtype == torch.int8
    assert float(lsb) == float(jlsb)
    np.testing.assert_array_equal(got.re.numpy(), np.asarray(want.re))
    np.testing.assert_array_equal(got.im.numpy(), np.asarray(want.im))


def test_consts_from_jax_equal_the_ports(frames, results):
    """JAX's _const_specs, carried across by convert, drive the plain
    version to the very same outputs as the port's own constants."""
    _, (wre, wim, win_re, win_im) = JF._const_specs()
    consts = convert.chain_consts(*(np.asarray(a) for a in (wre, wim, win_re, win_im)))
    _, rx_pkt, _, rx_lp = (x[:6] for x in frames[1])
    got = TF.fused_chain_plain(torch_planes(lane_major(rx_pkt)), torch_planes(lane_major(rx_lp)),
                               _port_spectra(frames[1]), consts)
    want = results("txconst-f32", "port")
    for name in (*TF.OUT_NAMES, "eq"):
        assert torch.equal(got[name].re, want[name].re) and torch.equal(got[name].im, want[name].im)


# -- the JAX file's own cases, on the port (tests/test_fused_chain.py) ------------


@pytest.fixture(scope="module")
def port_in(frames):
    """6 per-frame-tx frames, batch-major float32 planes."""
    return tuple(torch_planes(x[:6]) for x in frames[0])


def _lane(x: Cplx) -> Cplx:
    return x.map(lambda t: t.T.contiguous())


def test_fused_matches_sc(port_in):
    got = TF.fused_rx_chain(*port_in)
    want = sc.rx_chain(*(c.to_complex() for c in port_in))
    np.testing.assert_allclose(to_np(got["ow2"]), to_np(want.ow2), rtol=1e-4)
    for name, tol in (("h_lt", 1e-5), ("h_linear", 1e-5), ("h_cubic", 1e-5), ("h_sinc", 1e-5),
                      ("h_spline", 1e-5), ("h_wiener", 1e-5), ("h_mmse", 1e-3), ("eq", 1e-4)):
        g, w = to_np(got[name]), to_np(getattr(want, name))
        assert g.shape == w.shape, name
        assert rel(g, w) < tol, (name, rel(g, w))


def test_fused_ragged_batch_frame_by_frame(port_in):
    """B=6 is no multiple of anything the kernel tiles by: frame 3 through
    the chain alone equals frame 3 of the batch."""
    got = TF.fused_rx_chain(*port_in)
    want = TF.fused_rx_chain(*(c.map(lambda t: t[3:4]) for c in port_in))
    # the same f32 arithmetic, summed in another order for another batch
    for name, tol in (("h_mmse", 1e-3), ("eq", 1e-4), ("h_wiener", 1e-5)):
        assert rel(to_np(got[name])[3], to_np(want[name])[0]) < tol, name


def test_txconst_serve_mode_served_outputs_match(results):
    full, served = results("txconst-f32", "port"), results("txconst-serve", "port")
    for k in ("h_wiener", "h_mmse", "eq"):
        assert torch.equal(full[k].re, served[k].re) and torch.equal(full[k].im, served[k].im), k
    for k in ("ow2", "cfo", "checksum"):
        assert torch.equal(full[k], served[k]), k
    for k in TF.SERVE_DROP:
        assert k in served and served[k] is None, k


def test_txconst_int8_ingestion(results):
    """int8 ingestion reproduces the f32 chain within the 8-bit
    quantization floor, and eq comes out bf16."""
    ref, got = results("txconst-f32", "port"), results("txconst-int8", "port")
    assert got["eq"].re.dtype == torch.bfloat16
    for k in ("h_lt", "h_linear", "h_mmse", "h_wiener"):
        # ~2⁻⁷ per sample, averaged down by the DFT and the block means
        assert rel(to_np(got[k]), to_np(ref[k])) < 0.05, k


def test_fused_eps_and_checksum(port_in):
    """The in-chain perturbation equals scaling the inputs outside, and the
    per-frame checksum equals the sum over every output."""
    lane = tuple(_lane(x) for x in port_in)
    eps = 0.01
    got = TF.fused_rx_chain_lane_major(*lane, eps=eps)
    want = TF.fused_rx_chain_lane_major(*(x.map(lambda t: t * (1 + eps)) for x in lane))
    for k in ("h_lt", "h_mmse", "eq", "ow2", "checksum"):
        assert rel(to_np(got[k]), to_np(want[k])) < 1e-5, k
    acc = to_np(got["ow2"])
    for k in TF.OUT_NAMES + ("eq",):
        v = got[k]
        for t in v:
            acc = acc + t.to(torch.float64).reshape(-1, t.shape[-1]).sum(0).numpy()
    np.testing.assert_allclose(to_np(got["checksum"]), acc, rtol=1e-4, atol=1e-6)


def test_fused_bf16_inputs(port_in):
    """bf16 storage tracks f32 within bf16 precision; eq stays bf16."""
    got = TF.fused_rx_chain(*(c.map(lambda t: t.to(torch.bfloat16)) for c in port_in))
    want = TF.fused_rx_chain(*port_in)
    assert got["eq"].re.dtype == torch.bfloat16
    for name, tol in (("h_lt", 3e-2), ("h_linear", 3e-2), ("h_mmse", 8e-2)):
        assert rel(to_np(got[name]), to_np(want[name])) < tol, name


def test_fused_wiener_matches_ps_interp(port_in):
    got = TF.fused_rx_chain(*port_in)["h_wiener"]
    tx_pkt, rx_pkt, _, _ = (c.to_complex() for c in port_in)
    want = sc.ps_interp(sc.extract_blocks(tx_pkt), sc.extract_blocks(rx_pkt), "wiener")
    assert rel(to_np(got), to_np(want)) < 1e-5


def test_fused_txconst_matches_regular(frames):
    """tx-constant mode equals the per-frame-tx chain when every frame
    carries the same packet."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = (x[:6] for x in frames[1])
    lane = lambda x: torch_planes(lane_major(x))  # noqa: E731
    want = TF.fused_rx_chain_lane_major(lane(tx_pkt), lane(rx_pkt), lane(tx_lp), lane(rx_lp))
    txc = TF.tx_spectra(torch_planes(tx_pkt[0]), torch_planes(tx_lp[0]))
    got = TF.fused_rx_chain_txconst(*txc, lane(rx_pkt), lane(rx_lp))
    for name, tol in (("h_lt", 1e-5), ("h_linear", 1e-5), ("h_wiener", 1e-5),
                      ("h_mmse", 1e-3), ("eq", 1e-4)):
        assert rel(to_np(got[name]), to_np(want[name])) < tol, name


@pytest.mark.parametrize("kw", [{"sync": True}, {"evm_sums": True}])
def test_sync_and_evm_sums_not_ported(port_in, kw):
    lane = tuple(_lane(x) for x in port_in)
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        TF.fused_chain(lane[1], lane[3], TF.TxFrames(lane[0], lane[2]), TF.chain_consts("cpu"), **kw)


def test_wrapper_never_falls_back(port_in):
    """A tensor off the CPU launches the kernel or raises: on a device that
    is not CUDA, the wrapper raises instead of running the plain version."""
    lane = tuple(_lane(x).map(lambda t: t.to("meta")) for x in port_in)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        TF.fused_rx_chain_lane_major(*lane)


@pytest.mark.parametrize("bad", ["shape", "int8-per-frame", "equalize_with", "tx-dtype"])
def test_rejects_bad_inputs(port_in, bad):
    tx_pkt, rx_pkt, tx_lp, rx_lp = (_lane(x) for x in port_in)
    consts = TF.chain_consts("cpu")
    tx = TF.TxFrames(tx_pkt, tx_lp)
    kw = {}
    if bad == "shape":
        rx_pkt, err = rx_pkt.map(lambda t: t[:-1]), ValueError
    elif bad == "int8-per-frame":
        rx_pkt, rx_lp = (c.map(lambda t: t.to(torch.int8)) for c in (rx_pkt, rx_lp))
        tx = TF.TxFrames(*(c.map(lambda t: t.to(torch.int8)) for c in (tx_pkt, tx_lp)))
        err = TypeError
    elif bad == "equalize_with":
        kw, err = {"equalize_with": "h_cubic"}, ValueError
    else:
        tx, err = TF.TxFrames(tx_pkt.map(lambda t: t.to(torch.bfloat16)), tx_lp), ValueError
    with pytest.raises(err):
        TF.fused_chain(rx_pkt, rx_lp, tx, consts, **kw)
