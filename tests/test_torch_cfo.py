"""The port's CFO/CPE stages (ops/cfo.py, rx_chain(sync=True)) and the fused
chain's sync and evm_sums branches against the JAX package, on the CPU.

Frames carry a genuine time-domain CFO, continuous from preamble to packet
(tests/test_cfo.py's impairment).  The JAX fused kernel runs in interpret
mode, as its own tests run it; the port's wrapper runs its plain version.
The CUDA kernel itself is held against the plain version in
test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211 import constants as JC
from tpu80211.cplx import Cplx as JCplx
from tpu80211.datasets import synthetic
from tpu80211.kernels import fused_chain as JF
from tpu80211.ops import cfo as jcfo
from tpu80211.pipeline import sc as jsc
from tpu80211_torch import constants as C
from tpu80211_torch import convert
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import fused_chain as TF
from tpu80211_torch.ops import cfo
from tpu80211_torch.pipeline import sc

from _torch_inputs import (TOL, assert_matches, jax_planes, lane_major, make_frames, rel,
                           to_np, torch_planes, with_cfo)

EPS_20KHZ = 20e3 / 20e6  # cycles/sample at 20 MS/s (WiFi_RX.m:9)
# f32 on both sides: the tolerances of tests/test_fused_chain.py:53-61
CHAIN_TOL = {"h_lt": 1e-5, "h_linear": 1e-5, "h_cubic": 1e-5, "h_sinc": 1e-5,
             "h_spline": 1e-5, "h_wiener": 1e-5, "h_mmse": 1e-3, "eq": 1e-4}


@pytest.fixture(scope="module")
def impaired():
    """4 synthetic frames (the JAX generator) with a 20 kHz CFO, as
    complex64 numpy: fb, tx packet, rx packet, tx preamble, rx preamble."""
    fb = synthetic.generate(jax.random.PRNGKey(7), 4, snr_db=40.0)
    tx_pkt = synthetic.synthesize_time(fb.tx_symb)
    rx_pkt = synthetic.synthesize_time(fb.rx_symb)
    tx_lp = synthetic.synthesize_preamble_time(fb.tx_preamble_fft)
    rx_lp = synthetic.synthesize_preamble_time(fb.rx_preamble_fft)
    rx_lp = synthetic.apply_time_cfo(rx_lp, EPS_20KHZ, start=0)
    rx_pkt = synthetic.apply_time_cfo(rx_pkt, EPS_20KHZ, start=JC.PREAMBLE_SAMPLES)
    return (fb, *(np.asarray(x, np.complex64) for x in (tx_pkt, rx_pkt, tx_lp, rx_lp)))


def _t(x):
    return torch.tensor(x, dtype=torch.complex64)


def test_estimate_cfo_matches_jax(impaired):
    rx_lp = impaired[4]
    got = cfo.estimate_cfo(_t(rx_lp))
    want = np.asarray(jcfo.estimate_cfo(jax_planes(rx_lp)))
    # an f32 correlation of 64 products summed in another order: the angle
    # moves by ~1e-7 rad, eps by ~1e-7/(2π·64)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5)
    np.testing.assert_allclose(to_np(got), EPS_20KHZ, rtol=2e-2)  # tests/test_cfo.py:47


def test_correct_cfo_matches_jax(impaired):
    _, _, rx_pkt, _, rx_lp = impaired
    pkt, lp, eps = cfo.correct_cfo(_t(rx_pkt), _t(rx_lp))
    jpkt, jlp, jeps = jcfo.correct_cfo(jax_planes(rx_pkt), jax_planes(rx_lp))
    np.testing.assert_allclose(to_np(eps), np.asarray(jeps), rtol=1e-5)
    # f32 angles up to 2π·1e-3·1360 ≈ 8.5 rad, rounded to ~1e-6 rad
    assert rel(to_np(pkt), to_np(jpkt)) < 1e-5
    assert rel(to_np(lp), to_np(jlp)) < 1e-5
    # derotating with the estimate undoes the impairment (tests/test_cfo.py:60-68)
    clean = _t(rx_pkt).numpy() * np.exp(-2j * np.pi * EPS_20KHZ
                                        * (C.PREAMBLE_SAMPLES + np.arange(C.PACKET_SAMPLES)))
    assert np.abs(pkt.numpy() - clean).max() < 2e-3 * np.abs(clean).max() + 1e-6


def test_derotate_keeps_dtype_and_time_base(impaired):
    rx_lp = _t(impaired[4]).to(torch.complex128)
    eps = torch.full((rx_lp.shape[0],), EPS_20KHZ, dtype=torch.float64)
    got = cfo.derotate(rx_lp, eps, start=5)
    assert got.dtype == torch.complex128
    # the port keeps complex128: numpy's f64 rotation on the same time base
    t = 5 + np.arange(C.PREAMBLE_SAMPLES)
    assert rel(got.numpy(), rx_lp.numpy() * np.exp(-2j * np.pi * EPS_20KHZ * t)) < 1e-12
    # the JAX derotate computes in f32 whatever its input (tpu80211/ops/cfo.py:62-66)
    want = jcfo.derotate(JCplx.from_complex(rx_lp.numpy(), jnp.float64),
                         jnp.asarray(eps.numpy()), start=5)
    assert rel(got.numpy(), to_np(want)) < 1e-6


def test_cpe_correct_matches_jax(impaired):
    fb, tx_pkt, rx_pkt, tx_lp, rx_lp = impaired
    out = sc.rx_chain(_t(tx_pkt), _t(rx_pkt), _t(tx_lp), _t(rx_lp))
    tx_blocks = sc.extract_blocks(_t(tx_pkt))
    got = cfo.cpe_correct(out.eq, tx_blocks)
    want = jcfo.cpe_correct(jax_planes(out.eq.numpy()), jax_planes(tx_blocks.numpy()))
    assert rel(to_np(got), to_np(want)) < 1e-5  # f32 rotations
    # phase only: every block keeps its magnitudes
    np.testing.assert_allclose(got.abs().numpy(), out.eq.abs().numpy(), rtol=1e-5, atol=1e-7)
    # the |g| = 0 guard: a block of zeros stays zeros (no NaN)
    zero = cfo.cpe_correct(torch.zeros(2, C.N_BLOCKS, C.N_SC, dtype=torch.complex64), tx_blocks[:2])
    assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.parametrize("equalize_with", ["h_linear", "h_mmse"])
def test_rx_chain_sync_matches_jax(impaired, equalize_with):
    _, *frames = impaired
    got = sc.rx_chain(*(_t(x) for x in frames), equalize_with=equalize_with, sync=True)
    want = jsc.rx_chain(*(jax_planes(x) for x in frames), equalize_with=equalize_with, sync=True)
    # the generator's preambles carry no noise: σ² is f32 rounding residue
    # (~1e-16), so it is held to an absolute floor far below the signal
    np.testing.assert_allclose(to_np(got.ow2), to_np(want.ow2), rtol=1e-4, atol=1e-12)
    for name, tol in CHAIN_TOL.items():
        assert rel(to_np(getattr(got, name)), to_np(getattr(want, name))) < tol, name


def test_sync_chain_rescues_cfo_frames(impaired):
    """tests/test_cfo.py:71-89 on the port: the uncorrected chain's output is
    garbage, sync=True recovers it."""
    fb, *frames = impaired
    tx = np.asarray(fb.tx_symb)

    def med_err(out):
        return np.median(np.abs(out.eq.numpy() - tx)[..., C.DATA_MASK])

    args = [_t(x) for x in frames]
    raw = med_err(sc.rx_chain(*args, equalize_with="h_mmse"))
    fixed = med_err(sc.rx_chain(*args, equalize_with="h_mmse", sync=True))
    assert raw > 0.3 and fixed < 0.1 and fixed < raw / 5, (raw, fixed)


def test_sync_noop_on_clean_frames(impaired):
    fb = impaired[0]
    tx_pkt, tx_lp = _t(impaired[1]), _t(impaired[3])
    rx_pkt = _t(np.asarray(synthetic.synthesize_time(fb.rx_symb), np.complex64))
    rx_lp = _t(np.asarray(synthetic.synthesize_preamble_time(fb.rx_preamble_fft), np.complex64))
    tx = np.asarray(fb.tx_symb)

    def med_err(out):
        return np.median(np.abs(out.eq.numpy() - tx)[..., C.DATA_MASK])

    base = med_err(sc.rx_chain(tx_pkt, rx_pkt, tx_lp, rx_lp, equalize_with="h_mmse"))
    synced = med_err(sc.rx_chain(tx_pkt, rx_pkt, tx_lp, rx_lp, equalize_with="h_mmse", sync=True))
    assert synced < base * 1.1 + 1e-3, (base, synced)  # tests/test_cfo.py:108


# -- the fused chain's sync and evm_sums branches ---------------------------------

B = 6
SYNC_CASES = {
    "txconst-f32": ("txconst", jnp.float32, torch.float32),
    "txconst-bf16": ("txconst", jnp.bfloat16, torch.bfloat16),
    "per-frame-f32": ("lane", jnp.float32, torch.float32),
    "per-frame-bf16": ("lane", jnp.bfloat16, torch.bfloat16),
}


@pytest.fixture(scope="module")
def cfo_frames():
    """Per-frame-tx and tx-constant frames with a 20 kHz CFO, batch-major."""
    return (with_cfo(make_frames(seed=12, b=B), EPS_20KHZ),
            with_cfo(make_frames(seed=13, b=B, tx_const=True), EPS_20KHZ))


def _spectra(const_frames):
    tx_pkt, _, tx_lp, _ = const_frames
    txs, tpre = JF.tx_spectra(jax_planes(tx_pkt[0]), jax_planes(tx_lp[0]))
    return (txs, tpre), convert.tx_spectra(*(np.asarray(a) for a in (txs.re, txs.im,
                                                                      tpre.re, tpre.im)),
                                                 device="cpu")


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_fused_sync_matches_jax_kernel(case, cfo_frames):
    """The plain chain with sync=True against the JAX kernel (interpret
    mode), tx-constant and per-frame tx: the per-frame CPE reads the tx
    spectra of all 15 blocks."""
    mode, jdt, tdt = SYNC_CASES[case]
    tx_pkt, rx_pkt, tx_lp, rx_lp = cfo_frames[mode == "txconst"]
    jlane = lambda x: jax_planes(lane_major(x, JF.LANES), jdt)  # noqa: E731
    tlane = lambda x: torch_planes(lane_major(x), tdt)  # noqa: E731
    if mode == "txconst":
        (jtxs, jtpre), ttx = _spectra(cfo_frames[1])
        want = JF.fused_rx_chain_txconst(jtxs, jtpre, jlane(rx_pkt), jlane(rx_lp), sync=True)
        got = TF.fused_rx_chain_txconst(*ttx, tlane(rx_pkt), tlane(rx_lp), sync=True)
    else:
        want = JF.fused_rx_chain_lane_major(jlane(tx_pkt), jlane(rx_pkt), jlane(tx_lp),
                                            jlane(rx_lp), sync=True)
        got = TF.fused_rx_chain_lane_major(tlane(tx_pkt), tlane(rx_pkt), tlane(tx_lp),
                                           tlane(rx_lp), sync=True)
    dtype = "f32" if tdt == torch.float32 else "bf16"
    assert_matches(got, want, B, TOL[dtype])
    # the estimate: JAX's atan2 is a polynomial with ≤ 2e-7 rad of error,
    # i.e. ≤ 5e-10 in eps; the f32 correlation order adds less than that
    np.testing.assert_allclose(to_np(got["cfo"]), to_np(want["cfo"])[:B], rtol=0, atol=1e-8)
    np.testing.assert_allclose(to_np(got["cfo"]), EPS_20KHZ, rtol=2e-2)


def test_fused_sync_matches_sc(cfo_frames):
    """tests/test_fused_chain.py:332-353 on the port: the batch-major fused
    entry with sync equals the complex chain with sync."""
    frames = cfo_frames[0]
    got = TF.fused_rx_chain(*(torch_planes(x) for x in frames), sync=True)
    want = sc.rx_chain(*(_t(x) for x in frames), sync=True)
    # 40 dB AWGN and an 8-tap channel on the LTS: the estimate lands within
    # the 2% of tests/test_cfo.py:47
    np.testing.assert_allclose(to_np(got["cfo"]), EPS_20KHZ, rtol=2e-2)
    for name, tol in (("h_lt", 1e-4), ("h_linear", 1e-4), ("h_mmse", 1e-3), ("eq", 1e-3)):
        assert rel(to_np(got[name]), to_np(getattr(want, name))) < tol, name


@pytest.mark.parametrize("mode,sync", [("txconst", False), ("txconst", True), ("lane", True)])
def test_evm_sums_equal_sum_over_eq(cfo_frames, mode, sync):
    """evm_sums is Σ_b Σ_k |eq − tx|² from the chain's own float32 eq, after
    CPE; it changes no other output."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = cfo_frames[mode == "txconst"]
    lane = lambda x: torch_planes(lane_major(x))  # noqa: E731
    consts = TF.chain_consts("cpu")
    if mode == "txconst":
        tx = _spectra(cfo_frames[1])[1]
        tx_blocks = tx.txs.re[:, :C.N_BLOCKS].T[:, :, None] + 1j * tx.txs.im[:, :C.N_BLOCKS].T[:, :, None]
    else:
        tx = TF.TxFrames(lane(tx_pkt), lane(tx_lp))
        tx_blocks = sc.extract_blocks(_t(tx_pkt)).permute(1, 2, 0)
    out = TF.fused_chain(lane(rx_pkt), lane(rx_lp), tx, consts, sync=sync, evm_sums=True)
    base = TF.fused_chain(lane(rx_pkt), lane(rx_lp), tx, consts, sync=sync)
    want = (out["eq"].to_complex(torch.complex128) - tx_blocks.to(torch.complex128)).abs().square()
    # 795 f32 terms per frame, summed in another order; per-frame tx, the
    # reference's tx spectra come from another DFT call (f32 rounding of
    # tx ~1e-7, against residuals |eq − tx| ~1e-2 of |tx|)
    np.testing.assert_allclose(out["evm_sums"].numpy(), want.sum((0, 1)).numpy(),
                               rtol=1e-5 if mode == "txconst" else 1e-4)
    for k in (*TF.OUT_NAMES, "eq", "ow2", "cfo", "checksum"):
        for a, b in zip(*(v if isinstance(v, Cplx) else (v,) for v in (out[k], base[k]))):
            assert torch.equal(a, b), k
