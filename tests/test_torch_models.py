"""The port's estimators (tpu80211_torch.models), complex-dtype chain
(pipeline/rx.py), ops under the JAX package's names, Config and
sc.ps_mmse_dense, against tpu80211, its 80-bit oracle and the reference's
golden vectors, on the CPU.

Tolerances.  At complex128 both packages compute the same closed forms in
another rounding order: 1e-12.  Three places need more, each for a stated
reason:
* "dense" solves a 53×53 system of condition ~1e7 on the capture (σ² ≈
  1e-7) with two LAPACKs: 1e-9, the JAX package's own tolerance between
  its "sm" and "dense" solvers (tests/test_estimators.py:101-115);
* "dense_pallas" solves in f32: 1e-4 on well-conditioned frames (σ² =
  0.37), and on the capture the JAX package's 5e-2 against "sm"
  (tests/test_kernels.py:232-235, 251-252);
* MATLAB mode divides by σ² (..._PS_MMSE.m:30), which magnifies the
  1e-16 difference of the two packages' LT-LS in rx_chain: 1e-8, the JAX
  package's tolerance against its oracle (tests/test_estimators.py:84-98).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211 import config as jconfig
from tpu80211 import models as jm
from tpu80211 import ops as jops
from tpu80211.config import EstimatorMode as JMode
from tpu80211.ops import linalg as jlinalg
from tpu80211.parity import oracle_np as oracle
from tpu80211.pipeline import rx as jrx
from tpu80211.pipeline import sc as jsc
from tpu80211_torch import config, models
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.ops import blocks, equalize, linalg
from tpu80211_torch.pipeline import rx, sc

from _torch_inputs import jax_planes, make_frames, rel, to_np

MODES = list(EstimatorMode)
KINDS = ["linear", "cubic", "sinc", "spline", "wiener"]
SOLVERS = ["sm", "dense", "dense_pallas"]
GOLDEN = pathlib.Path(__file__).parent / "golden" / "ref_h_est.npz"


def _t(x, dtype=torch.complex128) -> torch.Tensor:
    return torch.tensor(np.asarray(x)).to(dtype)


def _jmode(mode: EstimatorMode) -> JMode:
    return JMode(mode.value)


@pytest.fixture(scope="module")
def well_conditioned():
    """6 frames in frequency: tx, rx blocks (6, 15, 53) and h_lt (6, 53)
    with normal entries, σ² = 0.37 per frame (bench.py's systems), so
    Ryy = σ²I + u·uᴴ has a condition number of a few hundred."""
    rng = np.random.default_rng(41)

    def c(*s):
        return rng.standard_normal(s) + 1j * rng.standard_normal(s)

    return c(6, 15, 53), c(6, 15, 53), np.full(6, 0.37), 0.5 * c(6, 53)


# -- Config, ops ----------------------------------------------------------------------------------


def test_config_matches_jax():
    """Same fields (the mesh shape included), defaults and estimator names:
    one configuration means the same in both packages."""
    got = {f.name: f.default for f in dataclasses.fields(config.Config)}
    want = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    assert list(got) == list(want)
    assert config.Config().mesh_shape() == jconfig.Config().mesh_shape() == {"dp": 1, "blk": 1}
    for name, value in want.items():
        g = got[name]
        assert (g.value if isinstance(g, EstimatorMode) else g) == \
            (value.value if isinstance(value, JMode) else value), name
    assert config.ESTIMATOR_NAMES == jconfig.ESTIMATOR_NAMES
    assert [m.value for m in EstimatorMode] == [m.value for m in JMode]


@pytest.mark.parametrize("fn", ["dft_matrix", "idft_apply", "hermitian_quirk", "addition_quirk"])
def test_linalg_matches_jax(fn):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((3, 53, 53)) + 1j * rng.standard_normal((3, 53, 53))
    if fn == "dft_matrix":
        np.testing.assert_array_equal(linalg.dft_matrix(), jlinalg.dft_matrix())
        np.testing.assert_array_equal(linalg.dft_matrix(64), jlinalg.dft_matrix(64))
        return
    if fn == "idft_apply":
        got, want = linalg.idft_apply(_t(m[0])), jlinalg.idft_apply(jnp.asarray(m[0]))
    elif fn == "hermitian_quirk":
        got, want = linalg.hermitian_quirk(_t(m)), jlinalg.hermitian_quirk(jnp.asarray(m))
    else:
        got = linalg.addition_quirk(_t(m[0]), _t(m[1]))
        want = jlinalg.addition_quirk(jnp.asarray(m[0]), jnp.asarray(m[1]))
    assert got.dtype == torch.complex128
    assert rel(got.numpy(), np.asarray(want)) < 1e-12


@pytest.mark.parametrize("fn", ["extract_blocks", "preamble_fft", "noise_power_estimate",
                                "equalize"])
def test_ops_match_jax(fn, capture):
    """The JAX package's ops names on the capture at complex128 (the port's
    block DFT is a product with a (64, 53) matrix, the JAX one an FFT)."""
    if fn == "extract_blocks":
        got = blocks.extract_blocks(_t(capture.rx_packet))
        want = jops.extract_blocks(jnp.asarray(capture.rx_packet))
    elif fn == "preamble_fft":
        got = blocks.preamble_fft(_t(capture.rx_lptot))
        want = jops.preamble_fft(jnp.asarray(capture.rx_lptot))
    elif fn == "noise_power_estimate":
        got = blocks.noise_power_estimate(_t(capture.rx_lptot))
        want = jops.noise_power_estimate(jnp.asarray(capture.rx_lptot))
        assert got.dtype == torch.float64
    else:
        h_lt = jm.lt_ls(jnp.asarray(capture.tx_preamble_fft), jnp.asarray(capture.rx_preamble_fft))
        h_ps = jm.ps_interp(jnp.asarray(capture.tx_symb), jnp.asarray(capture.rx_symb), "linear")
        got = equalize(_t(capture.rx_symb), _t(h_lt), _t(h_ps))
        want = jops.equalize(jnp.asarray(capture.rx_symb), h_lt, h_ps)
    assert rel(to_np(got), np.asarray(want)) < 1e-12


# -- estimators -----------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_lt_ls_matches_jax(mode, capture):
    got = models.lt_ls(_t(capture.tx_preamble_fft), _t(capture.rx_preamble_fft), mode)
    want = jm.lt_ls(jnp.asarray(capture.tx_preamble_fft), jnp.asarray(capture.rx_preamble_fft),
                    mode=_jmode(mode))
    assert rel(got.numpy(), np.asarray(want)) < 1e-12
    assert got[26] == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_ps_interp_matches_jax(kind, mode, capture):
    got = models.ps_interp(_t(capture.tx_symb), _t(capture.rx_symb), kind, mode)
    want = jm.ps_interp(jnp.asarray(capture.tx_symb), jnp.asarray(capture.rx_symb), kind,
                        mode=_jmode(mode))
    assert rel(got.numpy(), np.asarray(want)) < 1e-12


def test_per_block_estimates_and_registry_match_jax(capture):
    tx, rx_ = capture.tx_symb[:3], capture.rx_symb[:3]
    assert rel(models.pilot_ratios(_t(tx), _t(rx_)).numpy(),
               np.asarray(jm.pilot_ratios(jnp.asarray(tx), jnp.asarray(rx_)))) < 1e-12
    for kind in KINDS:
        got = models.ps_interp_per_block(_t(tx), _t(rx_), kind)
        assert rel(got.numpy(), np.asarray(jm.ps_interp_per_block(
            jnp.asarray(tx), jnp.asarray(rx_), kind))) < 1e-12
    assert models.PS_ESTIMATORS.keys() == jm.PS_ESTIMATORS.keys()
    for name, fn in models.PS_ESTIMATORS.items():
        want = jm.PS_ESTIMATORS[name](jnp.asarray(capture.tx_symb), jnp.asarray(capture.rx_symb))
        assert rel(fn(_t(capture.tx_symb), _t(capture.rx_symb)).numpy(), np.asarray(want)) < 1e-12


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("mode", MODES)
def test_ps_mmse_matches_jax_on_the_capture(mode, solver, capture):
    """Both packages from the same h_lt (the JAX one's), at complex128."""
    h_lt = jm.lt_ls(jnp.asarray(capture.tx_preamble_fft), jnp.asarray(capture.rx_preamble_fft),
                    mode=_jmode(mode))
    jargs = (jnp.asarray(capture.tx_symb), jnp.asarray(capture.rx_symb), capture.ow2, h_lt)
    got = models.ps_mmse(_t(capture.tx_symb), _t(capture.rx_symb), capture.ow2, _t(h_lt),
                         mode=mode, solver=solver)
    want = jm.ps_mmse(*jargs, mode=_jmode(mode), solver=solver)
    assert got.dtype == torch.complex128 and tuple(got.shape) == (53,)
    if mode == EstimatorMode.C_PARITY or solver == "sm":   # no solve
        assert rel(got.numpy(), np.asarray(want)) < 1e-12
    elif solver == "dense":
        assert rel(got.numpy(), np.asarray(want)) < 1e-9
    else:  # f32 on a system of condition ~1e7
        assert rel(got.numpy(), np.asarray(jm.ps_mmse(*jargs, mode=_jmode(mode)))) < 5e-2
        assert rel(got.numpy(), np.asarray(want)) < 5e-2


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("mode", [EstimatorMode.MATH, EstimatorMode.MATLAB])
def test_ps_mmse_matches_jax_well_conditioned(mode, solver, dtype, well_conditioned):
    """Per-frame σ² (6,), frames batched; the result keeps the input dtype.
    complex128: 1e-12 (sm, dense), 1e-4 (dense_pallas solves in f32);
    complex64: 1e-4, f32 eliminations in another order (2e-5 measured)."""
    tx, rx_, ow2, h = well_conditioned
    jdt = jnp.complex128 if dtype == torch.complex128 else jnp.complex64
    got = models.ps_mmse(_t(tx, dtype), _t(rx_, dtype), torch.tensor(ow2), _t(h, dtype),
                         mode=mode, solver=solver)
    want = jm.ps_mmse(jnp.asarray(tx, jdt), jnp.asarray(rx_, jdt), jnp.asarray(ow2),
                      jnp.asarray(h, jdt), mode=_jmode(mode), solver=solver)
    assert got.dtype == dtype and tuple(got.shape) == (6, 53)
    exact = dtype == torch.complex128 and solver != "dense_pallas"
    assert rel(to_np(got), np.asarray(want)) < (1e-12 if exact else 1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_ps_mmse_matches_oracle(mode, capture):
    """The rank-1 closed form against the oracle's explicit 80-bit inverse
    (tests/test_estimators.py:84-98)."""
    h_lt = oracle.lt_ls_oracle(capture.tx_preamble_fft, capture.rx_preamble_fft, _jmode(mode))
    want = oracle.ps_mmse_oracle(capture.tx_symb, capture.rx_symb, capture.ow2, h_lt, _jmode(mode))
    got = models.ps_mmse(_t(capture.tx_symb), _t(capture.rx_symb), capture.ow2,
                         _t(np.asarray(h_lt, np.complex128)), mode=mode)
    assert rel(got.numpy(), np.asarray(want, np.complex128)) < 1e-8


@pytest.mark.parametrize("block", [0, 7, 14])
@pytest.mark.parametrize("est", ["lt_ls", "ps_linear", "ps_cubic", "ps_sinc", "ps_mmse"])
def test_c_parity_matches_golden(est, block, capture):
    """C_PARITY against the compiled reference's own output
    (tests/test_golden_ref.py: 1e-12 for LT-LS, 1e-11 for the
    interpolators, f64 against 80-bit).  The reference's MMSE is all-NaN
    (its addition bug leaves a zero pivot); the port's is finite and
    equals the pivoting oracle's instead."""
    golden = np.load(GOLDEN)
    want = golden[f"block{block}_{est}"]
    tx, rx_ = _t(capture.tx_symb[block:block + 1]), _t(capture.rx_symb[block:block + 1])
    mode = EstimatorMode.C_PARITY
    if est == "lt_ls":
        got = models.lt_ls(_t(capture.tx_preamble_fft), _t(capture.rx_preamble_fft), mode)
        assert rel(got.numpy(), want) < 1e-12
    elif est == "ps_mmse":
        assert np.isnan(want).all()
        h_lt = models.lt_ls(_t(capture.tx_preamble_fft), _t(capture.rx_preamble_fft), mode)
        got = models.ps_mmse(tx, rx_, capture.ow2, h_lt, mode=mode)
        oracle_h = oracle.ps_mmse_oracle(capture.tx_symb[block:block + 1],
                                         capture.rx_symb[block:block + 1], capture.ow2,
                                         h_lt.numpy(), JMode.C_PARITY)
        assert np.isfinite(got.numpy()).all()
        assert rel(got.numpy(), np.asarray(oracle_h, np.complex128)) < 1e-8
    else:
        got = models.ps_interp(tx, rx_, est[3:], mode)
        assert rel(got.numpy(), want) < 1e-11


# -- the complex-dtype chain and sc.ps_mmse_dense -------------------------------------------------


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_rx_chain_matches_jax(dtype, solver):
    """rx_chain on 5 frames with their own tx.  complex128: 1e-12, eq 1e-11
    (the blend divides by the CFR); complex64: the f32 pipeline's 1e-5, eq
    1e-4 (tests/test_fused_chain.py:53-61).  h_mmse by solver, as the
    module docstring says; the f32 "dense" is LAPACK's f32 solve at
    condition ~1e5 (SNR 40 dB), so 5e-2 as dense_pallas."""
    frames = make_frames(seed=11, b=5)
    jdt = jnp.complex128 if dtype == torch.complex128 else jnp.complex64
    got = rx.rx_chain(*(_t(x, dtype) for x in frames), mmse_solver=solver)
    want = jrx.rx_chain(*(jnp.asarray(x, jdt) for x in frames), mmse_solver=solver)
    c128 = dtype == torch.complex128
    mmse_tol = {"sm": 1e-12 if c128 else 1e-3, "dense": 1e-9 if c128 else 5e-2,
                "dense_pallas": 5e-2}[solver]
    for name in got._fields:
        g = getattr(got, name)
        assert g.dtype == (dtype if name != "ow2" else (torch.float64 if c128 else torch.float32))
        tol = mmse_tol if name == "h_mmse" else (1e-12 if c128 else 1e-5)
        if name == "eq":
            tol = 1e-11 if c128 else 1e-4
        assert rel(to_np(g), np.asarray(getattr(want, name))) < tol, name


@pytest.mark.parametrize("mode", MODES)
def test_rx_chain_freq_modes_match_jax(mode, capture):
    """The frequency-domain entry on the capture at complex128, each mode,
    equalized with h_mmse so the blend carries the mode's MMSE."""
    args = (capture.tx_preamble_fft, capture.rx_preamble_fft, capture.tx_symb, capture.rx_symb)
    got = rx.rx_chain_freq(*(_t(a) for a in args), capture.ow2, mode=mode,
                           equalize_with="h_mmse")
    want = jrx.rx_chain_freq(*(jnp.asarray(a) for a in args), capture.ow2, mode=_jmode(mode),
                             equalize_with="h_mmse")
    for name in got._fields:
        tol = 1e-8 if mode == EstimatorMode.MATLAB and name in ("h_mmse", "eq") else 1e-12
        assert rel(to_np(getattr(got, name)), np.asarray(getattr(want, name))) < tol, name


def test_sc_ps_mmse_dense_matches_jax(well_conditioned, capture):
    """sc.ps_mmse_dense (the fused solve) against the JAX one on
    well-conditioned frames (both f32: 1e-4), and on the capture against
    sc.ps_mmse_sm at the JAX package's 5e-2 (tests/test_kernels.py:238-252)."""
    tx, rx_, ow2, h = well_conditioned
    got = sc.ps_mmse_dense(_t(tx, torch.complex64), _t(rx_, torch.complex64),
                           torch.tensor(ow2, dtype=torch.float32), _t(h, torch.complex64))
    want = jsc.ps_mmse_dense(jax_planes(tx), jax_planes(rx_), jnp.asarray(ow2, jnp.float32),
                             jax_planes(h))
    assert got.dtype == torch.complex64 and tuple(got.shape) == (6, 53)
    assert rel(to_np(got), to_np(want)) < 1e-4
    tx, rx_ = _t(capture.tx_symb, torch.complex64), _t(capture.rx_symb, torch.complex64)
    h_lt = sc.lt_ls(_t(capture.tx_preamble_fft, torch.complex64),
                    _t(capture.rx_preamble_fft, torch.complex64))
    ow2 = torch.tensor(capture.ow2, dtype=torch.float32)
    dense = sc.ps_mmse_dense(tx, rx_, ow2, h_lt)
    assert rel(to_np(dense), to_np(sc.ps_mmse_sm(tx, rx_, ow2, h_lt))) < 5e-2
    jdense = jsc.ps_mmse_dense(jax_planes(capture.tx_symb), jax_planes(capture.rx_symb),
                               jnp.asarray(capture.ow2, jnp.float32) * jnp.ones(()),
                               jax_planes(h_lt.numpy()))
    assert rel(to_np(dense), to_np(jdense)) < 5e-2
