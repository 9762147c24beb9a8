"""The port's parity oracles (``tpu80211_torch/parity``) against the JAX
package's, on the CPU.

Both packages keep a copy of the 80-bit numpy oracle and of the bindings to
the native x87 oracle (``native/build/liboracle80211.so``).  The copies
must compute the same numbers, so every function is held to its
counterpart bit for bit (``np.array_equal``, NaN equal to NaN), in every
mode, on the shipped capture and on seeded random frames; and both agree
with the reference binary's golden vectors (``tests/golden/ref_h_est.npz``)
at the bounds ``tests/test_golden_ref.py`` sets for the JAX copies.
"""

import pathlib

import numpy as np
import pytest

from tpu80211.config import EstimatorMode as JMode
from tpu80211.parity import oracle_native as jnat
from tpu80211.parity import oracle_np as joracle
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.parity import oracle_native as nat
from tpu80211_torch.parity import oracle_np as oracle

MODES = list(EstimatorMode)
KINDS = ["linear", "cubic", "sinc", "spline"]
GOLDEN = pathlib.Path(__file__).parent / "golden" / "ref_h_est.npz"


def _jm(mode: EstimatorMode) -> JMode:
    return JMode(mode.value)


def _same(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    assert np.array_equal(got, want, equal_nan=True)


def _rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _frames(seed: int) -> dict:
    """A random frame in frequency: tx/rx preamble (53,), blocks (15, 53)
    with normal entries, σ² = 0.37."""
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    return {"tx_pre": c(53), "rx_pre": c(53), "tx": c(15, 53), "rx": c(15, 53), "ow2": 0.37}


@pytest.fixture(scope="module", params=["capture", "seed3", "seed4"])
def frame(request):
    if request.param == "capture":
        cap = load_capture()
        return {"tx_pre": cap.tx_preamble_fft, "rx_pre": cap.rx_preamble_fft,
                "tx": cap.tx_symb, "rx": cap.rx_symb, "ow2": cap.ow2}
    return _frames(int(request.param[4:]))


# -- oracle_np ---------------------------------------------------------------------------


def test_oracle_np_constants_and_matrices():
    assert (oracle.LD, oracle.CLD) == (joracle.LD, joracle.CLD)
    assert (oracle.P0, oracle.P1, oracle.P2, oracle.P3) == (joracle.P0, joracle.P1,
                                                            joracle.P2, joracle.P3)
    _same(oracle.DELTA, joracle.DELTA)
    _same(oracle.dft_matrix_ld(), joracle.dft_matrix_ld())
    _same(oracle.dft_matrix_ld(8), joracle.dft_matrix_ld(8))
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 7)) + 1j * rng.standard_normal((7, 7))
    _same(oracle.inv_gauss_ld(a), joracle.inv_gauss_ld(a))
    x = (rng.standard_normal(53) + 1j * rng.standard_normal(53)).astype(oracle.CLD)
    _same(oracle.ifft_ld(x), joracle.ifft_ld(x))


@pytest.mark.parametrize("mode", MODES)
def test_oracle_np_lt_ls_and_blocks_bit_equal(frame, mode):
    _same(oracle.lt_ls_oracle(frame["tx_pre"], frame["rx_pre"], mode),
          joracle.lt_ls_oracle(frame["tx_pre"], frame["rx_pre"], _jm(mode)))
    tx, rx = (np.asarray(frame[k][2], oracle.CLD) for k in ("tx", "rx"))
    _same(oracle.ps_linear_block(tx, rx), joracle.ps_linear_block(tx, rx))
    _same(oracle.ps_cubic_block(tx, rx, mode), joracle.ps_cubic_block(tx, rx, _jm(mode)))
    _same(oracle.ps_sinc_block(tx, rx), joracle.ps_sinc_block(tx, rx))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_oracle_np_ps_interp_bit_equal(frame, mode, kind):
    _same(oracle.ps_interp_oracle(frame["tx"], frame["rx"], kind, mode),
          joracle.ps_interp_oracle(frame["tx"], frame["rx"], kind, _jm(mode)))


@pytest.mark.parametrize("mode", MODES)
def test_oracle_np_ps_mmse_and_equalize_bit_equal(frame, mode):
    h_lt = oracle.lt_ls_oracle(frame["tx_pre"], frame["rx_pre"], mode)
    _same(oracle.ps_mmse_oracle(frame["tx"], frame["rx"], frame["ow2"], h_lt, mode),
          joracle.ps_mmse_oracle(frame["tx"], frame["rx"], frame["ow2"], h_lt, _jm(mode)))
    h_ps = oracle.ps_interp_oracle(frame["tx"], frame["rx"], "linear", mode)
    _same(oracle.equalize_oracle(frame["rx"], h_lt, h_ps),
          joracle.equalize_oracle(frame["rx"], h_lt, h_ps))


# -- oracle_native -------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_oracle_native_estimators_bit_equal(frame, mode):
    h_lt = nat.lt_ls(frame["tx_pre"], frame["rx_pre"], mode)
    _same(h_lt, jnat.lt_ls(frame["tx_pre"], frame["rx_pre"], _jm(mode)))
    for kind in KINDS:
        _same(nat.ps_interp(frame["tx"], frame["rx"], kind, mode),
              jnat.ps_interp(frame["tx"], frame["rx"], kind, _jm(mode)))
    _same(nat.ps_mmse(frame["tx"], frame["rx"], frame["ow2"], h_lt, mode),
          jnat.ps_mmse(frame["tx"], frame["rx"], frame["ow2"], h_lt, _jm(mode)))
    h_ps = nat.ps_interp(frame["tx"], frame["rx"], "linear", mode)
    _same(nat.equalize(frame["rx"], h_lt, h_ps), jnat.equalize(frame["rx"], h_lt, h_ps))


def test_oracle_native_cofactor_mmse_bit_equal():
    """The reference-shaped cofactor inverse inside the MMSE block solve,
    in C-parity mode (Ryy = 2σ²I, so the inverse is cheap)."""
    f = _frames(5)
    mode = EstimatorMode.C_PARITY
    h_lt = nat.lt_ls(f["tx_pre"], f["rx_pre"], mode)
    _same(nat.ps_mmse(f["tx"], f["rx"], f["ow2"], h_lt, mode, use_cofactor=True),
          jnat.ps_mmse(f["tx"], f["rx"], f["ow2"], h_lt, _jm(mode), use_cofactor=True))


@pytest.mark.parametrize("n,cofactor", [(6, True), (10, True), (10, False), (53, False)])
def test_oracle_native_inverse_bit_equal(n, cofactor):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) + n * np.eye(n)
    got = nat.inverse(a, use_cofactor=cofactor)
    _same(got, jnat.inverse(a, use_cofactor=cofactor))
    assert np.abs(got @ a - np.eye(n)).max() < 1e-10


@pytest.mark.parametrize("method,n", [("condensation", 8), ("condensation", 53),
                                      ("elimination", 8), ("elimination", 53),
                                      ("laplace", 6), ("laplace", 10)])
def test_oracle_native_determinant_bit_equal(method, n):
    rng = np.random.default_rng(100 + n)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) + 8 * np.eye(n)
    got = nat.determinant(a, method)
    assert got == jnat.determinant(a, method)
    want = np.linalg.det(a)
    assert abs(got - want) / abs(want) < 1e-9, (method, got, want)


# -- the reference binary's golden vectors ---------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_oracles_match_the_golden_lt_ls(golden):
    cap = load_capture()
    want = golden["block0_lt_ls"]
    mode = EstimatorMode.C_PARITY
    assert _rel(oracle.lt_ls_oracle(cap.tx_preamble_fft, cap.rx_preamble_fft, mode), want) < 1e-15
    assert _rel(nat.lt_ls(cap.tx_preamble_fft, cap.rx_preamble_fft, mode), want) < 1e-15


@pytest.mark.parametrize("block", [0, 1, 3, 7, 11, 14])
@pytest.mark.parametrize("kind,est", [("linear", "ps_linear"), ("cubic", "ps_cubic"),
                                      ("sinc", "ps_sinc")])
def test_oracles_match_the_golden_ps_interp(golden, block, kind, est):
    """C-parity takes block 0: the numpy oracle is given block ``block``
    alone (tests/test_golden_ref.py:91-112), the native one all 15 blocks
    rolled so that it comes first."""
    cap = load_capture()
    want = golden[f"block{block}_{est}"]
    mode = EstimatorMode.C_PARITY
    got = oracle.ps_interp_oracle(cap.tx_symb[block:block + 1], cap.rx_symb[block:block + 1],
                                  kind, mode)
    assert _rel(got, want) < 1e-14
    got = nat.ps_interp(np.roll(cap.tx_symb, -block, axis=0), np.roll(cap.rx_symb, -block, axis=0),
                        kind, mode)
    assert _rel(got, want) < 1e-14


def test_native_libraries_build_alone_under_a_lock(tmp_path, monkeypatch):
    """A missing library is built by ``make`` for its own target only (the
    JAX bindings run every target, with no lock), once, holding a lock;
    one that is there is used as it is.  Both bindings use the same
    shared library as the JAX package's."""
    import subprocess

    from tpu80211_torch.datasets import native_engine

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        (tmp_path / "build" / cmd[-1].split("/")[-1]).write_bytes(b"")

    monkeypatch.setattr(native_engine, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(subprocess, "run", fake_run)
    so = native_engine.build_library("liboracle80211.so")
    assert so == tmp_path / "build" / "liboracle80211.so" and so.exists()
    assert calls == [["make", "-C", str(tmp_path), "build/liboracle80211.so"]]
    assert (tmp_path / "build" / ".build.lock").exists()
    assert native_engine.build_library("liboracle80211.so") == so and len(calls) == 1
    assert nat._SO == jnat._SO
    assert pathlib.Path(nat._lib()._name) == nat._SO
