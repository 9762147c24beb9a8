"""The port's utilities (``tpu80211_torch/utils``) against the JAX package's:
metrics on the same numpy inputs, the numeric guards, and the timing
harness's records and cost models."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.cplx import Cplx as JCplx
from tpu80211.utils import metrics as JM
from tpu80211.utils import timing as JT
from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.utils import checks, metrics, timing


def _symbols(seed: int, m: int, b: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """tx: square m-QAM symbols on every bin (b, 15, 53); eq: tx plus noise
    at 0.4 of half the level spacing, so some decisions flip."""
    rng = np.random.default_rng(seed)
    lv = JM.pam_levels(m) if m > 4 else np.array([-1.0, 1.0]) / np.sqrt(2)
    shape = (b, C.N_BLOCKS, C.N_SC)
    tx = lv[rng.integers(0, lv.size, shape)] + 1j * lv[rng.integers(0, lv.size, shape)]
    sigma = 0.2 * (lv[1] - lv[0])
    eq = tx + sigma * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return eq.astype(np.complex64), tx.astype(np.complex64)


def _channels(seed: int, b: int = 64) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((b, C.N_SC)) + 1j * rng.standard_normal((b, C.N_SC))) / np.sqrt(2)
    est = h + 0.1 * (rng.standard_normal(h.shape) + 1j * rng.standard_normal(h.shape))
    return est.astype(np.complex64), h.astype(np.complex64)


# -- metrics: the same numbers as tpu80211.utils.metrics (within 1e-6; BER exactly) --


@pytest.mark.parametrize("as_input", ["numpy", "tensor", "cplx"])
def test_cfr_metrics_match_jax(as_input):
    est, h = _channels(3)
    conv = {"numpy": lambda x: x, "tensor": torch.from_numpy,
            "cplx": lambda x: Cplx.from_complex(torch.from_numpy(x))}[as_input]
    for exclude_dc in (True, False):
        assert metrics.cfr_mse(conv(est), conv(h), exclude_dc) == pytest.approx(
            JM.cfr_mse(est, h, exclude_dc), rel=1e-6, abs=0)
    assert metrics.cfr_nmse_db(conv(est), conv(h)) == pytest.approx(
        JM.cfr_nmse_db(est, h), rel=1e-6, abs=0)


def test_metrics_take_jax_split_planes_as_port_planes():
    """A JAX Cplx and the port's Cplx of the same planes give one number."""
    est, h = _channels(4)
    want = JM.cfr_nmse_db(JCplx(jnp.asarray(est.real), jnp.asarray(est.imag)), h)
    got = metrics.cfr_nmse_db(Cplx(torch.from_numpy(est.real.copy()),
                                   torch.from_numpy(est.imag.copy())), h)
    assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("m", [4, 16, 64])
def test_evm_and_ber_match_jax(m):
    eq, tx = _symbols(m, m)
    assert metrics.evm_rms(torch.from_numpy(eq), tx) == pytest.approx(
        JM.evm_rms(eq, tx), rel=1e-6, abs=0)
    ber = metrics.qam_ber(torch.from_numpy(eq), torch.from_numpy(tx), m)
    assert ber == JM.qam_ber(eq, tx, m)  # counts of bits: exactly equal
    assert 0.0 < ber < 0.5
    if m == 4:
        assert metrics.qpsk_ber(eq, tx) == JM.qpsk_ber(eq, tx)


@pytest.mark.parametrize("m", [4, 16, 64])
def test_pam_levels_one_copy(m):
    """One ``pam_levels``: the generator's is the metrics' own, and both
    equal the JAX package's."""
    from tpu80211_torch.datasets import synthetic

    assert synthetic.pam_levels is metrics.pam_levels
    np.testing.assert_array_equal(metrics.pam_levels(m), JM.pam_levels(m))


def test_pam_levels_rejects_non_square():
    with pytest.raises(ValueError, match="4, 16 or 64"):
        metrics.pam_levels(32)


# -- checks: NaN and Inf raise --------------------------------------------------------


def _bad(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x.view(-1)[3] = float("nan")
    return x


@pytest.mark.parametrize("kind", ["tensor", "cplx", "dict", "namedtuple", "complex", "inf"])
def test_assert_finite_raises_on_nan(kind):
    good = torch.ones(4, 5)
    tree = {
        "tensor": _bad(good),
        "cplx": Cplx(good, _bad(good)),
        "dict": {"a": good, "b": [good, {"c": _bad(good)}], "n": None},
        "namedtuple": C_out(good, Cplx(good, _bad(good))),
        "complex": _bad(torch.ones(4, 5, dtype=torch.complex64)),
        "inf": good.clone().fill_(float("inf")),
    }[kind]
    with pytest.raises(FloatingPointError, match="non-finite"):
        checks.assert_finite(tree, "x")


def test_assert_finite_passes_finite_and_integer_trees():
    checks.assert_finite({"a": torch.ones(3), "b": Cplx(torch.zeros(2), torch.zeros(2)),
                          "i": torch.arange(4), "none": None})


class C_out(tuple):
    """A named tuple of outputs, as the chain returns."""

    _fields = ("h", "eq")

    def __new__(cls, h, eq):
        return super().__new__(cls, (h, eq))


def test_checked_wraps_and_raises_after_the_call():
    from tpu80211_torch.pipeline import sc

    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2, "z": Cplx(x, x / x)}

    wrapped = checks.checked(fn)
    assert wrapped.__name__ == "fn"
    out = wrapped(torch.ones(3))
    assert torch.equal(out["y"], torch.full((3,), 2.0))
    with pytest.raises(FloatingPointError, match="fn"):
        wrapped(torch.zeros(3))  # 0/0
    assert len(calls) == 2
    # a real pipeline function passes through untouched on finite frames
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((2, 53)) + 1j).astype(np.complex64))
    assert torch.equal(checks.checked(sc.lt_ls)(x, x), sc.lt_ls(x, x))


# -- timing ---------------------------------------------------------------------------


def test_report_json_keys_equal_the_jax_reports():
    ours, theirs = timing.Report(meta={"device": "x"}), JT.Report(meta={"device": "x"})
    for r in (ours, theirs):
        r.add("chain", frames_per_s=1.5, batch=4)
        r.add("raw", ms=2.0)
    assert json.loads(ours.json()) == json.loads(theirs.json())
    assert list(json.loads(ours.json())) == ["meta", "chain", "raw"]


def test_report_save(tmp_path):
    r = timing.Report(meta={"a": 1})
    r.add("row", v=2)
    r.save(tmp_path / "r.json")
    assert json.loads((tmp_path / "r.json").read_text()) == {"meta": {"a": 1}, "row": {"v": 2}}


@pytest.mark.parametrize("batch", [1, 128, 65536])
def test_rx_chain_cost_equals_jax(batch):
    assert timing.rx_chain_cost(batch) == JT.rx_chain_cost(batch)


def test_roofline_h100():
    """The H100's published peaks (67 TFLOP/s f32, 3.35 TB/s): keys as the
    JAX roofline's, times from those rates; the TPU entries are not here."""
    flops, nb = 2.0e9, 6.7e9
    got = timing.roofline(flops, nb, "h100")
    assert set(got) == set(JT.roofline(flops, nb, "v5e"))
    assert got["t_compute_s"] == pytest.approx(flops / 67e12)
    assert got["t_memory_s"] == pytest.approx(nb / 3.35e12)
    assert got["bound"] == "memory" and got["t_light_s"] == got["t_memory_s"]
    assert timing.roofline(1e15, 1.0)["bound"] == "compute"
    assert set(timing.CHIP_PEAKS) == {"h100"}
    with pytest.raises(KeyError):
        timing.roofline(1.0, 1.0, "v5e")


def test_bound_and_nbytes():
    x = torch.zeros(10, 4)                     # 160 bytes
    tree = {"a": x, "b": Cplx(x, x), "c": [x.to(torch.bfloat16)], "d": None}
    assert timing.nbytes(tree) == 160 * 3 + 80
    ms, by = timing.bound(0.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = timing.bound(67e9, 0, tc_ops=989e9)
    assert by == "operations" and ms == pytest.approx(2.0)


def test_timeit_on_the_cpu_counts_calls():
    calls = []
    s = timing.timeit(lambda v: calls.append(v), 7, iters=5, warmup=2, device="cpu")
    assert calls == [7] * 7 and s >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    """The Chrome trace lands in the caller's directory and carries the
    program's spans: here the entry span of a CPU chain call."""
    from tpu80211_torch.kernels import fused_chain as F

    from _torch_inputs import lane_major, make_frames, torch_planes

    tx_pkt, rx_pkt, tx_lp, rx_lp = make_frames(3, 4, tx_const=True)
    txc = F.tx_spectra(torch_planes(tx_pkt[0]), torch_planes(tx_lp[0]))
    with timing.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
        F.fused_rx_chain_txconst(*txc, torch_planes(lane_major(rx_pkt)),
                                 torch_planes(lane_major(rx_lp)))
    assert prof.key_averages() is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert events
    assert "tpu80211.entry.fused_rx_chain_txconst" in {e.get("name") for e in events}
