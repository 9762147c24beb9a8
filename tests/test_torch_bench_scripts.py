"""The bench modules ported from the JAX package's measurement scripts
(``tpu80211_torch/bench/{raw_stream,detect,raw_quality,stages,mmse_solve,
latency}.py``) held against the scripts themselves on the CPU, at small
sizes.

A script's functions are loaded with ``runpy.run_path`` (never its
``main``: several write into ``artifacts/``), its compile-cache settings
left out.  Where the part to compare is inline in the script's ``main``,
the test runs the script's own statements (`run_statements`) on the same
inputs.
"""

import ast
import pathlib
import runpy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.cplx import Cplx as JCplx
from tpu80211.datasets.loader import load_capture as jax_load_capture
from tpu80211.kernels import detect_kernel as JD
from tpu80211.kernels.fused_chain import tx_spectra as jax_tx_spectra
from tpu80211.kernels.raw_gen_chain import gen_raw_system as jax_gen_raw_system
from tpu80211.ops import detect as jax_detect

from tpu80211_torch.bench import detect as BD
from tpu80211_torch.bench import latency as BL
from tpu80211_torch.bench import mmse_solve as BM
from tpu80211_torch.bench import raw_quality as BQ
from tpu80211_torch.bench import raw_stream as BR
from tpu80211_torch.bench import stages as BS
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.ops import detect as port_detect

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def load_script(name: str, monkeypatch) -> dict:
    """The script's globals, loaded without running ``main`` and without its
    persistent compile-cache settings; a name set here is what its
    functions see."""
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda key, value: None if "cache" in key else update(key, value))
    g = runpy.run_path(str(SCRIPTS / f"{name}.py"), run_name="jax_script")
    monkeypatch.setattr(jax.config, "update", update)
    return g["main"].__globals__   # the functions' own globals (run_path returns a copy)


def run_statements(name: str, starts: list[str], **ns) -> dict:
    """Execute, in ``ns``, the statements of the script's ``main`` (or of a
    loop inside it) whose source begins with each of ``starts``, in order."""
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    stmts = [s for node in ast.walk(main) if isinstance(getattr(node, "body", None), list)
             for s in node.body]
    chosen = []
    for start in starts:
        found = [s for s in stmts if ast.unparse(s).startswith(start)]
        assert len(found) == 1, (name, start, len(found))
        chosen.append(found[0])
    exec(compile(ast.Module(body=chosen, type_ignores=[]), str(path), "exec"), ns)
    return ns


def jax_lts():
    lts = jax_detect.lts_time_symbol(JCplx.from_complex(jax_load_capture().tx_lptot))
    return JCplx(jnp.asarray(lts.re, jnp.float32), jnp.asarray(lts.im, jnp.float32))


def port_lts():
    return TP.capture_consts(BR.load_capture(), "cpu")[1]


# -- raw_stream ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_streams():
    """The port's streams at B=64 on the CPU, and the offsets."""
    x, offs, _ = BR.make_streams(64, np.random.default_rng(0), "cpu")
    return x, offs


def test_raw_stream_workload_is_the_scripts_bit_for_bit(raw_streams, monkeypatch):
    g = load_script("bench_raw_stream", monkeypatch)
    xc, offs, _ = g["_make_streams"](64, np.random.default_rng(0))
    x, port_offs = raw_streams
    np.testing.assert_array_equal(port_offs, offs)
    for got, want in ((x.re, xc.re), (x.im, xc.im)):
        assert got.dtype == torch.bfloat16 and got.shape == (BR.NS, 64)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


@pytest.mark.parametrize("decimate", [False, True])
def test_raw_stream_detection_finds_the_starts_jax_finds(raw_streams, decimate):
    """The port's ``detect_streams`` (its plain version on the CPU) against
    JAX's CPU path, ``ops.detect.detect_packet`` (the path JAX's
    ``detect_streams`` takes off the TPU; it ignores ``decimate``, which
    moves ``coarse`` but not ``start``), on the streams' float32 upcast: the
    TPU kernel upcasts bf16 streams (detect_kernel.py:271-272) and so does
    the port, where the CPU path would detect in bf16."""
    x, offs = raw_streams
    want = jax_detect.detect_packet(
        JCplx(*(jnp.asarray(p.float().numpy().T) for p in x)), jax_lts())
    got = D.detect_streams(x, port_lts(), decimate=decimate)
    np.testing.assert_array_equal(got["detected"].numpy(), np.asarray(want["detected"]))
    np.testing.assert_array_equal(got["start"].numpy(), np.asarray(want["start"]))
    err = got["start"].numpy() - offs
    assert got["detected"].all() and err.min() >= -4 and err.max() <= -2


# -- detect ----------------------------------------------------------------------------------


def test_detect_streams_and_starts_are_the_scripts():
    """``bench.detect``'s streams equal the script's numpy code
    (bench_detect.py:42-49), and ``ops.detect.detect_packet`` finds the
    starts the JAX one finds on them (B=32)."""
    ns = run_statements("bench_detect", ["cap = ", "rng = ", "offs = ", "stream = ", "frame = ",
                                          "for i, o in enumerate(offs)"],
                        batch=32, n=2048, np=np, load_capture=jax_load_capture)
    stream, offs, cap = BD.make_streams(32, 2048)
    np.testing.assert_array_equal(offs, ns["offs"])
    np.testing.assert_array_equal(stream, ns["stream"])
    ref = jax_detect.lts_time_symbol(ns["cap"].tx_lptot)
    ref = JCplx(jnp.asarray(ref.re, jnp.float32), jnp.asarray(ref.im, jnp.float32))
    want = jax_detect.detect_packet(JCplx.from_complex(ns["stream"], jnp.float32), ref)
    got = port_detect.detect_packet(torch.tensor(stream, dtype=torch.complex64),
                                    port_detect.lts_time_symbol(cap.tx_lptot).to(torch.complex64))
    np.testing.assert_array_equal(got["detected"].numpy(), np.asarray(want["detected"]))
    np.testing.assert_array_equal(got["start"].numpy(), np.asarray(want["start"]))
    assert np.abs(got["start"].numpy() - offs).max() <= 4


# -- raw_quality -----------------------------------------------------------------------------


def test_false_alarm_flags_equal_jax_detect_streams():
    """The script's noise (bench_raw_quality.py:93-97) at 256 streams: the
    port's ``fa_noise``, and its flags at each threshold those of JAX's
    ``detect_streams``."""
    ns = run_statements("bench_raw_quality", ["rng = ", "noise = "], nb=256, np=np)
    noise = BQ.fa_noise(256)
    np.testing.assert_array_equal(noise, ns["noise"])
    xn = JCplx(jnp.asarray(noise.real, jnp.float32), jnp.asarray(noise.imag, jnp.float32))
    lts = port_lts()
    port = BQ.false_alarms(noise, lts, "cpu")
    for row, thr in zip(port, BQ.THRESHOLDS):
        want = np.asarray(JD.detect_streams(xn, jax_lts(), threshold=thr)["detected"])
        got = D.detect_streams(BQ.Cplx(*(torch.tensor(p, dtype=torch.float32)
                                          for p in (noise.real, noise.imag))), lts,
                               threshold=thr)["detected"].numpy()
        np.testing.assert_array_equal(got, want)
        assert row == {"threshold": thr, "false_alarm_rate": float(want.mean()), "streams": 256}


def test_quality_row_is_the_scripts_formulas():
    """`quality_row` on one JAX ``gen_raw_system`` output (B=256, SNR 30,
    20 kHz, h_mmse) against the script's statements (:66-86) on the same
    output: the rates exactly, the CFO error and the EVM within 1e-6."""
    cap = jax_load_capture()
    txs, tpre = jax_tx_spectra(JCplx.from_complex(cap.tx_packet, jnp.float32),
                               JCplx.from_complex(cap.tx_lptot, jnp.float32))
    den = float(np.sum(np.asarray(txs.re[:, :15]) ** 2 + np.asarray(txs.im[:, :15]) ** 2)) / 15.0
    out = jax_gen_raw_system(jnp.int32(106), 256, txs, tpre, jax_lts(), snr_db=30.0,
                             equalize_with="h_mmse", cfo_khz=20.0)
    ns = run_statements("bench_raw_quality", ["det = ", "err = ", "cfo_err_hz = ", "evm_s = ",
                                              "d = ", "row = "],
                        out=out, snr=30.0, batch=256, den=den, np=np)
    want, got = ns["row"], BQ.quality_row(out, 30.0, 256, den)
    assert list(got) == list(want)
    for k in ("snr_db", "batch", "detect_rate", "timing_in_band_rate", "timing_within_cp_rate"):
        assert got[k] == want[k], k
    for k in ("cfo_median_err_hz", "evm_rms_detected"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert want["detect_rate"] > 0.99


# -- stages ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage_inputs():
    """(tx_pkt, rx_pkt, tx_lp, rx_lp) complex64 numpy frames, B=16."""
    rng = np.random.default_rng(5)
    return tuple((rng.standard_normal((16, n)) + 1j * rng.standard_normal((16, n)))
                 .astype(np.complex64) for n in (1200, 1200, 160, 160))


def test_stage_list_is_the_scripts(monkeypatch):
    assert BS.STAGES == load_script("bench_stages", monkeypatch)["STAGES"]


@pytest.mark.parametrize("k", range(1, len(BS.STAGES) + 1))
def test_prefix_chain_matches_the_scripts(k, stage_inputs, monkeypatch):
    """The port's ``prefix_chain`` against the script's at each prefix
    length on the same complex64 frames, the sum compared before ``tanh``
    (the script's ``jnp.tanh`` made the identity): rel 1e-5.  The port's
    counterpart of tests/test_bench_smoke.py:9-35."""
    g = load_script("bench_stages", monkeypatch)
    g["jnp"] = types.SimpleNamespace(stack=jnp.stack, sum=jnp.sum, tanh=lambda v: v)
    jargs = tuple(JCplx(jnp.asarray(x.real), jnp.asarray(x.imag)) for x in stage_inputs)
    want = float(g["prefix_chain"](jargs, k))
    got = float(BS.prefix_chain(tuple(torch.from_numpy(x) for x in stage_inputs), k,
                                squash=lambda v: v))
    assert got == pytest.approx(want, rel=1e-5)


# -- mmse_solve, latency ---------------------------------------------------------------------


@pytest.mark.parametrize("method", BM.METHODS)
def test_mmse_correctness_check_passes_on_the_plain_solves(method):
    assert BM.correctness(method, "cpu") < BM.TOL


def _script_latency_row(monkeypatch, singles, margins, iters):
    """The script's ``sweep_one`` row with its clock fed ``singles[r]`` and
    ``singles[r] + margins[r]`` for repeat r's loops of n and 2n steps."""
    g = load_script("bench_latency", monkeypatch)
    g["bench"] = types.SimpleNamespace(_gen=lambda key, batch, dtype: jnp.zeros((2, 2)),
                                       _step_fused=lambda base, s, inc: s)
    ticks, t = [], 1.0
    for single, margin in zip(singles, margins):
        for d in (single, single + margin):
            ticks += [t, t + d]
            t += d + 1.0
    clock = iter(ticks)
    g["time"] = types.SimpleNamespace(perf_counter=lambda: next(clock))
    return g["sweep_one"](512, iters, jnp.float32)


# (singles, margins) in seconds, dyadic so every clock difference is exact
LATENCY_CASES = {
    "resolved": ([2 ** -7] * 3, [2 ** -8, 2 ** -8 + 2 ** -12, 2 ** -8 - 2 ** -12]),
    "under_50us": ([2 ** -9] * 3, [2 ** -10, 2 ** -10, 2 ** -10 + 2 ** -16]),
    "spread": ([2 ** -7] * 3, [2 ** -8, 2 ** -6, 2 ** -9]),
    "at_half": ([2 ** -7] * 3, [2 ** -8 - 2 ** -10, 2 ** -8, 2 ** -8 + 2 ** -10]),
}


@pytest.mark.parametrize("case", sorted(LATENCY_CASES))
def test_latency_unresolved_rule_is_the_scripts(case, monkeypatch):
    singles, margins = LATENCY_CASES[case]
    iters = 32
    want = _script_latency_row(monkeypatch, singles, margins, iters)
    dt, spread, unres = BL.unresolved(margins, iters)
    assert unres == (case in ("under_50us", "spread"))   # at_half: spread = dt/2 resolves
    assert unres == bool(want.get("unresolved")) and (want["frames_per_s"] is None) == unres
    assert round(1e3 * dt / iters, 4) == want["ms_per_step_marginal"]
    assert round(1e3 * spread / iters, 4) == want["ms_per_step_marginal_spread"]
