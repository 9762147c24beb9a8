"""The port's command line (``tpu80211_torch/cli.py``) against the JAX
package's (``tpu80211/cli.py``), both called in this process on the CPU
(the port's with ``--device cpu``; ``tests/conftest.py`` pins JAX to the
CPU with x64 on).

Tolerances: ``run`` at complex128, as in ``tests/test_torch_models.py``:
1e-12, and 1e-8 for the MATLAB-mode MMSE, whose σ² division magnifies the
two packages' 1e-16 LT-LS difference.  The printed ``H_EST`` lines carry
11 significant digits (``%+.10e``, the JAX command's format), so printed
values are compared within that tolerance plus one unit of the print's
rounding (1e-10 relative); the values themselves are compared exactly
through ``run_estimators``.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu80211 import cli as jcli
from tpu80211.config import EstimatorMode as JMode
from tpu80211.datasets.loader import load_capture as jload_capture
from tpu80211.models import PS_ESTIMATORS as JPS
from tpu80211.models import lt_ls as jlt_ls
from tpu80211.models import ps_mmse as jps_mmse
from tpu80211_torch import cli
from tpu80211_torch.config import ESTIMATOR_NAMES

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ["math", "matlab", "c_parity"]
PRINT_QUANTUM = 1e-10   # one unit in the 11th significant digit, relative
GENS = ["kernel", "xla", "raw", "kernel_raw"]


def _tol(mode: str, name: str) -> float:
    return 1e-8 if (mode, name) == ("matlab", "ps_mmse") else 1e-12


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.abs(got - want).max() / np.abs(want).max())


def port(capsys, *argv) -> tuple[int, str]:
    rc = cli.main([*argv[:1], "--device", "cpu", *argv[1:]])
    return rc, capsys.readouterr().out


def jax_cli(capsys, *argv) -> tuple[int, str]:
    rc = jcli.main(list(argv))
    return rc, capsys.readouterr().out


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


# -- the parser ------------------------------------------------------------------------------


def _options(parser: argparse.ArgumentParser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default,
                            tuple(a.choices) if a.choices else None, a.type, a.nargs,
                            type(a).__name__)
                   for a in sp._actions if a.dest != "help"}
            for name, sp in sub.choices.items()}


def test_parser_has_the_jax_commands_and_options():
    """The same ten subcommands; each with its counterpart's options
    (flags, defaults, choices, types), but for the stated differences:
    ``--device`` on every command that computes, and the stream engine
    ``torch`` where the JAX one is ``jax``."""
    got, want = _options(cli._build_parser()), _options(jcli._build_parser())
    assert list(got) == list(want)
    for name, opts in got.items():
        if name in cli.DEVICE_COMMANDS:
            assert opts.pop("device")[:2] == (("--device",), "cuda"), name
        if name == "stream":
            assert opts["engine"][2] == ("native", "torch")
            assert want[name]["engine"][2] == ("native", "jax")
            opts["engine"] = want[name]["engine"]
        assert opts == want[name], name
    assert set(cli.DEVICE_COMMANDS) == set(got) - {"devices"}


# -- run -------------------------------------------------------------------------------------


def _jax_estimates(mode: str) -> dict:
    """The JAX command's values (tpu80211/cli.py:161-199's calls)."""
    m = JMode(mode)
    cap = jload_capture()
    txb, rxb = jnp.asarray(cap.tx_symb), jnp.asarray(cap.rx_symb)
    h_lt = jlt_ls(jnp.asarray(cap.tx_preamble_fft), jnp.asarray(cap.rx_preamble_fft), mode=m)
    out = {"lt_ls": h_lt, "ps_mmse": jps_mmse(txb, rxb, cap.ow2, h_lt, mode=m)}
    out.update({name: fn(txb, rxb, mode=m) for name, fn in JPS.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _parse_run(out: str) -> dict:
    res, name = {}, None
    for line in out.splitlines():
        if line.startswith("# "):
            name = line[2:].split(" (")[0]
            res[name] = []
        elif line.startswith("H_EST["):
            re_, im = line.split(" = ")[1].split()
            res[name].append(complex(float(re_), float(im[:-1])))
    return {k: np.array(v) for k, v in res.items()}


@pytest.mark.parametrize("mode", MODES)
def test_run_estimators_match_the_jax_estimators(mode):
    got = cli.run_estimators(ESTIMATOR_NAMES, mode, device="cpu")
    want = _jax_estimates(mode)
    assert list(got) == list(ESTIMATOR_NAMES)
    for name, (ms, h) in got.items():
        assert ms >= 0 and h.shape == (53,) and h.dtype == np.complex128
        assert _rel(h, want[name]) <= _tol(mode, name), name


@pytest.mark.parametrize("mode", MODES)
def test_run_prints_the_jax_commands_lines(mode, capsys):
    rc, out = port(capsys, "run", "--mode", mode)
    jrc, jout = jax_cli(capsys, "run", "--mode", mode)
    assert rc == jrc == 0
    got, want = _parse_run(out), _parse_run(jout)
    assert list(got) == list(want) == list(ESTIMATOR_NAMES)
    assert [ln.split(":")[0] for ln in out.splitlines() if ln.startswith("#")] == \
        [ln.split(":")[0] for ln in jout.splitlines() if ln.startswith("#")]
    for name in got:
        assert got[name].shape == (53,)
        assert _rel(got[name], want[name]) <= _tol(mode, name) + PRINT_QUANTUM, name


def test_run_options(capsys):
    rc, out = port(capsys, "run", "--estimators", "lt_ls,ps_mmse", "--quiet", "--avg-blocks", "2")
    assert rc == 0 and [ln.split(" (")[0] for ln in out.splitlines()] == ["# lt_ls", "# ps_mmse"]
    assert port(capsys, "run", "--estimators", "nope")[0] == 2


# -- parity ----------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_parity_passes_as_the_jax_command_does(mode, capsys):
    rc, out = port(capsys, "parity", "--mode", mode)
    jrc, jout = jax_cli(capsys, "parity", "--mode", mode)
    got, want = _last_json(out), _last_json(jout)
    assert rc == jrc == 0 and got["pass"] and want["pass"]
    assert got["mode"] == want["mode"] == mode
    assert list(got["max_rel_err"]) == list(want["max_rel_err"])
    assert all(v < 1e-6 for v in got["max_rel_err"].values()), got


# -- raw, sync ---------------------------------------------------------------------------------


def test_raw_matches_the_jax_command(capsys):
    rc, out = port(capsys, "raw", "--batch", "128", "--seed", "0")
    jrc, jout = jax_cli(capsys, "raw", "--batch", "128", "--seed", "0")
    got, want = _last_json(out), _last_json(jout)
    assert rc == jrc == 0 and set(got) == set(want)
    for k in ("streams", "ns", "detected", "timing_err_min", "timing_err_max"):
        assert got[k] == want[k], k
    assert got["detected"] == 128 and -4 <= got["timing_err_min"] <= got["timing_err_max"] <= -2
    for k in ("metric_mean", "h_mmse_mean_abs"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k


def test_raw_takes_any_batch_and_checks_ns(capsys):
    """No round-up to 128 (a TPU lane rule); the offset draw's NS checks stay."""
    rc, out = port(capsys, "raw", "--batch", "5", "--seed", "1")
    res = _last_json(out)
    assert rc == 0 and res["streams"] == res["detected"] == 5
    for ns in ("1408", "2000"):
        assert port(capsys, "raw", "--batch", "4", "--ns", ns)[0] == 2


def test_sync_recovers_the_cfo_as_the_jax_command_does(capsys):
    rc, out = port(capsys, "sync")
    jrc, jout = jax_cli(capsys, "sync")
    got, want = _last_json(out), _last_json(jout)
    assert rc == jrc == 0 and set(got) == set(want)
    for res in (got, want):
        assert res["fo_hz_estimated"] == pytest.approx(20e3, rel=0.02)
        assert res["median_symbol_err_sync"] < res["median_symbol_err_uncorrected"]
    assert got["median_symbol_err_uncorrected"] == pytest.approx(
        want["median_symbol_err_uncorrected"], rel=0.1)


# -- stream ------------------------------------------------------------------------------------


def _records(out_dir: pathlib.Path) -> list[dict]:
    recs = []
    for f in sorted(out_dir.glob("*.npz")):
        with np.load(f) as d:
            recs.append({k: d[k] for k in d.files})
    return recs


@pytest.mark.parametrize("gen", GENS)
def test_device_stream_matches_the_jax_record_and_resumes(gen, tmp_path, capsys):
    args = ["--device-gen", "--gen", gen, "--batch", "128"]
    rc, out = port(capsys, "stream", *args, "--batches", "2", "--out-dir", str(tmp_path / "p"))
    jrc, jout = jax_cli(capsys, "stream", *args, "--batches", "1", "--out-dir", str(tmp_path / "j"))
    got, want = _last_json(out), _last_json(jout)
    assert rc == jrc == 0 and set(got) == set(want)
    assert (got["frames"], got["batches"]) == (256, 2)
    recs, jrecs = _records(tmp_path / "p"), _records(tmp_path / "j")
    assert len(recs) == 2 and set(recs[0]) == set(jrecs[0])
    for k, v in recs[0].items():
        assert v.shape == jrecs[0][k].shape and np.isfinite(v).all(), k
    if gen in ("raw", "kernel_raw"):
        assert all(float(r["detect_rate"]) == 1.0 for r in recs)
    cursor = json.loads((tmp_path / "p" / "cursor.json").read_text())
    rc, out = port(capsys, "stream", *args, "--batches", "3", "--out-dir", str(tmp_path / "p"))
    again = _last_json(out)
    assert rc == 0 and again["frames"] == 128, again      # batches 0 and 1 resumed, 2 run
    assert json.loads((tmp_path / "p" / "cursor.json").read_text())["done"] == [0, 1, 2]
    assert cursor["done"] == [0, 1]
    for a, b in zip(recs, _records(tmp_path / "p")):
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("engine", ["native", "torch"])
def test_host_stream_matches_the_jax_shards_and_resumes(engine, tmp_path, capsys):
    rc, out = port(capsys, "stream", "--engine", engine, "--batches", "2", "--batch", "128",
                   "--out-dir", str(tmp_path / "p"))
    jrc, jout = jax_cli(capsys, "stream", "--batches", "1", "--batch", "128",
                        "--out-dir", str(tmp_path / "j"))
    got, want = _last_json(out), _last_json(jout)
    assert rc == jrc == 0 and set(got) == set(want)
    assert (got["frames"], got["batches"]) == (256, 2)
    shards, jshards = _records(tmp_path / "p"), _records(tmp_path / "j")
    assert len(shards) == 2 and set(shards[0]) == set(jshards[0])
    for k, v in shards[0].items():
        assert v.shape == jshards[0][k].shape and np.isfinite(v).all(), k
    rc, out = port(capsys, "stream", "--engine", engine, "--batches", "2", "--batch", "128",
                   "--out-dir", str(tmp_path / "p"))
    assert rc == 0 and _last_json(out)["batches"] == 0


def test_stream_cpu_flag_is_device_cpu(capsys):
    rc = cli.main(["stream", "--cpu", "--batches", "1", "--batch", "128", "--engine", "torch"])
    assert rc == 0 and _last_json(capsys.readouterr().out)["frames"] == 128


# -- quality, bench, sweep -------------------------------------------------------------------


def test_quality_rows_have_the_jax_keys(capsys):
    rc, out = port(capsys, "quality", "--snrs", "10,30", "--batch", "64", "--fused-dtype", "bf16")
    jrc, jout = jax_cli(capsys, "quality", "--snrs", "10,30", "--batch", "64")
    rows = [json.loads(ln) for ln in out.strip().splitlines()]
    jrows = [json.loads(ln) for ln in jout.strip().splitlines()]
    assert rc == jrc == 0 and len(rows) == 4 and len(jrows) == 2
    for r, j in zip(rows, jrows):
        assert set(r) == set(j) and list(r["estimators"]) == list(j["estimators"])
        for name, m in r["estimators"].items():
            assert set(m) == set(j["estimators"][name]), name
    for name in rows[0]["estimators"]:
        assert rows[1]["estimators"][name]["nmse_db"] < rows[0]["estimators"][name]["nmse_db"]
    assert all(r["path"] == "fused_chain" and r["dtype"] == "bfloat16" for r in rows[2:])


@pytest.mark.parametrize("flags,row,batch", [
    ((), "fused", 512), (("--txconst",), "txconst", 1024), (("--txserve",), "txserve", 512),
    (("--xla",), "plain", 256), (("--f32",), "fused", 512), (("--txconst", "--f32"), "txconst", 512),
])
def test_bench_runs_one_gated_row(flags, row, batch, capsys):
    """``bench`` maps its flags as bench.py's single-path mode does and
    returns the port bench's exit code; ``--f32`` puts the chain on float32
    planes (a CPU rehearsal: the plain versions, so the gates read 0)."""
    rc, out = port(capsys, "bench", *flags, "--batch", str(batch), "--iters", "2")
    res = _last_json(out)
    assert rc == 0 and list(res["rows"]) == [row] and res["device"] == "cpu"
    assert res["rows"][row]["gates"]["finite"]
    if row != "plain":
        assert res["rows"][row]["gates"]["err"] == [0.0, 0.0, 0.0, 0.0]
        assert res["metric"].endswith("f32 planes" if "--f32" in flags else "bf16 planes")


def test_bench_gate_failure_raises(capsys, monkeypatch):
    from tpu80211_torch.bench import throughput as TP

    monkeypatch.setitem(TP.CHAIN_TOL_F32, "eq", -1.0)
    with pytest.raises(TP.GateError, match="fused: gate failed"):
        port(capsys, "bench", "--f32", "--batch", "256", "--iters", "1")


def test_sweep_in_a_world_of_one_has_the_jax_row_keys(capsys):
    from tpu80211.bench import scaling as jscaling

    assert not dist.is_initialized()
    rc, out = port(capsys, "sweep", "--batch", "256", "--iters", "1")
    rows = [json.loads(ln) for ln in out.strip().splitlines()]
    want = jscaling.sweep(batch=64, iters=1, shapes=[(1, 1)])[0]
    assert rc == 0 and not dist.is_initialized()
    assert [(r["dp"], r["blk"], r["devices"]) for r in rows] == [(1, 1, 1), (1, 1, 1)]
    assert all(set(r) == set(want) and r["frames_per_s"] > 0 for r in rows)


# -- devices, the card, the module ----------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CLI where no card is present")
def test_devices_without_cuda_exits_1(capsys):
    assert cli.main(["devices"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CLI where no card is present")
@pytest.mark.parametrize("cmd", cli.DEVICE_COMMANDS)
def test_a_command_asked_for_the_card_without_one_exits_nonzero(cmd, capsys):
    """The default device is the card; without one a command exits 1 and
    never carries on on the CPU."""
    assert cli.main([cmd]) == 1
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out == ""


def test_python_m_help_loads_no_jax():
    out = subprocess.run([sys.executable, "-m", "tpu80211_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "sweep" in out.stdout and "devices" in out.stdout
    code = ("import runpy, sys\n"
            "sys.argv = ['tpu80211_torch', 'run', '--help']\n"
            "try:\n"
            "    runpy.run_module('tpu80211_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpu80211.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.endswith("ok\n"), out.stderr


def test_importing_the_cli_runs_nothing_and_loads_no_kernel_or_matplotlib():
    code = ("import sys\n"
            "import tpu80211_torch.__main__, tpu80211_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m.startswith(('matplotlib', 'jax', "
            "'tpu80211_torch.kernels.', 'tpu80211_torch.bench.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout == "ok\n", out.stderr + out.stdout


def test_estimators_and_sync_chain_keep_to_their_inputs_device():
    """On "meta" tensors, an elementwise operation with a tensor made on the
    host raises: the paths ``run``, ``parity``, ``plot`` and ``sync`` take
    on the card make nothing there."""
    from tpu80211_torch import models
    from tpu80211_torch.config import EstimatorMode
    from tpu80211_torch.datasets import synthetic
    from tpu80211_torch.ops import cfo
    from tpu80211_torch.pipeline import sc

    cap = jload_capture()
    meta = [torch.tensor(x, dtype=torch.complex128).to("meta")
            for x in (cap.tx_preamble_fft, cap.rx_preamble_fft, cap.tx_symb, cap.rx_symb)]
    for mode in EstimatorMode:
        h_lt = models.lt_ls(meta[0], meta[1], mode=mode)
        for kind in ("linear", "cubic", "sinc", "spline", "wiener"):
            assert models.ps_interp(meta[2], meta[3], kind, mode=mode).is_meta
        assert models.ps_mmse(meta[2], meta[3], cap.ow2, h_lt, mode=mode).is_meta
    fb = synthetic.generate(torch.Generator().manual_seed(11), 4)
    pkt = synthetic.apply_time_cfo(synthetic.synthesize_time(fb.rx_symb.to("meta")), 1e-3, 160)
    lp = synthetic.apply_time_cfo(synthetic.synthesize_preamble_time(fb.rx_preamble_fft.to("meta")),
                                  1e-3)
    tx_pkt = synthetic.synthesize_time(fb.tx_symb.to("meta"))
    tx_lp = synthetic.synthesize_preamble_time(fb.tx_preamble_fft.to("meta"))
    assert cfo.estimate_cfo(lp).is_meta
    for sync in (False, True):
        assert sc.rx_chain(tx_pkt, pkt, tx_lp, lp, equalize_with="h_mmse", sync=sync).eq.is_meta
