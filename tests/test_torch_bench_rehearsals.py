"""The bench modules ported from the JAX package's measurement scripts,
rehearsed on the CPU (``--device cpu``, the plain versions) at a small
size: each gates, times, ends with one JSON line under 1,500 characters,
and writes under ``--out`` a document with every key its script writes
(the key sets below, read from each script's source); without a card and
without ``--device cpu``, each exits non-zero.  No JAX is imported here."""

import importlib
import json

import pytest
import torch

from tpu80211_torch.bench import throughput as TP

MODULES = ("stream", "latency", "raw_stream", "raw_quality", "stages", "detect", "mmse_solve",
           "raw_anatomy", "scaling")

# each script's keys (scripts/bench_*.py): the document, and its rows
STREAM_ROW = {"metric", "generator", "frames_per_s", "ms_per_batch", "batch", "n_batches",
              "wall_s_single_run", "device"}                                  # bench_stream.py:64-73
LATENCY_DOC = {"device", "dtype", "iters", "rows"}                            # bench_latency.py:105-110
LATENCY_ROW = {"batch", "ms_per_step_marginal", "ms_per_step_marginal_spread", "repeats",
               "ms_per_step_single_loop", "frames_per_s"}                     # :71-82
RAW_STREAM_DOC = {"device", "batch", "ns", "timing_err_band", "detect", "detect_decimated",
                  "system", "system_fused", "system_fused_serve", "system_fused_i8_serve"}
RAW_STREAM_DETECT = {"streams_per_s", "ms_per_step"}                          # :117-121, 142-145
RAW_STREAM_SYSTEM = {"frames_per_s", "ms_per_step"}                           # :160-163
QUALITY_DOC = {"metric", "device", "rows", "false_alarm_on_noise"}            # bench_raw_quality.py:108-113
QUALITY_ROW = {"snr_db", "batch", "detect_rate", "timing_in_band_rate", "timing_within_cp_rate",
               "cfo_median_err_hz", "evm_rms_detected"}                       # :66-86
FA_ROW = {"threshold", "false_alarm_rate", "streams"}                         # :103-104
STAGES_DOC = {"device", "batch", "iters", "rows"}                             # bench_stages.py:145-146
STAGES_ROW = {"stage", "prefix_ms", "prefix_spread_ms", "repeats", "marginal_ms"}   # :128-139
DETECT_DOC = {"metric", "streams_per_s", "ms_per_batch", "samples_per_s", "batch", "stream_len",
              "timing_err_range", "device"}                                   # bench_detect.py:81-90
SOLVE_DOC = {"device", "gauss_rel_err", "gauss", "chol_rel_err", "chol"}      # bench_mmse_solve.py:148-162
SOLVE_ROW = {"method", "solves_per_s", "ms_per_step", "batch", "wall_s_single_loop"}  # :130-136
ANATOMY_DOC = {"metric", "rows", "sensitivity_vs_stride", "floors_ms"}        # bench_raw_anatomy.py:229-259
ANATOMY_ROW = {"config", "batch", "iters", "per_s", "ms_per_step", "device"}  # :160-165
ANATOMY_FLOORS = {"chain_if_detection_were_free", "detection_alone_stride16",
                  "full_system_stride16", "fusion_saving"}
SCALING_DOC = {"metric", "backend", "caveat", "rows", "distributed_2process",
               "reference_sweep_clock_ticks"}                                 # bench_scaling.py:193-216
SCALING_ROW = {"dp", "blk", "devices", "frames_per_s", "ms_per_step", "speedup_vs_1dev",
               "scaling_efficiency", "all_reduce_count", "all_reduce_groups",
               "other_collectives"}                                           # :90-100
SCALING_TWO = {"config", "processes", "devices", "frames_per_s", "ms_per_step", "metric"}


@pytest.fixture(autouse=True)
def two_threads():
    """The rehearsals run in the test process beside the other test
    workers: at torch's default of a thread per core, its many small CPU
    ops spin against theirs and a stream rehearsal of seconds took
    minutes.  Two threads each, as ``tests/test_torch_bench.py`` gives its
    subprocesses."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def rehearse(name: str, capsys, tmp_path, *args) -> tuple[dict, dict]:
    """``main(["--device", "cpu", *args, "--out", ...])``: exit 0, the last
    line's object and the document."""
    out = tmp_path / f"{name}.json"
    mod = importlib.import_module(f"tpu80211_torch.bench.{name}")
    rc = mod.main(["--device", "cpu", *args, "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines[-1]) < TP.MAX_LINE
    last = json.loads(lines[-1])
    assert last.get("device", "cpu") == "cpu"
    return last, json.loads(out.read_text())


@pytest.mark.parametrize("name", MODULES)
def test_module_without_a_card_exits_nonzero(name, capsys):
    """The card is the default; with none, and no ``--device cpu``, the
    module exits 1 before it builds or times anything."""
    assert importlib.import_module(f"tpu80211_torch.bench.{name}").main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("gens", [("256", "2", "xla"), ("256", "2", "kernel"),
                                  ("1024", "1", "raw"), ("1024", "1", "kernel_raw")],
                         ids=lambda gens: gens[2])
def test_stream_rehearsal(gens, capsys, tmp_path):
    """The raw generators run at B=1,024: their timing-in-band gate (>= 0.85
    on every batch) is a rate over the batch, and at the B/2 = 128 streams of
    a B=256 step one batch's rate falls below it by chance (0.82 seen)."""
    last, doc = rehearse("stream", capsys, tmp_path, *gens)
    gen = gens[2]
    row = doc["rows"][gen]
    assert STREAM_ROW <= set(row) and row["generator"] == gen
    assert row["gates"]["timed"]["batches"] > int(gens[1]) and row["idle_share"] is None
    assert list(last["rows"]) == [gen] and last["rows"][gen]["frames_per_s"] > 0


def test_latency_rehearsal(capsys, tmp_path):
    last, doc = rehearse("latency", capsys, tmp_path, "2", "128,256")
    assert LATENCY_DOC <= set(doc) and doc["dtype"] == "bf16"
    assert [r["batch"] for r in doc["rows"]] == [128, 256]
    for row in doc["rows"]:
        assert LATENCY_ROW <= set(row) and row["ms_per_step_event"] is None
        assert row["gates"]["finite"]


def test_raw_stream_rehearsal(capsys, tmp_path):
    last, doc = rehearse("raw_stream", capsys, tmp_path, "256", "2")
    assert RAW_STREAM_DOC <= set(doc)
    assert RAW_STREAM_DETECT | {"note"} <= set(doc["detect"])
    assert RAW_STREAM_DETECT <= set(doc["detect_decimated"])
    for name in ("system", "system_fused", "system_fused_serve", "system_fused_i8_serve"):
        assert RAW_STREAM_SYSTEM <= set(doc[name]), name
    assert -4 <= doc["timing_err_band"][0] <= doc["timing_err_band"][1] <= -2


def test_raw_quality_rehearsal(capsys, tmp_path):
    last, doc = rehearse("raw_quality", capsys, tmp_path, "256", "--fa-streams", "256")
    assert QUALITY_DOC <= set(doc) and len(doc["rows"]) == 8
    assert all(set(r) == QUALITY_ROW for r in doc["rows"])
    assert [r["threshold"] for r in doc["false_alarm_on_noise"]] == [0.3, 0.4, 0.5, 0.6]
    assert all(set(r) == FA_ROW for r in doc["false_alarm_on_noise"])
    # more SNR, less EVM: 40 dB against -5 dB
    assert doc["rows"][-1]["evm_rms_detected"] < doc["rows"][0]["evm_rms_detected"]


def test_stages_rehearsal(capsys, tmp_path):
    last, doc = rehearse("stages", capsys, tmp_path, "64", "2")
    assert STAGES_DOC <= set(doc) and len(doc["rows"]) == 9
    for row in doc["rows"]:
        assert STAGES_ROW <= set(row)
        assert (row["marginal_ms"] is None) == ("marginal_below_jitter_ms" in row)


def test_detect_rehearsal(capsys, tmp_path):
    last, doc = rehearse("detect", capsys, tmp_path, "32", "2048", "2")
    assert DETECT_DOC <= set(doc) and doc["stream_len"] == 2048
    assert max(map(abs, doc["timing_err_range"])) <= 4


def test_mmse_solve_rehearsal(capsys, tmp_path):
    last, doc = rehearse("mmse_solve", capsys, tmp_path, "256", "2", "--methods",
                         "gauss,chol,xla,xla_chol")
    assert SOLVE_DOC <= set(doc) and doc["gauss_rel_err"] < 5e-5 and doc["chol_rel_err"] < 5e-5
    for method in ("gauss", "chol", "xla", "xla_chol"):
        assert SOLVE_ROW <= set(doc[method]) and doc[method]["method"] == method
    assert list(last["rows"]) == ["gauss", "chol", "xla", "xla_chol"]


def test_raw_anatomy_rehearsal(capsys, tmp_path):
    last, doc = rehearse("raw_anatomy", capsys, tmp_path, "256", "2", "--sens-batch", "256")
    assert ANATOMY_DOC <= set(doc) and set(doc["floors_ms"]) == ANATOMY_FLOORS
    assert [r["config"] for r in doc["rows"]] == [
        "chain_only_prealigned", "detect_only_stride16", "detect_only_stride32",
        "detect_only_stride64", "raw_system_stride16", "raw_system_stride32",
        "raw_system_stride64", "raw_i8_serve_stride32"]
    for row in doc["rows"]:
        assert ANATOMY_ROW <= set(row)
        assert ("timing_err_band" in row) == (row["config"] != "chain_only_prealigned")
    sens = doc["sensitivity_vs_stride"]
    assert {"workload", "rows", "decision"} <= set(sens)
    assert [r["snr_db"] for r in sens["rows"]] == [10.0, 0.0, -5.0]
    assert all(set(r["detect"]) == {"s16", "s32", "s64"} for r in sens["rows"])


def test_scaling_rehearsal(capsys, tmp_path):
    """In a gloo world of 2 (the record's 8 on the card's host): the shapes
    that fit, their all-reduces at ``parallel.mesh.all_reduce`` with the
    groups of every rank, no other collective."""
    last, doc = rehearse("scaling", capsys, tmp_path, "--world", "2", "--batch", "64",
                         "--iters", "1")
    assert SCALING_DOC <= set(doc) and "card_world_of_one" not in doc
    assert [(r["dp"], r["blk"]) for r in doc["rows"]] == [(1, 1), (2, 1)]
    for row in doc["rows"]:
        assert SCALING_ROW <= set(row) and row["all_reduce_count"] == 2
        assert row["other_collectives"] == []
    assert doc["rows"][1]["all_reduce_groups"] == ["{{0},{1}}", "{{0,1}}"]
    assert set(doc["distributed_2process"]) == SCALING_TWO
    assert doc["reference_sweep_clock_ticks"]["1x20"] == [10470000, 24160000]
