"""The port's quality benchmark (``tpu80211_torch/bench/quality.py``) against
the JAX package's.  The two draw other random numbers from a seed, so they
are held to each other's statistics: at B=512 frames an estimator's NMSE
has a spread of a few tenths of a dB, so each agrees within 1 dB, and two
estimators the JAX sweep puts more than 1 dB apart come in the same order."""

import itertools

import pytest
import torch

from tpu80211.bench import quality as JQ
from tpu80211_torch.bench import quality as Q

SNRS = (5.0, 15.0, 30.0)
B = 512


@pytest.fixture(scope="module")
def sweeps():
    return JQ.quality_sweep(SNRS, batch=B), Q.quality_sweep(SNRS, batch=B, device="cpu")


def test_sweep_rows_have_the_jax_layout(sweeps):
    jax_rows, rows = sweeps
    assert len(rows) == len(SNRS)
    for j, r in zip(jax_rows, rows):
        assert set(r) == set(j) and r["snr_db"] == j["snr_db"] and r["batch"] == B
        assert list(r["estimators"]) == list(j["estimators"])
        for name, m in r["estimators"].items():
            assert set(m) == {"nmse_db", "evm_rms", "ber"}, name


@pytest.mark.parametrize("k", range(len(SNRS)))
def test_sweep_nmse_within_1db_of_jax(sweeps, k):
    jax_rows, rows = sweeps
    for name, m in rows[k]["estimators"].items():
        want = jax_rows[k]["estimators"][name]["nmse_db"]
        assert abs(m["nmse_db"] - want) <= 1.0, (SNRS[k], name, m["nmse_db"], want)


@pytest.mark.parametrize("k", range(len(SNRS)))
def test_sweep_ordering_matches_jax(sweeps, k):
    jax_rows, rows = sweeps
    j, r = jax_rows[k]["estimators"], rows[k]["estimators"]
    for a, b in itertools.combinations(j, 2):
        gap = j[a]["nmse_db"] - j[b]["nmse_db"]
        if abs(gap) > 1.0:
            assert (r[a]["nmse_db"] - r[b]["nmse_db"]) * gap > 0, (SNRS[k], a, b)


def test_nmse_falls_with_snr(sweeps):
    _, rows = sweeps
    for name in ("lt_ls", "ps_mmse"):
        nmse = [r["estimators"][name]["nmse_db"] for r in rows]
        assert nmse[0] > nmse[1] > nmse[2] and nmse[2] < -25.0, (name, nmse)


def test_qam16_point_matches_jax_statistics():
    """16-QAM frames at SNR 25: MMSE NMSE within 1 dB and its BER within a
    factor of two of the JAX point's (both small)."""
    j = JQ.quality_point(25.0, batch=B, modulation="qam16")["estimators"]["ps_mmse"]
    r = Q.quality_point(25.0, batch=B, modulation="qam16", device="cpu")["estimators"]["ps_mmse"]
    assert abs(r["nmse_db"] - j["nmse_db"]) <= 1.0
    assert 0 < r["ber"] < 0.05 and 0.5 <= r["ber"] / j["ber"] <= 2.0


def test_fused_point_matches_the_jax_fused_point():
    """``quality_point_fused`` (the fused chain's plain version on the CPU,
    bf16 samples) against the JAX ``quality_point_fused`` (its kernel in
    interpret mode) at SNR 20, B=256: every estimator's NMSE within 1 dB.
    Both average two LTS repeats with independent noise, so LT-LS and MMSE
    sit ~3 dB below `quality_point`'s single noisy preamble."""
    row = Q.quality_point_fused(20.0, batch=256, device="cpu")
    ref = JQ.quality_point_fused(20.0, batch=256)
    assert row["dtype"] == ref["dtype"] == "bfloat16" and row["batch"] == 256
    assert list(row["estimators"]) == list(ref["estimators"])
    for name, m in row["estimators"].items():
        assert abs(m["nmse_db"] - ref["estimators"][name]["nmse_db"]) <= 1.0, name
    assert row["estimators"]["ps_mmse"]["nmse_db"] < -20.0
    assert 0 <= row["eq_linear_blend"]["ber"] < 0.2
    f32 = Q.quality_point_fused(20.0, batch=64, dtype=torch.float32, device="cpu")
    assert f32["dtype"] == "float32"


def test_plot_quality_writes_its_file(sweeps, tmp_path):
    pytest.importorskip("matplotlib")
    _, rows = sweeps
    fused = Q.quality_sweep_fused((10.0, 30.0), batch=64, device="cpu")
    out = Q.plot_quality(rows, str(tmp_path / "q.png"), fused_rows=fused)
    assert out == str(tmp_path / "q.png")
    data = (tmp_path / "q.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 10_000
