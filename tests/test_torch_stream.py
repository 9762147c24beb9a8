"""The port's device stream against tests/test_stream.py, on the CPU.

The stream draws its frames with the port's generators, so its batches are
not the JAX package's; the tests hold it to the same contract and bounds
(tests/test_stream.py:38-105, 175-224) and its seed and state arithmetic to
the JAX step's, value for value.  Two results differ from the JAX package
on purpose (ROADMAP §C): a batch with no detected stream reports
``evm_rms`` NaN, where the JAX step clamps the count to 1 and reports 0;
and the ``xla`` and ``raw`` generators draw from a torch generator seeded
by (seed, batch index), so the carried state does not enter their draws.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.pipeline import stream as S

B = 128


def _run(tmp_path, name, n, **kw):
    out = tmp_path / name
    res = S.run_stream_device(n, B, out_dir=str(out), sample=8, device="cpu", **kw)
    return res, out


def test_device_stream_runs_persists_resumes(tmp_path):
    """tests/test_stream.py:38-59: summaries and sampled estimates persisted,
    the channel recovered at SNR 35, a second run resumes past everything."""
    res, out = _run(tmp_path, "dstream", 2, snr_db=35.0)
    assert res["frames"] == 256 and res["batches"] == 2
    files = sorted(out.glob("stream_*.npz"))
    assert len(files) == 2
    d = np.load(files[0])
    assert d["h_mmse_sample"].shape == (8, C.N_SC)
    assert np.isfinite(d["h_mmse_sample"]).all()
    assert float(d["h_lt_nmse"]) < 0.1 and float(d["h_mmse_nmse"]) < 0.1
    assert float(d["h_wiener_nmse"]) < 0.5
    res2, _ = _run(tmp_path, "dstream", 2, snr_db=35.0)
    assert res2["frames"] == 0


@pytest.mark.parametrize("gen", list(S.GENERATORS))
def test_resume_is_bit_deterministic(tmp_path, gen):
    """tests/test_stream.py:62-83, for every generator: batches after the
    resume boundary are bit-identical to an uninterrupted run's, and the
    state after every batch is persisted."""
    kw = dict(snr_db=30.0, gen=gen)
    _run(tmp_path, "whole", 4, **kw)
    _run(tmp_path, "resumed", 2, **kw)
    res, _ = _run(tmp_path, "resumed", 4, **kw)
    assert res["frames"] == 2 * B
    for i in (2, 3):
        a = np.load(tmp_path / "whole" / f"stream_{i:06d}.npz")
        b = np.load(tmp_path / "resumed" / f"stream_{i:06d}.npz")
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
    cur = [json.loads((tmp_path / d / "cursor.json").read_text()) for d in ("whole", "resumed")]
    assert set(cur[1]["states"]) == {"0", "1", "2", "3"} and cur[0] == cur[1]


def test_resume_without_states_advances_by_rerunning(tmp_path):
    """A cursor that lists done batches but no states: the run advances the
    state by running those steps again, so later batches still match."""
    _run(tmp_path, "whole", 3, snr_db=30.0)
    _run(tmp_path, "old", 2, snr_db=30.0)
    cur = tmp_path / "old" / "cursor.json"
    cur.write_text(json.dumps({"done": json.loads(cur.read_text())["done"]}))
    res, _ = _run(tmp_path, "old", 3, snr_db=30.0)
    assert res["frames"] == B
    a, b = (np.load(tmp_path / d / "stream_000002.npz") for d in ("whole", "old"))
    np.testing.assert_array_equal(a["h_mmse_sample"], b["h_mmse_sample"])


@pytest.mark.parametrize("gen", ["raw", "kernel_raw"])
def test_raw_stream_modes(gen):
    """tests/test_stream.py:86-105, 175-190: every stream detected at SNR
    30, timing mostly in band, the channel magnitude recovered, a finite
    EVM; the same (i, state) gives the same batch.  The kernel generator's
    batch also moves with the state; the raw generator's does not."""
    step, s0 = S.make_device_stream_step(B, snr_db=30.0, gen=gen, device="cpu")
    summary, sample_h, s1 = step(0, s0)
    assert float(summary["detect_rate"]) == 1.0
    assert float(summary["timing_in_band_rate"]) > 0.7
    assert float(summary["h_mmse_mag_nmse"]) < 0.1
    assert np.isfinite(float(summary["evm_rms"]))
    assert sample_h.re.shape == (53, B)
    _, h_b, _ = step(0, s0)
    assert torch.equal(sample_h.re, h_b.re)
    _, h_c, _ = step(0, s1 + 3)
    assert torch.equal(sample_h.re, h_c.re) == (gen == "raw")


@pytest.mark.parametrize("gen", ["kernel", "xla"])
def test_frequency_stream_modes(gen):
    """The kernel and xla generators at SNR 35: tests/test_stream.py:52-55's
    bounds on every estimator summary."""
    step, s0 = S.make_device_stream_step(B, snr_db=35.0, gen=gen, device="cpu")
    summary, sample_h, s1 = step(0, s0)
    assert set(summary) == {f"{n}_nmse" for n in S._STREAM_ESTS}
    assert float(summary["h_lt_nmse"]) < 0.1 and float(summary["h_mmse_nmse"]) < 0.1
    assert float(summary["h_wiener_nmse"]) < 0.5
    assert sample_h.re.shape == (53, B) and s1.dtype == torch.int32 and s1.dim() == 0


def test_device_stream_steps_are_chained():
    """tests/test_stream.py:210-224: the carried state enters the kernel
    seed, so the same index under another state is another batch, and the
    same (i, state) the same batch."""
    step, s0 = S.make_device_stream_step(B, snr_db=35.0, device="cpu")
    _, _, st1 = step(0, s0)
    _, h2, _ = step(1, st1)
    _, h2b, _ = step(1, s0 + 7)
    assert not torch.allclose(h2.re.float(), h2b.re.float())
    _, h2c, _ = step(1, st1)
    assert torch.equal(h2.re, h2c.re)


def test_kernel_seed_and_state_follow_the_jax_step():
    """The kernel seed is the JAX step's int32 arithmetic, wrap-around
    included (stream.py:276-278, 359-360); the next state its f32 formula."""
    for seed, i, state in ((0, 0, 0), (7, 3, 65535), (123, 30000, 51234), (2 ** 30, 1, 9)):
        want = (jnp.asarray(seed + i * 65537, jnp.int32)
                + jnp.asarray(state, jnp.int32) * jnp.asarray(2654435761 % (2 ** 31), jnp.int32))
        got = S.kernel_seed(seed, i, torch.tensor(state, dtype=torch.int32))
        assert got.dtype == torch.int32 and int(got) == int(want)
    chk = np.array([1.25, -3.5, 1000.75, 0.0625], np.float32)
    want = jnp.mod(jnp.abs(jnp.sum(jnp.asarray(chk))) * 1e3, 65536.0).astype(jnp.int32)
    assert int(S.next_state(torch.tensor(chk))) == int(want)


def _raw_out(detected, evm_sums):
    n = len(detected)
    h = torch.ones(53, n)
    return {"detected": torch.tensor(detected), "start": torch.full((n,), 97, dtype=torch.int32),
            "evm_sums": torch.tensor(evm_sums, dtype=torch.float32),
            "h_mmse": S.Cplx(h, torch.zeros(53, n))}


def test_raw_summary_is_over_detected_streams():
    """EVM over detected streams only (an undetected stream is equalized
    against noise); a batch with none detected reports NaN, not the JAX
    step's clamped 0 (stream.py:289,329)."""
    offs = torch.full((4,), 100, dtype=torch.int32)
    h = S.Cplx(torch.ones(53, 4), torch.zeros(53, 4))
    s = S._raw_summary(_raw_out([True, True, False, True], [2.0, 4.0, 1e6, 6.0]), offs, h, 2.0)
    assert float(s["detect_rate"]) == 0.75 and float(s["timing_in_band_rate"]) == 1.0
    assert float(s["evm_rms"]) == pytest.approx(np.sqrt(4.0 / 2.0))
    assert float(s["h_mmse_mag_nmse"]) == 0.0
    none = S._raw_summary(_raw_out([False] * 4, [1.0] * 4), offs, h, 2.0)
    assert float(none["detect_rate"]) == 0.0 and np.isnan(float(none["evm_rms"]))


def test_step_checks_its_arguments():
    with pytest.raises(ValueError, match="gen must be"):
        S.make_device_stream_step(B, gen="host", device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        S.make_device_stream_step(100, device="cpu")


# -- the upstream's Monte Carlo: the CFO, the MMSE blend and an SNR cycle ----------------------

SWEEP = (40.0, 10.0)
MC = dict(snr_db=SWEEP, gen="kernel_raw", channel_model="A", cfo_khz=20.0,
          equalize_with="h_mmse")


@pytest.fixture(scope="module")
def swept():
    """Two chained kernel_raw steps of the upstream's deployment, with the
    program's spans on: each step's (input state, output, counters)."""
    from tpu80211_torch.utils import spans

    step, st = S.make_device_stream_step(B, seed=11, sample=8, device="cpu", **MC)
    spans.clear()
    spans.enable()
    try:
        steps = []
        for i in range(2):
            before = spans.counters.snapshot()
            out = step(i, st)
            after = spans.counters.snapshot()
            steps.append((st, out, {k: v - before.get(k, 0) for k, v in after.items()}))
            st = out[2]
        return steps, spans.records()
    finally:
        spans.disable()


def test_kernel_raw_sweep_with_cfo_is_the_plain_system(swept):
    """Batch i is ``gen_raw_plain`` called by hand at the batch's
    `kernel_seed` and at SNR SWEEP[i mod 2], with the deployment's CFO and
    the MMSE blend: the summary, the sample and the next state, bit for bit.
    The CFO is drawn and found."""
    from tpu80211_torch.datasets.loader import load_capture
    from tpu80211_torch.kernels import fused_chain as F
    from tpu80211_torch.kernels import raw_gen_chain as RG
    from tpu80211_torch.ops.detect import lts_time_symbol

    cap = load_capture()

    def planes(x):
        x = np.asarray(x)
        return S.Cplx(*(torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
                        for v in (x.real, x.imag)))

    txs, tpre = F.tx_spectra(planes(cap.tx_packet), planes(cap.tx_lptot))
    lts = planes(lts_time_symbol(cap.tx_lptot).numpy())
    blocks = [t[:, :C.N_BLOCKS].double() for t in txs]
    evm_den = float((blocks[0] ** 2 + blocks[1] ** 2).sum())
    for i, (st, (summary, sample_h, nxt), _) in enumerate(swept[0]):
        want = RG.gen_raw_plain(S.kernel_seed(11, i, st), B, txs, tpre, lts, snr_db=SWEEP[i],
                                channel_model="A", cfo_khz=20.0, equalize_with="h_mmse")
        ws = S._raw_summary(want, want["offsets"], want["h_true"], evm_den)
        assert set(summary) == set(ws)
        for k, v in ws.items():
            assert torch.equal(summary[k], v), (i, k)
        assert torch.equal(sample_h.re, want["h_mmse"].re[:, :8])
        assert torch.equal(sample_h.im, want["h_mmse"].im[:, :8])
        assert torch.equal(nxt, S.next_state(want["checksum"]))
        assert float(want["cfo_true"].abs().max()) > 5e-4   # up to 1e-3 cycles a sample
    (_, (top, _, _), _), (_, (low, _, _), _) = swept[0]
    assert float(top["detect_rate"]) == 1.0 and float(top["evm_rms"]) < 0.1
    assert float(low["evm_rms"]) > float(top["evm_rms"])


def test_stream_step_spans_and_counts(swept):
    """Each step is one ``entry.stream_step`` span holding ``seed``, the
    generator's ``entry.gen_raw_system`` and ``summary``, and counts one
    ``call.stream_step`` and one ``call.gen_raw_system``."""
    steps, recs = swept
    for _, _, counts in steps:
        assert counts.get("call.stream_step") == 1 and counts.get("call.gen_raw_system") == 1
    tops = [r for r in recs if r.name == "entry.stream_step"]
    assert len(tops) == 2 and all(r.parent is None for r in tops)
    for top in tops:
        inside = [r for r in recs if r.call_id == top.call_id and r.parent == top.name]
        assert [r.name for r in inside] == ["seed", "entry.gen_raw_system", "summary"]
        assert all(top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns for r in inside)


@pytest.mark.parametrize("gen", ["kernel", "kernel_raw"])
def test_resume_under_an_snr_cycle_is_bit_deterministic(tmp_path, gen):
    """With an SNR cycle a batch's SNR is a function of its index: the
    batches after the resume boundary equal an uninterrupted run's, bit for
    bit, and each record names its SNR."""
    kw = dict(snr_db=[40.0, 10.0], gen=gen, channel_model="A")
    if gen == "kernel_raw":
        kw.update(cfo_khz=20.0, equalize_with="h_mmse")
    _run(tmp_path, "whole", 3, **kw)
    _run(tmp_path, "resumed", 1, **kw)
    res, _ = _run(tmp_path, "resumed", 3, **kw)
    assert res["frames"] == 2 * B
    for i in (1, 2):
        a = np.load(tmp_path / "whole" / f"stream_{i:06d}.npz")
        b = np.load(tmp_path / "resumed" / f"stream_{i:06d}.npz")
        assert set(a.files) == set(b.files) and float(a["snr_db"]) == (40.0, 10.0)[i % 2]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_sweep_and_cfo_arguments_are_checked():
    assert S.snr_cycle(30) == (30.0,) and S.snr_cycle(np.array([0, 10])) == (0.0, 10.0)
    for gen in ("kernel", "xla", "raw"):
        with pytest.raises(ValueError, match="kernel_raw"):
            S.make_device_stream_step(B, gen=gen, cfo_khz=20.0, device="cpu")
        with pytest.raises(ValueError, match="kernel_raw"):
            S.make_device_stream_step(B, gen=gen, equalize_with="h_mmse", device="cpu")
    for bad in ([], [10.0, float("nan")], float("inf")):
        with pytest.raises(ValueError, match="snr_db"):
            S.make_device_stream_step(B, snr_db=bad, gen="kernel_raw", device="cpu")
    with pytest.raises(ValueError, match="cfo_khz"):
        S.make_device_stream_step(B, gen="kernel_raw", cfo_khz=-1.0, device="cpu")
    with pytest.raises(ValueError, match="equalize_with"):
        S.make_device_stream_step(B, gen="kernel_raw", equalize_with="h_best", device="cpu")
