"""The port's host stream against the JAX package's: the native engine's
arrays bit for bit, ``run_stream``'s shards, resume and skipped batches, and
``native_time_batches`` into the fused chain.  The native library is built
with ``make -C native`` at first use; its tests skip where it does not
build."""

import json

import jax
import numpy as np
import pytest
import torch

from tpu80211 import constants as JC
from tpu80211.datasets import native_engine as jne
from tpu80211.kernels.fused_chain import fused_rx_chain as jax_fused_rx_chain
from tpu80211.pipeline import stream as JS
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets import native_engine as ne
from tpu80211_torch.datasets import synthetic_sc
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels.fused_chain import fused_rx_chain
from tpu80211_torch.pipeline import stream as S

from _torch_inputs import TOL, jax_planes, rel, to_np


@pytest.fixture
def native():
    if not ne.available():
        pytest.skip("the native data engine does not build here (make -C native)")


# -- the native engine: the JAX wrapper's arrays, bit for bit ---------------------------


@pytest.mark.parametrize("time_domain", [False, True])
def test_native_generate_bit_equal_to_jax(time_domain, native):
    kw = dict(seed=7, frame0=48, snr_db=25.0, fo_hz=3e3, time_domain=time_domain)
    got, want = ne.generate(16, **kw), jne.generate(16, **kw)
    if time_domain:
        (got, got_t), (want, want_t) = got, want
        assert got_t._fields == want_t._fields
        for g, w in zip(got_t, want_t):
            assert g.re.shape == (16, w.re.shape[1]) and g.re.dtype == torch.float32
            np.testing.assert_array_equal(g.re.numpy(), np.asarray(w.re))
            np.testing.assert_array_equal(g.im.numpy(), np.asarray(w.im))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert isinstance(g, torch.Tensor), name
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_native_generate_is_deterministic_per_frame(native):
    a = ne.generate(64, seed=11, threads=1)
    b = ne.generate(64, seed=11, threads=8)
    assert torch.equal(a.rx_symb, b.rx_symb) and torch.equal(a.h_true, b.h_true)
    tail = ne.generate(32, seed=11, frame0=32)
    assert torch.equal(a.rx_symb[32:], tail.rx_symb)
    assert not torch.equal(a.rx_symb, ne.generate(64, seed=12).rx_symb)


# -- run_stream: persistence, resume, skipped batches (tests/test_stream.py:11-36) -----


def test_run_stream_persists(tmp_path):
    out_dir = tmp_path / "shards"
    res = S.run_stream(S.synthetic_batches(3, batch=4), out_dir=str(out_dir), device="cpu")
    assert res == {"frames": 12, "batches": 3, "out_dir": str(out_dir)}
    files = sorted(out_dir.glob("h_est_*.npz"))
    assert len(files) == 3
    d = np.load(files[0])
    assert sorted(d.files) == sorted(S._STREAM_ESTS)
    assert d["h_mmse"].shape == (4, JC.N_SC) and d["h_mmse"].dtype == np.complex64
    assert np.isfinite(d["h_mmse"]).all()
    assert json.loads((out_dir / "cursor.json").read_text())["done"] == [0, 1, 2]


def test_run_stream_resumes_and_skips_done(tmp_path):
    """A stream of 2 batches, run again with 4, runs batches 2 and 3 only;
    its shards equal those of an uninterrupted run of 4."""
    out_dir, whole = tmp_path / "shards", tmp_path / "whole"
    S.run_stream(S.synthetic_batches(2, batch=4), out_dir=str(out_dir), device="cpu")
    res = S.run_stream(S.synthetic_batches(4, batch=4), out_dir=str(out_dir), resume=True,
                       device="cpu")
    assert res["batches"] == 2 and res["frames"] == 8
    assert len(list(out_dir.glob("h_est_*.npz"))) == 4
    S.run_stream(S.synthetic_batches(4, batch=4), out_dir=str(whole), device="cpu")
    for i in range(4):
        a, b = (np.load(d / f"h_est_{i:06d}.npz") for d in (out_dir, whole))
        for k in S._STREAM_ESTS:
            np.testing.assert_array_equal(a[k], b[k])
    again = S.run_stream(S.synthetic_batches(4, batch=4), out_dir=str(out_dir), device="cpu")
    assert again["batches"] == 0 and again["frames"] == 0
    fresh = S.run_stream(S.synthetic_batches(2, batch=4), out_dir=str(out_dir), resume=False,
                         device="cpu")
    assert fresh["batches"] == 2


def test_run_stream_without_out_dir_and_with_a_custom_fn():
    seen = []

    def fn(*args):
        seen.append(args[0].shape)
        from tpu80211_torch.pipeline import sc
        return sc.rx_chain_freq(*args)

    res = S.run_stream(S.synthetic_batches(3, batch=5), fn=fn, device="cpu")
    assert res == {"frames": 15, "batches": 3, "out_dir": None}
    assert seen == [torch.Size([5, JC.N_SC])] * 3


def test_run_stream_shards_match_jax_on_the_native_engine(tmp_path, native):
    """The same native batches through the port's ``run_stream`` and the
    JAX package's: every shard within 1e-5 (complex64 against the JAX
    package's f32 split-complex chain; ~5e-7 seen)."""
    port = S.run_stream(S.synthetic_batches(3, 16, seed=5, engine="native"),
                        out_dir=str(tmp_path / "port"), device="cpu")
    ref = JS.run_stream(JS.synthetic_batches(3, 16, seed=5, engine="native"),
                        out_dir=str(tmp_path / "jax"))
    assert (port["frames"], port["batches"]) == (ref["frames"], ref["batches"]) == (48, 3)
    for i in range(3):
        a, b = (np.load(tmp_path / d / f"h_est_{i:06d}.npz") for d in ("port", "jax"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape
            assert float(np.abs(a[k] - b[k]).max()) <= 1e-5, (i, k)


def test_synthetic_batches_engines():
    """``torch``: a CPU generator seeded with seed + i per batch; argument
    order and types are ``sc.rx_chain_freq``'s; an unknown engine raises."""
    from tpu80211_torch.datasets import synthetic

    b0, b1 = S.synthetic_batches(2, 6, seed=3, snr_db=30.0)
    want = synthetic.generate(torch.Generator().manual_seed(4), 6, snr_db=30.0)
    for got, w in zip(b1, (want.tx_preamble_fft, want.rx_preamble_fft, want.tx_symb,
                           want.rx_symb, want.ow2)):
        assert torch.equal(got, w)
    assert b0[2].shape == (6, JC.N_BLOCKS, JC.N_SC) and b0[2].dtype == torch.complex64
    assert b0[4].dtype == torch.float32 and b0[4].device.type == "cpu"
    with pytest.raises(ValueError, match="engine"):
        next(S.synthetic_batches(1, 4, engine="jax"))


def test_native_batches_are_the_engines_frames(native):
    (args,) = list(S.synthetic_batches(1, 8, seed=2, snr_db=35.0, engine="native"))
    fb = ne.generate(8, seed=2, snr_db=35.0)
    for got, want in zip(args, (fb.tx_preamble_fft, fb.rx_preamble_fft, fb.tx_symb,
                                fb.rx_symb, fb.ow2)):
        assert torch.equal(got, want)
    _, second = S.synthetic_batches(2, 8, seed=2, snr_db=35.0, engine="native")
    assert torch.equal(second[3], ne.generate(8, seed=2, frame0=8, snr_db=35.0).rx_symb)


def test_native_time_batches_into_fused_chain_match_jax(native):
    """``native_time_batches`` into the port's ``fused_rx_chain`` (the plain
    version on the CPU) and the same planes into the JAX ``fused_rx_chain``
    (interpret mode), B=8: f32 tolerances of tests/_torch_inputs.py."""
    (args,) = list(S.native_time_batches(1, 8, seed=9))
    assert all(isinstance(c, Cplx) and c.re.shape[0] == 8 for c in args)
    assert args[0].re.shape == (8, JC.PACKET_SAMPLES) and args[2].re.shape == (8, 160)
    got = fused_rx_chain(*args)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jax_fused_rx_chain(*(jax_planes(c.to_complex().numpy()) for c in args))
    for name in ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline", "h_wiener", "h_mmse", "eq"):
        tol = TOL["f32"]["eq" if name == "eq" else "h_mmse" if name == "h_mmse" else "h"]
        assert rel(to_np(got[name]), to_np(want[name])) <= tol, name
    assert rel(to_np(got["ow2"]), to_np(want["ow2"])) <= 1e-5


# -- the placement's offset check --------------------------------------------------------


def test_place_rejects_offsets_out_of_range_on_the_cpu():
    sig = Cplx(torch.zeros(64, 3), torch.zeros(64, 3))
    for bad in (torch.tensor([0, 64, 1], dtype=torch.int32), torch.tensor([-1, 0, 0])):
        with pytest.raises(ValueError, match=r"offs must lie in \[0, 64\)"):
            D.place_plain(sig, sig, bad)
        with pytest.raises(ValueError, match="offs"):
            D.place_streams(sig, sig, bad)
    D.place_streams(sig, sig, torch.tensor([0, 63, 5], dtype=torch.int32))


def test_raw_draws_make_offsets_in_range():
    """The raw generator draws its offsets in range, so the placement needs
    no host read of them; a negative earliest offset is refused where the
    offsets are drawn."""
    d = synthetic_sc.raw_draws(torch.Generator().manual_seed(1), 512, ns=1408, min_off=20)
    assert int(d.offsets.min()) >= 20 and int(d.offsets.max()) < 1408 - 1360
    with pytest.raises(ValueError, match="min_off"):
        synthetic_sc.raw_draws(torch.Generator(), 4, min_off=-1)
