"""The port's packet detection against the JAX package, on the CPU.

ops/detect.py (batch-major, complex) is held against tpu80211.ops.detect;
kernels/detect_kernel.py's plain lane-major versions (which the CPU takes)
against the JAX kernel's own core, ``_detect_core``, called directly: it is
plain jnp, so decimated detection has a CPU oracle.  The CUDA kernels are
held against the plain versions in test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.cplx import Cplx as JCplx
from tpu80211.kernels import detect_kernel as JD
from tpu80211.ops import detect as jdet
from tpu80211_torch import convert
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import detect_kernel as TD
from tpu80211_torch.ops import detect

from _torch_inputs import lts_taps, make_streams, rel

NS = 2048
DTYPES = {"f32": (jnp.float32, torch.complex64), "f64": (jnp.float64, torch.complex128)}
# metric and matched filter: f64 agrees to rounding; in f32 the metric's
# cumulative sums run over 2,000 samples (1e-5 of the peak M ≈ 1), the
# matched filter's 64 taps to f32 rounding
OPS_TOL = {"f32": (3e-5, 1e-5), "f64": (1e-11, 1e-12)}


@pytest.fixture(scope="module")
def capture_streams():
    """16 batch-major streams with the capture's frame over 0.002 AWGN
    (tests/test_detect.py:65-79), and their offsets."""
    return make_streams(seed=0, b=16, noise=0.002)


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return JCplx.from_complex(x, jdt), torch.tensor(x).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_detect_matches_jax(capture_streams, dtype):
    x, offs = capture_streams
    jx, tx = _both(x, dtype)
    jh, th = _both(lts_taps(), dtype)
    m_tol, mf_tol = OPS_TOL[dtype]
    assert rel(detect.autocorr_metric(tx).numpy(), np.asarray(jdet.autocorr_metric(jx))) < m_tol
    assert rel(detect.matched_filter(tx, th).numpy(),
               np.asarray(jdet.matched_filter(jx, jh))) < mf_tol
    got, want = detect.detect_packet(tx, th), jdet.detect_packet(jx, jh)
    for k in ("detected", "coarse", "start"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert rel(got["metric"].numpy(), np.asarray(want["metric"])) < m_tol
    assert got["detected"].all()
    err = got["start"].numpy() - offs
    assert (err >= -4).all() and (err <= 0).all(), err  # tests/test_detect.py:79


def test_extract_packet_matches_jax(capture_streams):
    x, _ = capture_streams
    jx, tx = _both(x, "f64")
    start = torch.tensor([-1, 0, 700, NS - 1360, NS] + [100] * 11)
    lp, pkt = detect.extract_packet(tx, start)
    jlp, jpkt = jdet.extract_packet(jx, jnp.asarray(start.numpy()))
    np.testing.assert_array_equal(lp.numpy(), jlp.to_complex())
    np.testing.assert_array_equal(pkt.numpy(), jpkt.to_complex())


def test_no_false_alarm_on_noise():
    """tests/test_detect.py:82-90: noise alone is never detected, and the
    indices are the −1 sentinels."""
    rng = np.random.default_rng(3)
    x = torch.tensor((rng.standard_normal((8, NS)) + 1j * rng.standard_normal((8, NS))) * 0.002)
    res = detect.detect_packet(x, torch.tensor(lts_taps()).to(torch.complex128))
    assert not res["detected"].any()
    assert (res["coarse"] == -1).all() and (res["start"] == -1).all()


def test_lts_time_symbol():
    lp = torch.arange(160, dtype=torch.float32).to(torch.complex64)
    assert torch.equal(detect.lts_time_symbol(lp), lp[-64:])
    np.testing.assert_array_equal(detect.lts_time_symbol(lp).numpy(),
                                  jdet.lts_time_symbol(lp.numpy()).to_complex())


# -- the lane-major plain versions against _detect_core ----------------------------

B = 16
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
CORE_CASES = [("f32", False), ("f32", 16), ("f32", 32), ("f32", 64),
              ("bf16", False), ("bf16", 16), ("int8", False), ("int8", 32)]


@functools.lru_cache(maxsize=None)
def _lane_streams(storage: str):
    """B lane-major (NS, B) streams in the storage dtype (3 of noise only);
    int8 streams are ADC words of the same samples.  Returns (Cplx, offsets)."""
    x, offs = make_streams(seed=4, b=B, n_empty=3)
    re, im = (torch.tensor(np.ascontiguousarray(v.T), dtype=torch.float32) for v in (x.real, x.imag))
    if storage == "int8":
        lsb = max(float(re.abs().max()), float(im.abs().max())) / 127
        re, im = (torch.clamp(torch.round(v / lsb), -127, 127) for v in (re, im))
    return Cplx(re.to(STORAGE[storage]), im.to(STORAGE[storage])), offs


def _taps():
    h = lts_taps()
    return Cplx(torch.tensor(h.real.copy()), torch.tensor(h.imag.copy()))


@pytest.mark.parametrize("storage,decimate", CORE_CASES)
def test_detect_plain_matches_detect_core(storage, decimate):
    """bf16 and int8 streams are held against _detect_core on their f32
    upcast, which is what the TPU kernel computes (detect_kernel.py:271-272),
    not against the CPU fallback, which runs detect_packet in bf16."""
    x, offs = _lane_streams(storage)
    h = _taps()
    wrr, wri = JD._mf_bands((tuple(map(float, h.re)), tuple(map(float, h.im))))
    det, coarse, start, metric = JD._detect_core(
        jnp.asarray(x.re.to(torch.float32).numpy()), jnp.asarray(x.im.to(torch.float32).numpy()),
        jnp.asarray(wrr), jnp.asarray(wri), ns=NS, threshold=0.5, search=192, advance=4,
        decimate=decimate)
    det = np.asarray(det[0]) > 0
    got = TD.detect_plain(x, h, decimate=decimate)
    np.testing.assert_array_equal(got.detected.numpy(), det)
    np.testing.assert_array_equal(got.coarse.numpy(), np.where(det, np.asarray(coarse[0]), -1))
    np.testing.assert_array_equal(got.start.numpy(), np.where(det, np.asarray(start[0]), -1))
    # the port sums in f64, _detect_core in f32: 1e-6 of the peak metric
    assert rel(got.metric.numpy(), np.asarray(metric[0])) < 1e-6
    assert got.start.dtype == torch.int32 and got.metric.dtype == torch.float32
    # the frames are found where they are; the noise-only streams are not
    assert got.detected[:B - 3].all() and not got.detected[B - 3:].any()
    err = got.start.numpy()[:B - 3] - offs[:B - 3]
    assert (err >= -4).all() and (err <= -2).all(), err


@pytest.mark.parametrize("decimate", [False, 16])
def test_detect_plain_at_the_least_length_matches_detect_core(decimate):
    """NS = 1,408, the least multiple of 64 that holds the 1,360-row frame,
    with the frames at offsets 8–47 (all but the last 48 rows are frame):
    the plain detection is _detect_core's, index for index."""
    ns = TD.MIN_NS
    assert ns == 1408
    xb, offs = make_streams(seed=9, b=B, ns=ns, offs_range=(8, 48))
    x = Cplx(*(torch.tensor(np.ascontiguousarray(v.T), dtype=torch.float32)
               for v in (xb.real, xb.imag)))
    h = _taps()
    wrr, wri = JD._mf_bands((tuple(map(float, h.re)), tuple(map(float, h.im))))
    det, coarse, start, metric = JD._detect_core(
        jnp.asarray(x.re.numpy()), jnp.asarray(x.im.numpy()), jnp.asarray(wrr), jnp.asarray(wri),
        ns=ns, threshold=0.5, search=192, advance=4, decimate=decimate)
    det = np.asarray(det[0]) > 0
    got = TD.detect_plain(x, h, decimate=decimate)
    np.testing.assert_array_equal(got.detected.numpy(), det)
    np.testing.assert_array_equal(got.coarse.numpy(), np.where(det, np.asarray(coarse[0]), -1))
    np.testing.assert_array_equal(got.start.numpy(), np.where(det, np.asarray(start[0]), -1))
    assert rel(got.metric.numpy(), np.asarray(metric[0])) < 1e-6
    assert got.detected.all()
    err = got.start.numpy() - offs
    assert (err >= -4).all() and (err <= -2).all(), err
    with pytest.raises(ValueError, match="at least 1408"):
        TD.detect_plain(x.map(lambda t: t[:1344].contiguous()), h)


def test_mf_taps_equal_mf_bands():
    h = _taps()
    wrr, wri = JD._mf_bands((tuple(map(float, h.re)), tuple(map(float, h.im))))
    got = TD.mf_taps(h)
    assert torch.equal(got.re, torch.tensor(wrr)) and torch.equal(got.im, torch.tensor(wri))
    carried = convert.mf_taps(wrr, wri, device="cpu")
    assert torch.equal(carried.re, got.re) and torch.equal(carried.im, got.im)
    lts = convert.lts_ref(h.re.numpy(), h.im.numpy(), device="cpu")
    assert torch.equal(lts.re, h.re) and lts.re.dtype == torch.float32


@pytest.mark.parametrize("storage", list(STORAGE))
def test_detect_and_align_cuts_the_stream(storage):
    """The aligned planes are the stream's rows from each start on, bit for
    bit in the storage dtype; undetected streams are cut at row 0."""
    x, _ = _lane_streams(storage)
    det, lp, pkt = TD.detect_and_align(x, _taps())
    assert lp.re.dtype == x.re.dtype and tuple(pkt.im.shape) == (1200, B)
    s = torch.where(det["detected"], det["start"], 0).clamp(0, NS - 1360)
    for lane in range(B):
        rows = slice(int(s[lane]), int(s[lane]) + 1360)
        frame = torch.cat([lp.re[:, lane], pkt.re[:, lane]]), torch.cat([lp.im[:, lane], pkt.im[:, lane]])
        assert torch.equal(frame[0], x.re[rows, lane]) and torch.equal(frame[1], x.im[rows, lane])
    want = TD.detect_plain(x, _taps())
    for k in ("detected", "coarse", "start", "metric"):
        assert torch.equal(det[k], getattr(want, k)), k
    assert TD.detect_streams(x, _taps()).keys() == det.keys()


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_place_streams_matches_jax(dtype):
    jdt, tdt = dtype
    rng = np.random.default_rng(8)
    sig, noise = rng.standard_normal((2, 256, 12)), rng.standard_normal((2, 256, 12)) * 0.1
    offs = rng.integers(0, 256, 12)
    jc = lambda a: JCplx(jnp.asarray(a[0], jdt), jnp.asarray(a[1], jdt))  # noqa: E731
    tc = lambda a: Cplx(torch.tensor(a[0]).to(tdt), torch.tensor(a[1]).to(tdt))  # noqa: E731
    want = JD.place_streams(jc(sig), jc(noise), jnp.asarray(offs, jnp.int32))
    got = TD.place_streams(tc(sig), tc(noise), torch.tensor(offs, dtype=torch.int32))
    assert got.re.dtype == tdt
    for g, w in zip(got, (want.re, want.im)):
        np.testing.assert_array_equal(g.to(torch.float32).numpy(), np.asarray(w, np.float32))
    # the definition, on the f32 planes
    if tdt == torch.float32:
        r = (np.arange(256)[:, None] - offs[None, :]) % 256
        np.testing.assert_allclose(got.re.numpy(), np.take_along_axis(sig[0], r, 0) + noise[0],
                                   rtol=1e-6, atol=1e-6)


def test_ragged_batch_and_rejections():
    """Any B runs (13 here, no multiple of a block); wrong inputs raise."""
    x, _ = _lane_streams("f32")
    part = x.map(lambda t: t[:, :13].contiguous())
    got = TD.detect_streams(part, _taps(), decimate=32)
    want = TD.detect_plain(x, _taps(), decimate=32)
    assert torch.equal(got["start"], want.start[:13])
    with pytest.raises(ValueError, match="multiple of 64"):
        TD.detect_streams(x.map(lambda t: t[:2000].contiguous()), _taps())
    with pytest.raises(ValueError, match="decimate"):
        TD.detect_streams(x, _taps(), decimate=48)
    with pytest.raises(ValueError, match="offs"):
        TD.place_streams(x, x, torch.full((B,), NS, dtype=torch.int32))
    with pytest.raises(TypeError):
        TD.detect_streams(x.map(lambda t: t.to(torch.float16)), _taps())


def test_wrappers_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: on a device that
    is not CUDA, the wrappers raise instead of running the plain versions."""
    x, _ = _lane_streams("f32")
    meta = x.map(lambda t: t.to("meta"))
    taps = _taps().map(lambda t: t.to("meta"))
    for call in (lambda: TD.detect_streams(meta, taps), lambda: TD.detect_and_align(meta, taps)):
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            call()
