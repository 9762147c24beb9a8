"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu80211_torch.bench import quality as Q
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets import native_engine
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import gen_chain as G
from tpu80211_torch.kernels import mmse_solve as M
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.kernels import raw_gen_chain as RG
from tpu80211_torch.datasets import synthetic
from tpu80211_torch.models import ps_mmse
from tpu80211_torch.parallel import mesh as PM
from tpu80211_torch.parallel import multihost
from tpu80211_torch.ops import channel
from tpu80211_torch.pipeline import raw as P
from tpu80211_torch.pipeline import rx as RX
from tpu80211_torch.pipeline import sc as SCH
from tpu80211_torch.pipeline import stream as S
from tpu80211_torch.utils import spans, timing

from _torch_inputs import (TOL, assert_matches, lane_major, lts_taps, make_frames, make_streams,
                           rel, to_np, torch_planes, with_cfo)

B = 1000  # ragged: no multiple of the kernels' 32 frames per block
NS = 2048
EPS = 1e-3  # a 20 kHz CFO at 20 MS/s
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.float32}
RAW_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
CASES = {
    "txconst-f32": dict(mode="txconst", dtype="f32"),
    "txconst-bf16": dict(mode="txconst", dtype="bf16"),
    "txconst-int8": dict(mode="txconst", dtype="int8"),
    "txconst-serve": dict(mode="txconst", dtype="bf16", serve=True),
    "txconst-eps": dict(mode="txconst", dtype="f32", eps=0.01),
    "txconst-eq-wiener": dict(mode="txconst", dtype="f32", equalize_with="h_wiener"),
    "txconst-eq-mmse": dict(mode="txconst", dtype="bf16", equalize_with="h_mmse"),
    "txconst-wiener-prior": dict(mode="txconst", dtype="f32", wiener=("E", 5.0)),
    "per-frame-f32": dict(mode="frames", dtype="f32"),
    "per-frame-bf16": dict(mode="frames", dtype="bf16", eps=-0.02),
    "txconst-f32-sync": dict(mode="txconst", dtype="f32", sync=True),
    "txconst-bf16-sync-evm": dict(mode="txconst", dtype="bf16", sync=True, evm_sums=True),
    "txconst-int8-sync-evm": dict(mode="txconst", dtype="int8", sync=True, evm_sums=True),
    "txconst-f32-evm": dict(mode="txconst", dtype="f32", evm_sums=True, equalize_with="h_mmse"),
    "per-frame-f32-sync": dict(mode="frames", dtype="f32", sync=True),
    "per-frame-bf16-sync-evm": dict(mode="frames", dtype="bf16", sync=True, evm_sums=True),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames():
    """Per-frame-tx and tx-constant frames, each with a 20 kHz CFO."""
    return (with_cfo(make_frames(seed=5, b=B), EPS),
            with_cfo(make_frames(seed=6, b=B, tx_const=True), EPS))


def launched(kernel: str) -> int:
    """Launches of ``kernel`` so far, from the program's counters."""
    return spans.counters.snapshot().get(f"launch.{kernel}", 0)


def _on(x, dtype, dev) -> Cplx:
    return torch_planes(lane_major(x), dtype).map(lambda t: t.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(case, frames, dev):
    kw = dict(CASES[case])
    mode, dtype = kw.pop("mode"), kw.pop("dtype")
    consts = F.chain_consts(dev, *kw.pop("wiener", (None, None)))
    tx_pkt, rx_pkt, tx_lp, rx_lp = frames[mode == "txconst"]
    rp, rl = _on(rx_pkt, STORAGE[dtype], dev), _on(rx_lp, STORAGE[dtype], dev)
    if mode == "txconst":
        tx = F.tx_spectra(_on(tx_pkt[:1], torch.float32, dev).map(lambda t: t[:, 0]),
                          _on(tx_lp[:1], torch.float32, dev).map(lambda t: t[:, 0]))
        if dtype == "int8":
            rp, lsb = F.quantize_i8(rp)
            rl, _ = F.quantize_i8(rl, lsb)
            kw["lsb"] = float(lsb)
    else:
        tx = F.TxFrames(_on(tx_pkt, STORAGE[dtype], dev), _on(tx_lp, STORAGE[dtype], dev))
    before = launched("fused_chain")
    got = F.fused_chain(rp, rl, tx, consts, **kw)
    torch.cuda.synchronize()
    assert launched("fused_chain") == before + 1
    want = F.fused_chain_plain(rp, rl, tx, consts, **kw)
    assert_matches(got, want, B, TOL[dtype])
    if kw.get("sync"):
        # tests/test_cfo.py:47's 2% on float samples; 8-bit words of the
        # batch's full scale add quantization noise to the LTS correlation
        # (3.3% measured on the card)
        bound = 5e-2 if dtype == "int8" else 2e-2
        assert float((got["cfo"] - EPS).abs().max()) < bound * EPS


@pytest.mark.cuda
def test_batch_major_entry_matches_plain(frames, dev):
    """The batch-major public entry launches the kernel once and agrees
    with the plain version."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = frames[0]
    before = launched("fused_chain")
    got = F.fused_rx_chain(*(torch_planes(x).map(lambda t: t.to(dev))
                             for x in (tx_pkt, rx_pkt, tx_lp, rx_lp)), sync=True)
    want = F.fused_chain_plain(_on(rx_pkt, torch.float32, dev), _on(rx_lp, torch.float32, dev),
                               F.TxFrames(_on(tx_pkt, torch.float32, dev),
                                          _on(tx_lp, torch.float32, dev)),
                               F.chain_consts(dev), sync=True)
    assert launched("fused_chain") == before + 1
    lane = {k: v if v is None or k in ("ow2", "cfo", "checksum") else
            v.map(lambda t: t.permute(1, 2, 0) if t.dim() == 3 else t.T) for k, v in got.items()}
    assert_matches(lane, want, B, TOL["f32"])


def _chain_inputs(frames, b: int, mode: str, dev, dtype: str = "bf16"):
    """The first b of test_kernel_matches_plain's frames on the card: (rx
    packet, rx preamble, tx, keyword arguments) for tx-constant (``mode``
    "txconst") or per-frame tx; int8 samples are ADC words with their step
    (``lsb``)."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = (x[:b] for x in frames[mode == "txconst"])
    rp, rl = _on(rx_pkt, STORAGE[dtype], dev), _on(rx_lp, STORAGE[dtype], dev)
    kw = {}
    if dtype == "int8":
        rp, lsb = F.quantize_i8(rp)
        rl, _ = F.quantize_i8(rl, lsb)
        kw["lsb"] = float(lsb)
    if mode == "txconst":
        tx = F.tx_spectra(_on(tx_pkt[:1], torch.float32, dev).map(lambda t: t[:, 0]),
                          _on(tx_lp[:1], torch.float32, dev).map(lambda t: t[:, 0]))
    else:
        tx = F.TxFrames(_on(tx_pkt, STORAGE[dtype], dev), _on(tx_lp, STORAGE[dtype], dev))
    return rp, rl, tx, kw


RING_CASES = {
    "txconst-bf16": dict(mode="txconst"),
    "per-frame-bf16": dict(mode="frames"),
    "txconst-int8": dict(mode="txconst", dtype="int8"),
    "txconst-bf16-sync": dict(mode="txconst", sync=True),
    "txconst-int8-sync-evm": dict(mode="txconst", dtype="int8", sync=True, evm_sums=True),
    "per-frame-bf16-sync-evm": dict(mode="frames", sync=True, evm_sums=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("b", [32, 33, 48, 1000])
def test_chain_window_ring_at_ragged_batches(b, case, frames, dev):
    """The windows' staging in runs of 8 frames (cp.async for bf16 without
    sync, through registers for int8 and with sync) at B = 32 (one whole
    block), 48 (a last block of 16 frames) and 1,000 (of 8), and by each
    thread at B = 33 (not a multiple of 8), on test_kernel_matches_plain's
    frames: the plain version's outputs at its tolerances.  (On frames with
    deeper fades the checksum moves by more than 1e-4 between any two f32
    summation orders: reversing the plain DFT's own order does.)"""
    kw = dict(RING_CASES[case])
    mode, dtype = kw.pop("mode"), kw.pop("dtype", "bf16")
    rp, rl, tx, extra = _chain_inputs(frames, b, mode, dev, dtype)
    kw.update(extra)
    consts = F.chain_consts(dev)
    for eq in ("h_linear", "h_mmse"):
        got = F.fused_chain(rp, rl, tx, consts, equalize_with=eq, **kw)
        torch.cuda.synchronize()
        assert_matches(got, F.fused_chain_plain(rp, rl, tx, consts, equalize_with=eq, **kw), b,
                       TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["txconst", "frames"])
def test_chain_spectra_formed_twice_give_the_same_bits(mode, frames, dev):
    """Blocks 0..3 are transformed for the estimators and again for the
    equalizer: two launches on the same frames give the same bits in every
    output, and a ragged batch's frames equal the whole batch's."""
    rp, rl, tx, _ = _chain_inputs(frames, B, mode, dev)
    consts = F.chain_consts(dev)
    one, two = (F.fused_chain(rp, rl, tx, consts, evm_sums=True) for _ in range(2))

    def cut(c: Cplx) -> Cplx:
        return c.map(lambda t: t[:, :40].contiguous())

    part = F.fused_chain(cut(rp), cut(rl), tx if mode == "txconst" else F.TxFrames(
        cut(tx.pkt), cut(tx.lp)), consts, evm_sums=True)
    torch.cuda.synchronize()
    for k, v in one.items():
        pairs = zip(v, two[k]) if isinstance(v, Cplx) else [(v, two[k])]
        for x, y in pairs:
            assert torch.equal(x, y), k
    for x, y in zip(one["eq"], part["eq"]):
        assert torch.equal(x[..., :40], y)


@pytest.mark.cuda
def test_chain_kernel_occupancy(dev):
    """The main path's kernel (bf16, tx-constant, the cp.async ring) spills
    nothing and keeps two blocks of 32 frames on an SM; its per-frame-tx
    twin keeps two as well; every other instantiation keeps at least one."""
    at = F.kernel_attributes(torch.bfloat16, tx_const=True)
    assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 2, at
    at = F.kernel_attributes(torch.bfloat16, tx_const=False)
    assert at["blocks_per_sm"] >= 2, at
    for storage in (torch.float32, torch.bfloat16, torch.int8):
        for tx_const in (True, False) if storage != torch.int8 else (True,):
            for sync in (False, True):
                for evm in (False, True):
                    for aligned in (False, True):
                        at = F.kernel_attributes(storage, tx_const, sync, evm, aligned)
                        assert at["blocks_per_sm"] >= 1, (storage, tx_const, sync, evm, aligned, at)


def _sass_by_kernel(lib: str) -> dict:
    """cuobjdump -sass of a built library: each fused_chain_kernel
    instantiation's mangled name → its SASS text."""
    import pathlib
    import subprocess

    from tpu80211_torch.kernels import _build
    tool = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    parts = text.split("Function : ")[1:]
    return {p.split()[0]: p for p in parts if "fused_chain_kernel" in p.split()[0]}


@pytest.mark.cuda
def test_chain_dft_runs_on_the_tensor_cores(dev):
    """The bf16 and int8 instantiations of the chain issue HMMA (bf16
    mma.sync); the f32 ones do not (their DFT stays on the CUDA cores)."""
    from tpu80211_torch.kernels import _build
    sass = _sass_by_kernel(str(_build.build(_build.CSRC / "fused_chain.cu")))
    by_type = {"bf16": [k for k in sass if "__nv_bfloat16" in k],
               "int8": [k for k in sass if "fused_chain_kernelIaL" in k],
               "f32": [k for k in sass if "fused_chain_kernelIfL" in k]}
    # bf16: 2 modes x sync x evm_sums x (runs of 8 frames or not); int8: tx-constant
    # only; f32: no runs
    assert len(by_type["bf16"]) == 16 and len(by_type["int8"]) == 8 and len(by_type["f32"]) == 8, \
        {k: len(v) for k, v in by_type.items()}
    for name in by_type["bf16"] + by_type["int8"]:
        assert "HMMA" in sass[name], name
    for name in by_type["f32"]:
        assert "HMMA" not in sass[name], name


# -- the derotation: each sync kernel against its twin built with the library's
#    sincos for every derotated sample (the body before the phase factors) -------

@pytest.fixture(scope="module")
def library_twins(tmp_path_factory):
    """(fused_chain, raw_chain) bound from builds with the chain probe's
    ``library_sincos`` edit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from concurrent.futures import ThreadPoolExecutor

    from tpu80211_torch.kernels import _variants
    from tpu80211_torch.kernels import fused_chain_variants as FV
    edits = {"twin": {FV.HEADER: FV.TREE_DIAGNOSTICS["library_sincos"]}}
    out = tmp_path_factory.mktemp("library_twins")
    with ThreadPoolExecutor(2) as pool:
        fused, raw = pool.map(lambda src: _variants.build(src, edits, out / src.stem)["twin"][0],
                              (FV.SOURCE, FV.RAW_SOURCE))
    return F.bind(fused), R.bind(raw)


def _same_bits(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in got.items():
        pairs = zip(v, want[k]) if isinstance(v, Cplx) else [(v, want[k])]
        for x, y in pairs:
            assert (x is None and y is None) or torch.equal(x, y), k


EDGE_CFO = 0.0075  # 0.96 / 128: angles up to 65 rad; the estimate wraps at 1/128
SYNC_TWIN_CASES = {
    "bf16-near-1/128": dict(dtype="bf16", cfo=EDGE_CFO),
    "int8-near-1/128": dict(dtype="int8", cfo=EDGE_CFO),
    "f32-near-1/128": dict(dtype="f32", cfo=-EDGE_CFO),
    "bf16-zero": dict(dtype="bf16", cfo=0.0),
    "int8-zero": dict(dtype="int8", cfo=0.0),
    "f32-zero": dict(dtype="f32", cfo=0.0),
    "bf16-rows-near-1/128": dict(dtype="bf16", cfo=-EDGE_CFO, b=999),
    "per-frame-bf16-near-1/128": dict(dtype="bf16", cfo=EDGE_CFO, mode="frames"),
    "per-frame-f32-zero": dict(dtype="f32", cfo=0.0, mode="frames"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SYNC_TWIN_CASES))
def test_sync_chain_equals_its_library_sincos_twin(case, library_twins, dev):
    """With sync, every output of fused_chain (h planes, eq, sigma^2, CFO,
    checksum, EVM sums) is the library twin's bit for bit: at a CFO near the
    estimate's limit of 1/128 (B = 1,000 in runs of 8 frames, derotated by
    phase factors; B = 999 and f32 samples by each thread, a library sincos
    a sample) and at a CFO estimate of exactly 0 (rx = tx: the LTS repeats
    are equal, so the correlation is real)."""
    kw = SYNC_TWIN_CASES[case]
    dtype, cfo, b, mode = kw["dtype"], kw["cfo"], kw.get("b", B), kw.get("mode", "txconst")
    frames = make_frames(seed=9, b=b, tx_const=mode == "txconst")
    if cfo == 0.0:
        tx_pkt, _, tx_lp, _ = frames
        frames = (tx_pkt, tx_pkt, tx_lp, tx_lp)
    else:
        frames = with_cfo(frames, cfo)
    rp, rl, tx, extra = _chain_inputs((frames, frames), b, mode, dev, dtype)
    args = (rp, rl, tx, F.chain_consts(dev, "A", 40.0), 0.0, extra.get("lsb", 1.0), False,
            "h_mmse", True, True)
    got = F._launch(*args)
    twin = F._launch(*args, kernel=library_twins[0])
    torch.cuda.synchronize()
    _same_bits(got, twin)
    if cfo == 0.0:
        assert bool((got["cfo"] == 0).all())
    else:
        assert float((got["cfo"] - cfo).abs().max()) < 2e-2 * abs(cfo)


@pytest.mark.cuda
def test_sync_kernels_keep_two_blocks_per_sm(dev):
    """The phases live in the second window buffer, so every sync
    instantiation of both kernels keeps two blocks of 32 frames on an SM."""
    for storage in (torch.float32, torch.bfloat16, torch.int8):
        for tx_const in (True, False) if storage != torch.int8 else (True,):
            for evm in (False, True):
                for aligned in (False, True):
                    at = F.kernel_attributes(storage, tx_const, True, evm, aligned)
                    assert at["blocks_per_sm"] >= 2, (storage, tx_const, evm, aligned, at)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for sums in (False, True):
            at = R.kernel_attributes(dtype, True, sums, decimate=16)
            assert at["blocks_per_sm"] >= 2, (dtype, sums, at)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_raw_sync_equals_its_library_sincos_twin(dtype, library_twins, dev):
    """raw_chain with sync at a CFO near 1/128, decimate 16: every output,
    detection rows included, is the library twin's bit for bit."""
    x, _, lsb = _streams(dtype, dev, cfo=EDGE_CFO)
    args = (x, _taps(dev), *_spectra(dev), None, 192, 4, 0.0, True, False, "A", 40.0, lsb,
            False, "h_mmse", 16)
    got = R._launch(*args)
    twin = R._launch(*args, kernel=library_twins[1])
    torch.cuda.synchronize()
    _same_bits(got, twin)
    assert int(got["detected"].sum()) >= B - 50


# -- detection, alignment, placement and the raw receiver -----------------------------


def _streams(dtype: str, dev, cfo: float = 0.0):
    """B lane-major raw streams on the card (the capture's frame at offsets
    in [40, NS − 1400) over 1e-4 AWGN; the last 50 of noise only), in the
    storage dtype; int8 streams are ADC words with their step.  Returns
    (streams, offsets, lsb)."""
    x, offs = make_streams(seed=21, b=B, ns=NS, n_empty=50)
    planes, lsb = _stream_planes(x * np.exp(2j * np.pi * cfo * np.arange(NS)), dtype, dev)
    return planes, offs, lsb


def _stream_planes(x: np.ndarray, dtype: str, dev):
    """Batch-major complex streams as lane-major planes on ``dev`` in the
    storage dtype (int8: ADC words of the batch's full scale).  Returns
    (Cplx, lsb)."""
    re, im = (torch.tensor(np.ascontiguousarray(v.T), dtype=torch.float32, device=dev)
              for v in (x.real, x.imag))
    lsb = 1.0
    if dtype == "int8":
        lsb = max(float(re.abs().max()), float(im.abs().max())) / 127
        re, im = (torch.clamp(torch.round(v / lsb), -127, 127) for v in (re, im))
    return Cplx(re.to(RAW_STORAGE[dtype]), im.to(RAW_STORAGE[dtype])), lsb


def _taps(dev) -> Cplx:
    h = lts_taps()
    return Cplx(torch.tensor(h.real.copy(), device=dev), torch.tensor(h.imag.copy(), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("decimate", [False, 16, 32, 64])
def test_detect_kernel_matches_plain(dtype, decimate, dev):
    x, offs, _ = _streams(dtype, dev)
    before = launched("detect")
    got = D.detect_streams(x, _taps(dev), decimate=decimate)
    torch.cuda.synchronize()
    assert launched("detect") == before + 1
    want = D.detect_plain(x, _taps(dev), decimate=decimate)
    for k in ("detected", "coarse", "start"):
        assert torch.equal(got[k], getattr(want, k)), k
    # both sum in f64; the metric is rounded to f32 once
    err = ((got["metric"] - want.metric).abs() / want.metric.abs().clamp_min(1e-30)).max()
    assert float(err) <= 1e-5
    assert got["detected"][:B - 50].all() and not got["detected"][B - 50:].any()
    band = got["start"][:B - 50].cpu().numpy() - offs[:B - 50]
    assert band.min() >= -4 and band.max() <= -2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_detect_and_align_cuts_bit_exact(dtype, dev):
    x, _, _ = _streams(dtype, dev)
    det, lp, pkt = D.detect_and_align(x, _taps(dev))
    torch.cuda.synchronize()
    s = torch.where(det["detected"], det["start"], 0).clamp(0, NS - 1360).long()
    rows = s[None, :] + torch.arange(1360, device=dev)[:, None]
    for plane, a, b in ((x.re, lp.re, pkt.re), (x.im, lp.im, pkt.im)):
        assert a.dtype == plane.dtype
        assert torch.equal(torch.cat([a, b]), torch.gather(plane, 0, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("sig_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noise_dtype", [torch.float32, torch.bfloat16])
def test_place_kernel_matches_plain(sig_dtype, noise_dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    sig = Cplx(*(torch.randn(NS, B, generator=gen, device=dev).to(sig_dtype) for _ in range(2)))
    noise = Cplx(*(1e-4 * torch.randn(NS, B, generator=gen, device=dev).to(noise_dtype)
                   for _ in range(2)))
    offs = torch.randint(0, NS, (B,), generator=gen, device=dev, dtype=torch.int32)
    before = launched("place")
    got = D.place_streams(sig, noise, offs)
    torch.cuda.synchronize()
    assert launched("place") == before + 1
    want = D.place_plain(sig, noise, offs)
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


def _check_place(sig_dtype, noise_dtype, ns: int, b: int, dev) -> None:
    """One launch at (ns, b), offsets 0 and ns − 1 among them, bit-equal to
    the plain version."""
    gen = torch.Generator(device=dev).manual_seed(ns + b)
    sig = Cplx(*(torch.randn(ns, b, generator=gen, device=dev).to(sig_dtype) for _ in range(2)))
    noise = Cplx(*(1e-2 * torch.randn(ns, b, generator=gen, device=dev).to(noise_dtype)
                   for _ in range(2)))
    offs = torch.randint(0, ns, (b,), generator=gen, device=dev, dtype=torch.int32)
    offs[0], offs[-1] = 0, ns - 1
    before = launched("place")
    got = D.place_streams(sig, noise, offs)
    torch.cuda.synchronize()
    assert launched("place") == before + 1
    want = D.place_plain(sig, noise, offs)
    assert got.re.dtype == sig_dtype
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


@pytest.mark.cuda
@pytest.mark.parametrize("sig_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noise_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [1361, 2048, 8192])
@pytest.mark.parametrize("b", [17, 1000])
def test_place_strips_match_plain(sig_dtype, noise_dtype, ns, b, dev):
    """Strips of streams through shared memory: a ragged last strip (17 and
    1,000 streams), a stream length that is no multiple of 64, and one
    whose full-width strip does not fit (8,192 rows: narrower strips)."""
    _check_place(sig_dtype, noise_dtype, ns, b, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("sig_dtype", [torch.float32, torch.bfloat16])
def test_place_streams_too_long_to_stage(sig_dtype, dev):
    """A stream longer than a strip of one may hold is read in place."""
    ns = 50_000
    assert D.place_attributes(sig_dtype, torch.float32, ns, 17)["strip"] == 0
    _check_place(sig_dtype, torch.float32, ns, 17, dev)


@pytest.mark.cuda
def test_place_strip_widths(dev):
    """A strip row is one 32-B sector where the strip fits 96 KB, halved
    while it does not; every staged kernel keeps two blocks on an SM and
    spills nothing."""
    f32, bf16 = torch.float32, torch.bfloat16
    for (sig_dtype, ns), strip in {(bf16, 2048): 16, (f32, 2048): 8, (bf16, 8192): 4,
                                   (f32, 8192): 2, (f32, 24576): 1, (f32, 24577): 0}.items():
        at = D.place_attributes(sig_dtype, f32, ns, 32768)
        assert at["strip"] == strip, (sig_dtype, ns, at)
        assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 2, (sig_dtype, ns, at)


RAW_CASES = {
    "f32": dict(dtype="f32"),
    "bf16-stream-sums-mmse": dict(dtype="bf16", stream_sums=True, equalize_with="h_mmse"),
    "bf16-dec32-serve": dict(dtype="bf16", decimate=32, serve=True),
    "int8-stream-sums": dict(dtype="int8", stream_sums=True, equalize_with="h_mmse"),
    "bf16-sync-stream-sums": dict(dtype="bf16", sync=True, stream_sums=True),
    "f32-sync-full-res-wiener": dict(dtype="f32", sync=True, decimate=False,
                                     equalize_with="h_wiener"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RAW_CASES))
def test_raw_kernel_matches_plain(case, dev):
    kw = dict(RAW_CASES[case])
    dtype = kw.pop("dtype")
    x, offs, lsb = _streams(dtype, dev, cfo=EPS if kw.get("sync") else 0.0)
    txc = _spectra(dev)
    before = launched("raw_chain")
    got = R.raw_rx_txconst_fused(x, _taps(dev), *txc, lsb=lsb, **kw)
    torch.cuda.synchronize()
    assert launched("raw_chain") == before + 1
    want = R.raw_chain_plain(x, _taps(dev), *txc, lsb=lsb, **kw)
    for k in ("detected", "start"):
        assert torch.equal(got[k], want[k]), k
    assert (got["eq"] is None) == bool(kw.get("stream_sums"))
    assert_matches(got, want, B, TOL["f32" if dtype == "f32" else "bf16"])


@pytest.mark.cuda
def test_staged_receiver_equals_fused_kernel(dev):
    """The staged receiver (detect-and-align kernel, then the chain kernel)
    and the one-kernel receiver run the same code on the same samples."""
    x, _, _ = _streams("bf16", dev)
    txc = _spectra(dev)
    staged = P.raw_rx_txconst(x, _taps(dev), *txc)
    fused = R.raw_rx_txconst_fused(x, _taps(dev), *txc, decimate=False)
    torch.cuda.synchronize()
    assert torch.equal(staged["start"], fused["start"])
    assert_matches(fused, staged, B, TOL["bf16"])


def _raw_streams(dtype: str, dev, ns: int = NS, b: int = B, offs=None, empty=()):
    """b lane-major streams of ns rows, the capture's frame at ``offs``
    (seeded in [40, ns − 1400) when None; blocks of 32 listed in ``empty``
    carry noise only), in the storage dtype; int8 words with their step."""
    offs_range = (8, 48) if ns < D.FRAME + 64 else None  # NS = 1408: the frame fills all but 48
    x, _ = make_streams(seed=ns + b, b=b, ns=ns, offs=offs, offs_range=offs_range)
    noise, _ = make_streams(seed=3, b=b, ns=ns, n_empty=b, offs_range=offs_range)
    for k in empty:
        x[32 * k:32 * (k + 1)] = noise[32 * k:32 * (k + 1)]
    return _stream_planes(x, dtype, dev)


def _widest_union(ns: int, b: int) -> np.ndarray:
    """Offsets whose every block spans the widest union of windows: lane 0
    at 40, lane 31 at ns − 1401, the rest spread between them in a
    scrambled order."""
    rng = np.random.default_rng(ns)
    block = np.linspace(40, ns - 1401, 32).round().astype(int)
    return np.concatenate([np.r_[block[0], rng.permutation(block[1:-1]), block[-1]]
                           for _ in range(-(-b // 32))])[:b]


STAGING_CASES = {
    "widest-union-f32": dict(dtype="f32", b=64, widest=True),
    "widest-union-bf16": dict(dtype="bf16", b=64, widest=True),
    "widest-union-int8": dict(dtype="int8", b=64, widest=True),
    "widest-union-full-res": dict(dtype="bf16", b=64, widest=True, decimate=False),
    "search-1-dec64": dict(dtype="bf16", search=1, decimate=64),
    "max-search-dec64-f32": dict(dtype="f32", search=D.MAX_SEARCH, decimate=64),
    "max-search-dec64-bf16": dict(dtype="bf16", search=D.MAX_SEARCH, decimate=64),
    "max-search-dec64-int8": dict(dtype="int8", search=D.MAX_SEARCH, decimate=64),
    "ns-1408": dict(dtype="bf16", ns=1408),
    "ns-1408-full-res-f32": dict(dtype="f32", ns=1408, decimate=False),
    "ns-8192": dict(dtype="bf16", ns=8192, b=256),
    "ns-8192-f32-widest": dict(dtype="f32", ns=8192, b=64, widest=True),
    "b-17": dict(dtype="bf16", b=17),
    "b-17-f32": dict(dtype="f32", b=17),
    "b-1000-int8": dict(dtype="int8"),
    "block-without-detection": dict(dtype="bf16", b=96, empty=(1,)),
    "block-without-detection-f32": dict(dtype="f32", b=96, empty=(0, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STAGING_CASES))
def test_staged_windows_match_plain(case, dev):
    """What the staging of the matched filter's windows could get wrong:
    blocks whose windows spread over the widest union, the least and the
    largest search, the least and a long NS, ragged batches (dead lanes), a
    block with no detected stream, each storage type.  Detection and the
    raw receiver against their plain versions: indices equal, the metric
    within 1e-5, the chain at its tolerances."""
    kw = dict(STAGING_CASES[case])
    dtype, ns, b = kw.pop("dtype"), kw.pop("ns", NS), kw.pop("b", B)
    offs = _widest_union(ns, b) if kw.pop("widest", False) else None
    x, lsb = _raw_streams(dtype, dev, ns, b, offs, kw.pop("empty", ()))
    search, decimate = kw.pop("search", 192), kw.pop("decimate", 16)
    before = (launched("detect"), launched("raw_chain"))
    got = D.detect_streams(x, _taps(dev), search=search, decimate=decimate)
    raw = R.raw_rx_txconst_fused(x, _taps(dev), *_spectra(dev), search=search,
                                 decimate=decimate, lsb=lsb, stream_sums=True)
    torch.cuda.synchronize()
    assert (launched("detect"), launched("raw_chain")) == (before[0] + 1, before[1] + 1)
    want = D.detect_plain(x, _taps(dev), search=search, decimate=decimate)
    raw_want = R.raw_chain_plain(x, _taps(dev), *_spectra(dev), search=search,
                                 decimate=decimate, lsb=lsb, stream_sums=True)
    for k in ("detected", "coarse", "start"):
        assert torch.equal(got[k], getattr(want, k)), k
        assert torch.equal(raw[k], raw_want[k]), k
    for m in (got["metric"], raw["metric"]):
        err = ((m - want.metric).abs() / want.metric.abs().clamp_min(1e-30)).max()
        assert float(err) <= 1e-5
    assert_matches(raw, raw_want, b, TOL["f32" if dtype == "f32" else "bf16"])
    if offs is not None:
        assert got["detected"].all()
    if "empty" in STAGING_CASES[case]:
        assert not got["detected"][32 * STAGING_CASES[case]["empty"][0]:][:32].any()


# local (spill) bytes a thread of the raw receiver's kernel before the
# detection body staged its windows (bf16, stream_sums, no sync, decimate 16;
# detect_variants on that body, H100 80GB HBM3)
PARENT_RAW_LOCAL_BYTES = 168


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("decimate", [16, 32])
def test_raw_kernel_keeps_two_blocks_per_sm(dtype, decimate, dev):
    """Detection's stage and |MF| values fit the chain's shared-memory union
    at the default search, so every instantiation keeps two blocks of 32
    streams on an SM; the detection kernel alone keeps at least two."""
    for sync in (False, True):
        for sums in (False, True):
            at = R.kernel_attributes(RAW_STORAGE[dtype], sync, sums, decimate=decimate)
            assert at["blocks_per_sm"] >= 2 and at["shared_bytes"] <= 113 * 1024, (sync, sums, at)
    at = D.detect_attributes(RAW_STORAGE[dtype], decimate=decimate)
    assert at["blocks_per_sm"] >= 2 and at["local_bytes"] == 0, at


@pytest.mark.cuda
def test_raw_kernel_spills_no_more_than_before(dev):
    at = R.kernel_attributes(torch.bfloat16, False, True, decimate=16)
    assert at["local_bytes"] <= PARENT_RAW_LOCAL_BYTES, at


# -- the generative kernels -------------------------------------------------------------------

GEN_B = 1024  # a multiple of 128, as the generative entries require


def _spectra(dev) -> F.TxConst:
    cap = load_capture()
    return F.tx_spectra(*(torch_planes(a).map(lambda t: t.to(dev))
                          for a in (cap.tx_packet, cap.tx_lptot)))


GEN_CASES = {
    "legacy-snr20-bf16": dict(),
    "A-snr35-bf16": dict(channel_model="A", snr_db=35.0),
    "E-snr10-f32": dict(channel_model="E", snr_db=10.0, eq_dtype=torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("stream_sums", [False, True])
@pytest.mark.parametrize("case", list(GEN_CASES))
def test_gen_kernel_matches_plain(case, stream_sums, dev):
    """The kernel's normals are the plain version's bit for bit, so every
    output agrees to f32 summation order: the h planes at TOL's f32
    entries, eq at its type's entry, the checksum 1e-4 of the largest."""
    kw = dict(GEN_CASES[case], stream_sums=stream_sums)
    txc = _spectra(dev)
    before = launched("gen_chain")
    got = G.fused_gen_chain(3, GEN_B, *txc, **kw)
    torch.cuda.synchronize()
    assert launched("gen_chain") == before + 1
    want = G.gen_chain_plain(3, GEN_B, *txc, **kw)
    tol = TOL["f32"]
    eq_tol = TOL["bf16" if kw.get("eq_dtype", torch.bfloat16) == torch.bfloat16 else "f32"]["eq"]
    for name in (*F.OUT_NAMES, "h_true", "eq"):
        lim = eq_tol if name == "eq" else tol.get(name, tol["h"])
        for g, w in zip(got[name], want[name]):
            assert rel(to_np(g), to_np(w)) < lim, (name, rel(to_np(g), to_np(w)))
    np.testing.assert_allclose(got["ow2"].cpu().numpy(), want["ow2"].cpu().numpy(), rtol=1e-4)
    assert rel(to_np(got["checksum"]), to_np(want["checksum"])) < 1e-4
    if stream_sums:
        assert got["sums"].shape == (G.N_SUMS, G.LANES)
        assert rel(to_np(got["sums"]), to_np(want["sums"])) < 1e-5


@pytest.mark.cuda
def test_gen_kernel_frames_do_not_depend_on_batch(dev):
    """A frame's draws depend on (seed, frame) only: the first 128 frames of
    a batch of 1024 are those of a batch of 128, bit for bit; the seed may
    be a 0-d int32 tensor on the card."""
    txc = _spectra(dev)
    small = G.fused_gen_chain(9, 128, *txc)
    big = G.fused_gen_chain(torch.tensor(9, dtype=torch.int32, device=dev), GEN_B, *txc)
    for name in (*F.OUT_NAMES, "h_true", "eq"):
        for a, b in zip(small[name], big[name]):
            assert torch.equal(a, b[..., :128]), name
    assert torch.equal(small["checksum"], big["checksum"][:128])


def _taps_of(n: int, dev) -> G.ChannelConsts:
    """Channel model E's exponential profile cut to ``n`` taps: warp g of the
    kernel draws taps l = g, g + 8, ..., so 9 and 15 taps leave warps idle."""
    wr, wi = G._cfr_mats(n)
    scale = np.sqrt(channel.pdp("E", n_taps=n) / 2.0).astype(np.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return G.ChannelConsts(Cplx(t(wr), t(wi)), t(scale))


@pytest.mark.cuda
@pytest.mark.parametrize("n_taps", [8, 9, 15, 16])
def test_gen_kernel_matches_plain_at_tap_counts(n_taps, monkeypatch, dev):
    """Each tap is drawn once, by warp l mod 8, and summed from shared
    memory: at full, ragged and single-warp tap counts the channel and
    every output agree with the plain version as in
    test_gen_kernel_matches_plain."""
    consts = _taps_of(n_taps, dev)
    monkeypatch.setattr(G, "channel_consts", lambda device, model=None: consts)
    txc = _spectra(dev)
    kw = dict(channel_model="E", snr_db=25.0)
    before = launched("gen_chain")
    got = G.fused_gen_chain(4, GEN_B, *txc, **kw)
    torch.cuda.synchronize()
    assert launched("gen_chain") == before + 1
    want = G.gen_chain_plain(4, GEN_B, *txc, **kw)
    tol = TOL["f32"]
    for name in (*F.OUT_NAMES, "h_true", "eq"):
        lim = TOL["bf16"]["eq"] if name == "eq" else tol.get(name, tol["h"])
        for g, w in zip(got[name], want[name]):
            assert rel(to_np(g), to_np(w)) < lim, (name, rel(to_np(g), to_np(w)))
    assert rel(to_np(got["checksum"]), to_np(want["checksum"])) < 1e-4


@pytest.mark.cuda
def test_gen_kernel_frames_do_not_depend_on_batch_at_16_taps(dev):
    """As test_gen_kernel_frames_do_not_depend_on_batch, with channel model
    E's 16 taps: two per warp."""
    txc = _spectra(dev)
    small = G.fused_gen_chain(9, 128, *txc, channel_model="E")
    big = G.fused_gen_chain(9, GEN_B, *txc, channel_model="E")
    for name in (*F.OUT_NAMES, "h_true", "eq"):
        for a, b in zip(small[name], big[name]):
            assert torch.equal(a, b[..., :128]), name
    assert torch.equal(small["checksum"], big["checksum"][:128])


@pytest.mark.cuda
def test_gen_kernel_occupancy(dev):
    """The bf16 kernel (stream mode's and the main path's) spills nothing
    and keeps at least two blocks of 32 frames on an SM; so does the f32
    one."""
    for eq_dtype in (torch.bfloat16, torch.float32):
        at = G.kernel_attributes(eq_dtype)
        assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 2, (eq_dtype, at)


def _ulps(x: torch.Tensor, y: np.ndarray) -> int:
    """The largest distance in f64 ulps between float64 ``x`` and ``y``."""
    def ordered(v: np.ndarray) -> np.ndarray:
        i = v.view(np.int64)
        return np.where(i < 0, np.iinfo(np.int64).min - i, i)
    return int(np.abs(ordered(x.cpu().numpy()) - ordered(y.astype(np.float64))).max())


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [0x12345678, 0xC0FFEE00])
def test_gen_normals_match_plain_on_every_uniform(fixed, dev):
    """The kernels' Box-Muller takes ln from a table and sin and cos by its
    own reduction and series.  Over all 2^24 values of u1 (u2's word fixed)
    and all 2^24 of u2 (u1's word fixed): the radius and the angle's sin
    and cos are within an f64 ulp of their correct rounding (numpy's
    extended precision), and the f32 normals are the plain version's bit
    for bit."""
    words = (torch.arange(2 ** 24, dtype=torch.int64, device=dev) << 8) | 0x5A
    other = torch.full_like(words, fixed)
    for a, b in ((words, other), (other, words)):
        r, sn, cs, z = G.kernel_normals(a, b)
        want = G.normal_pair(a, b)
        assert torch.equal(z.re, want.re) and torch.equal(z.im, want.im)
        u1 = G.uniform_open(a).cpu().numpy().astype(np.longdouble)
        th = (G._TWO_PI * G.uniform(b).double()).cpu().numpy().astype(np.longdouble)
        assert _ulps(r, np.sqrt(-2 * np.log(u1))) <= 1
        assert _ulps(sn, np.sin(th)) <= 1 and _ulps(cs, np.cos(th)) <= 1


RAW_GEN_CASES = {
    "snr20": dict(),
    "cfo40-mmse": dict(cfo_khz=40.0, equalize_with="h_mmse"),
    "A-snr35-wiener": dict(channel_model="A", snr_db=35.0, equalize_with="h_wiener"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RAW_GEN_CASES))
def test_raw_gen_kernel_matches_plain(case, dev):
    """The synthesized field is the plain version's bit for bit, so the
    offsets, the true CFO and the detection rows are exact; the chain's
    outputs agree at the bf16 tolerances, the checksum and EVM sums to 1e-3
    of the largest (deep fades amplify summation order in the blend)."""
    kw = RAW_GEN_CASES[case]
    txc, lts = _spectra(dev), _taps(dev)
    before = launched("raw_gen_chain")
    got = RG.gen_raw_system(5, GEN_B, *txc, lts, return_field=True, **kw)
    torch.cuda.synchronize()
    assert launched("raw_gen_chain") == before + 1
    want = RG.gen_raw_plain(5, GEN_B, *txc, lts, return_field=True, **kw)
    for g, w in zip(got["field"], want["field"]):
        assert torch.equal(g, w)
    for k in ("detected", "start", "offsets", "cfo_true"):
        assert torch.equal(got[k], want[k]), k
    for name, lim in (("h_true", 1e-6), ("h_wiener", 1e-4), ("h_mmse", 1e-3)):
        for g, w in zip(got[name], want[name]):
            assert rel(to_np(g), to_np(w)) < lim, (name, rel(to_np(g), to_np(w)))
    np.testing.assert_allclose(got["ow2"].cpu().numpy(), want["ow2"].cpu().numpy(), rtol=1e-4)
    assert float((got["cfo"] - want["cfo"]).abs().max()) <= 1e-6
    for k in ("checksum", "evm_sums"):
        assert rel(to_np(got[k]), to_np(want[k])) < 1e-3, k


@pytest.mark.cuda
@pytest.mark.parametrize("cfo_khz", [0.0, 40.0])
@pytest.mark.parametrize("ns", [1408, 4096])
def test_raw_gen_field_at_other_lengths(ns, cfo_khz, dev):
    """The field written row by row is the plain synthesis's bit for bit at
    the least multiple of 64 above 1,400 rows (the frame fills all but 48)
    and at 4,096 rows, with and without a CFO; so are the offsets and the
    true CFO.  The detection rows equal the plain detection's on that field
    at both lengths.

    Seed 5, as in test_raw_gen_kernel_matches_plain: a frame sample is
    bit-equal only where h_true's f32 rounding is, and h_true's f64 sums run
    in another order on each side (seed 11 has a sample one bf16 ulp apart,
    with the kernel of before this design too)."""
    txc, lts = _spectra(dev), _taps(dev)
    before = launched("raw_gen_chain")
    got = RG.gen_raw_system(5, GEN_B, *txc, lts, ns=ns, cfo_khz=cfo_khz, equalize_with="h_mmse",
                            return_field=True)
    torch.cuda.synchronize()
    assert launched("raw_gen_chain") == before + 1
    draws = RG.raw_draws(5, GEN_B, G.channel_consts(dev).tscale.shape[0], ns, dev)
    field, _, offs, eps = RG.synthesize(draws, *txc, cfo_khz=cfo_khz)
    for g, w in zip(got["field"], field):
        assert g.shape == (ns, GEN_B) and torch.equal(g, w)
    assert torch.equal(got["offsets"], offs) and torch.equal(got["cfo_true"], eps)
    want = D.detect_plain(field, lts, search=RG.SEARCH, advance=RG.ADVANCE, decimate=True)
    for k in ("detected", "start"):
        assert torch.equal(got[k], getattr(want, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("sync", [False, True])
def test_raw_gen_kernel_keeps_two_blocks_per_sm(sync, dev):
    """The synthesis, detection and chain share one shared-memory union
    that leaves two blocks of 32 streams on an SM."""
    at = RG.kernel_attributes(sync)
    assert at["blocks_per_sm"] >= 2 and at["shared_bytes"] <= 113 * 1024, at


@pytest.mark.cuda
@pytest.mark.parametrize("gen", list(S.GENERATORS))
def test_stream_step_on_the_card(gen, dev):
    """One device stream step per generator launches its kernels and returns
    finite summaries on the card; the same (i, state) gives the same batch."""
    step, s0 = S.make_device_stream_step(GEN_B, snr_db=30.0, gen=gen, device=dev)
    summary, sample_h, s1 = step(0, s0)
    again, sample_b, _ = step(0, s0)
    torch.cuda.synchronize()
    assert s1.device.type == "cuda" and s1.dtype == torch.int32
    for k, v in summary.items():
        assert v.device.type == "cuda" and bool(torch.isfinite(v)), k
        assert torch.equal(v, again[k]), k
    assert torch.equal(sample_h.re, sample_b.re)


MC_SWEEP = (0.0, 10.0, 20.0, 30.0, 40.0)
MC_KW = dict(snr_db=MC_SWEEP, gen="kernel_raw", channel_model="A", cfo_khz=20.0,
             equalize_with="h_mmse")


@pytest.mark.cuda
@pytest.mark.parametrize("i, shift", [(0, 0), (4, 7)])
def test_sweep_step_with_cfo_on_the_card_is_the_plain_step(i, shift, dev):
    """The upstream's Monte Carlo step (a 20 kHz CFO, the MMSE blend,
    channel A, the SNR cycle) on the card: batch i at SNR MC_SWEEP[i] is
    ``gen_raw_plain`` at the batch's `kernel_seed`, with the kernel's
    tolerances (test_raw_gen_kernel_matches_plain): detection and timing
    within two streams (a field sample may lie one bf16 step apart where
    h_true's float64 sums round otherwise), EVM and NMSE within 1e-3,
    the sampled h_mmse within 1e-3; the same (i, state) gives the same
    batch."""
    from tpu80211_torch.ops.detect import lts_time_symbol

    step, s0 = S.make_device_stream_step(GEN_B, seed=5, device=dev, **MC_KW)
    st = s0 + shift
    summary, sample_h, nxt = step(i, st)
    again, sample_b, nxt_b = step(i, st)
    txc = _spectra(dev)
    lts = torch_planes(lts_time_symbol(load_capture().tx_lptot).numpy()).map(lambda t: t.to(dev))
    want = RG.gen_raw_plain(S.kernel_seed(5, i, st), GEN_B, *txc, lts, snr_db=MC_SWEEP[i],
                            channel_model="A", cfo_khz=20.0, equalize_with="h_mmse")
    blocks = [t[:, :15].double() for t in txc.txs]
    ws = S._raw_summary(want, want["offsets"], want["h_true"],
                        float((blocks[0] ** 2 + blocks[1] ** 2).sum()))
    torch.cuda.synchronize()
    for k in ("detect_rate", "timing_in_band_rate"):
        assert abs(float(summary[k]) - float(ws[k])) * GEN_B <= 2, (k, summary[k], ws[k])
    for k in ("evm_rms", "h_mmse_mag_nmse"):
        assert float(summary[k]) == pytest.approx(float(ws[k]), rel=1e-3), k
    for g, w in zip(sample_h, want["h_mmse"]):
        assert rel(to_np(g), to_np(w[:, :128])) < 1e-3
    assert float(want["cfo_true"].abs().max()) > 5e-4
    for k, v in summary.items():
        assert torch.equal(v, again[k]), k
    assert torch.equal(sample_h.re, sample_b.re) and torch.equal(nxt, nxt_b)


@pytest.mark.cuda
def test_sweep_step_spans_and_counts_on_the_card(dev):
    """With spans on, a step's parts (seed, the generator's entry span,
    summary) add up to within 5% of its ``entry.stream_step`` span (the
    median step: the card's host is shared, and a step now and then loses
    the core for ~0.2 ms between two parts); each step counts one
    ``call.stream_step``, one ``call.gen_raw_system`` and one launch of the
    kernel."""
    step, st = S.make_device_stream_step(GEN_B, seed=5, device=dev, **MC_KW)
    for i in range(5):   # every SNR's constants, and the build
        _, _, st = step(i, st)
    torch.cuda.synchronize()
    spans.clear()
    spans.enable()
    try:
        before = spans.counters.snapshot()
        for i in range(5, 15):
            _, _, st = step(i, st)
        torch.cuda.synchronize()
        after = spans.counters.snapshot()
        recs = spans.records()
    finally:
        spans.disable()
    for k in ("call.stream_step", "call.gen_raw_system", "launch.raw_gen_chain"):
        assert after.get(k, 0) - before.get(k, 0) == 10, k
    tops = [r for r in recs if r.name == "entry.stream_step"]
    assert len(tops) == 10
    cover = []
    for top in tops:
        inside = [r for r in recs if r.call_id == top.call_id and r.parent == top.name]
        assert [r.name for r in inside] == ["seed", "entry.gen_raw_system", "summary"]
        cover.append(sum(r.end_ns - r.start_ns for r in inside) / (top.end_ns - top.start_ns))
    assert float(np.median(cover)) >= 0.95, cover


_COUNT_LAUNCHES = """
import json, sys, torch
from tpu80211_torch.pipeline import stream as S
from tpu80211_torch.utils import spans
gen = sys.argv[1]
kw = dict(snr_db=[0.0, 10.0, 20.0, 30.0, 40.0], gen=gen, channel_model="A")
if gen == "kernel_raw":
    kw.update(cfo_khz=20.0, equalize_with="h_mmse")
step, st = S.make_device_stream_step(1024, seed=5, device="cuda", **kw)
for i in range(5):
    _, _, st = step(i, st)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts):   # a process's first session drops events
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
before = spans.counters.snapshot()
with torch.profiler.profile(activities=acts) as prof:
    step(5, st)
    torch.cuda.synchronize()
after = spans.counters.snapshot()
cuda = torch.autograd.DeviceType.CUDA
kernels = [e.name()[:160] for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and not e.is_user_annotation()
           and not e.name().startswith(("Memcpy", "Memset"))]
print(json.dumps([sum(v - before.get(k, 0) for k, v in after.items()
                      if k.startswith("launch.")), kernels]))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["kernel", "kernel_raw"])
def test_stream_step_counts_its_launches(gen, dev):
    """The launches a step counts (its kernel, the wrapper's PyTorch kernel
    and the step's own under ``launch.torch``) are the kernels the
    profiler sees it run.  In a process of its own: a profiler session
    here left later sessions of this file without kernel events; and a
    short session first, as the benchmark's tracer does, since a process's
    first session missed some of the step's kernels."""
    p = subprocess.run([sys.executable, "-c", _COUNT_LAUNCHES, gen], capture_output=True,
                       text=True, timeout=600, cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert p.returncode == 0, p.stderr[-3000:]
    launches, kernels = json.loads(p.stdout.strip().splitlines()[-1])
    assert launches == len(kernels), (launches, "\n".join(kernels))


# -- the dense MMSE solves --------------------------------------------------------------------


def _solve_systems(dev, b: int = B):
    """bench.py's systems (bench.py:151-183): u, rx (b, 53) complex64 with
    standard normal parts, σ² = 0.37 (b,), on the card."""
    rng = np.random.default_rng(31)
    u, rx = (torch.tensor(rng.standard_normal((b, 53)) + 1j * rng.standard_normal((b, 53)),
                          dtype=torch.complex64, device=dev) for _ in range(2))
    return u, rx, torch.full((b,), 0.37, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gauss", "chol"])
@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_mmse_solve_kernel_matches_plain(entry, method, dev):
    """At a ragged B: z within 1e-4 of the plain version (two f32
    eliminations in another order, condition ~300), and seven spot systems
    within 5e-5 of numpy's f64 solve (bench.py:179-183)."""
    u, rx, ow2 = _solve_systems(dev)
    a = M.rank1_systems(u, ow2)
    before = (launched("mmse_solve"), launched("mmse_solve_dense"))
    if entry == "fused":
        got = M.fused_rank1_solve(u, rx, ow2, method)
        want = M.fused_rank1_plain(u, rx, ow2, method)
    else:
        got = M.solve_batched(a, rx[..., None], method)[..., 0]
        want = M.solve_batched_plain(a, rx[..., None], method)[..., 0]
    torch.cuda.synchronize()
    assert (launched("mmse_solve"), launched("mmse_solve_dense")) == (before[0] + (entry == "fused"),
                                              before[1] + (entry == "dense"))
    assert got.dtype == torch.complex64 and tuple(got.shape) == (B, 53)
    assert rel(to_np(got), to_np(want)) < 1e-4
    a64, rx64, z = (to_np(t) for t in (a, rx, got))
    for i in range(0, B, B // 7):
        ref = np.linalg.solve(a64[i], rx64[i])
        assert rel(z[i], ref) < 5e-5, i


@pytest.mark.cuda
def test_mmse_solve_launcher_refuses_cpu_tensors(dev):
    u, rx, ow2 = (t.cpu() for t in _solve_systems(dev, 4))
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        M._launch(u, rx, ow2, "chol")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gauss", "chol"])
def test_mmse_solve_complex128_in_complex128_out(method, dev):
    u, rx, ow2 = _solve_systems(dev, 64)
    u128, rx128 = u.to(torch.complex128), rx.to(torch.complex128)
    z = M.fused_rank1_solve(u128, rx128, ow2, method)
    zd = M.solve_batched(M.rank1_systems(u128, ow2.double()), rx128[..., None], method)
    assert z.dtype == zd.dtype == torch.complex128 and tuple(zd.shape) == (64, 53, 1)
    assert torch.equal(z, M.fused_rank1_solve(u, rx, ow2, method).to(torch.complex128))
    assert rel(to_np(zd[..., 0]), to_np(z)) < 1e-4


@pytest.mark.cuda
def test_dense_mmse_paths_launch_the_kernels(dev):
    """ps_mmse(solver="dense_pallas"), rx_chain(mmse_solver="dense_pallas")
    and sc.ps_mmse_dense reach the kernels on CUDA tensors and agree with
    their CPU runs (the plain versions) at the f32 tolerance of
    well-conditioned systems (SNR 10 dB frames)."""
    frames = make_frames(seed=12, b=64, snr_db=10.0)
    cpu = [torch.tensor(x) for x in frames]
    card = [t.to(dev) for t in cpu]
    before = (launched("mmse_solve"), launched("mmse_solve_dense"))
    got = RX.rx_chain(*card, mmse_solver="dense_pallas")
    torch.cuda.synchronize()
    assert launched("mmse_solve_dense") == before[1] + 1
    want = RX.rx_chain(*cpu, mmse_solver="dense_pallas")
    assert rel(to_np(got.h_mmse), to_np(want.h_mmse)) < 1e-3
    tx_blocks, rx_blocks = SCH.extract_blocks(card[0]), SCH.extract_blocks(card[1])
    h_lt, ow2 = SCH.lt_ls(*(SCH.preamble_fft(t) for t in card[2:])), SCH.noise_power(card[3])
    h = ps_mmse(tx_blocks, rx_blocks, ow2, h_lt, solver="dense_pallas")
    dense = SCH.ps_mmse_dense(tx_blocks, rx_blocks, ow2, h_lt)
    torch.cuda.synchronize()
    assert (launched("mmse_solve"), launched("mmse_solve_dense")) == (before[0] + 1, before[1] + 2)
    sm = SCH.ps_mmse_sm(tx_blocks, rx_blocks, ow2, h_lt)
    assert rel(to_np(h), to_np(sm)) < 1e-3 and rel(to_np(dense), to_np(sm)) < 1e-3


def _check_solves(entry: str, method: str, u, rx, ow2, tol: float = 1e-4) -> torch.Tensor:
    """One launch of the kernel against the plain version on the same
    systems: z within ``tol`` relative, where the plain z is finite.
    Returns the kernel's z."""
    if entry == "fused":
        got = M.fused_rank1_solve(u, rx, ow2, method)
        want = M.fused_rank1_plain(u, rx, ow2, method)
    else:
        a = M.rank1_systems(u, ow2)
        got = M.solve_batched(a, rx[..., None], method)[..., 0]
        want = M.solve_batched_plain(a, rx[..., None], method)[..., 0]
    torch.cuda.synchronize()
    assert tuple(got.shape) == tuple(rx.shape)
    ok = torch.isfinite(want).all(dim=-1)
    assert rel(to_np(got[ok]), to_np(want[ok])) < tol
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 8, 9, 8193])
@pytest.mark.parametrize("method", ["gauss", "chol"])
@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_mmse_solve_batch_edges(entry, method, b, dev):
    """Batches at the edges of a block's 8-row grid and past 8,192."""
    _check_solves(entry, method, *_solve_systems(dev, b))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gauss", "chol"])
@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_mmse_solve_occupancy_edges(entry, method, dev):
    """The compiled kernel spills nothing and keeps several systems on an
    SM; batches one short of and one past the resident systems of one SM
    and of the whole card (one system a block) give the plain version's z."""
    at = M.kernel_attributes(entry, method)
    assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 2, at
    per_sm = at["blocks_per_sm"]
    wave = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (per_sm - 1, per_sm + 1, wave - 1, wave + 1):
        _check_solves(entry, method, *_solve_systems(dev, b))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gauss", "chol"])
@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_mmse_solve_odd_offset_slice(entry, method, dev):
    """A slice that starts at system 1: its u, rx and systems lie 8 bytes
    off a 16-byte boundary (424 and 22,472 bytes a system), and the kernel
    reads them in place."""
    u, rx, ow2 = _solve_systems(dev, 65)
    a = M.rank1_systems(u, ow2)
    assert u[1:].data_ptr() % 16 == 8 and a[1:].data_ptr() % 16 == 8
    if entry == "fused":
        got = M.fused_rank1_solve(u[1:], rx[1:], ow2[1:], method)
        want = M.fused_rank1_plain(u, rx, ow2, method)[1:]
    else:
        got = M.solve_batched(a[1:], rx[1:, :, None], method)[..., 0]
        want = M.solve_batched_plain(a, rx[..., None], method)[1:, :, 0]
    torch.cuda.synchronize()
    assert rel(to_np(got), to_np(want)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gauss", "chol"])
@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_mmse_solve_nan_system_stays_in_its_block(entry, method, dev):
    """A system full of NaN gives NaN and leaves every other system's z as
    the plain version has it."""
    u, rx, ow2 = _solve_systems(dev, 40)
    u[17] = float("nan")
    z = _check_solves(entry, method, u, rx, ow2)
    assert not bool(torch.isfinite(z[17]).any())
    assert bool(torch.isfinite(z[torch.arange(40, device=dev) != 17]).all())


def _capture_like_frames(b: int, seed: int = 21):
    """b frames batch-major, complex64 numpy, as in make_frames: the
    capture's tx packet, its rx packet under a random phase per frame plus
    AWGN at SNR 30 (chip_smoke's main path), then the tx and rx preambles
    likewise.  The capture's σ² ≈ 1e-7 makes MMSE systems of condition
    1e5-1e7."""
    cap = load_capture()
    rng = np.random.default_rng(seed)
    rot = np.exp(2j * np.pi * rng.uniform(size=b))[:, None]

    def frames(x):
        p = np.mean(np.abs(x) ** 2) / 1e3
        n = (rng.standard_normal((b, x.size)) + 1j * rng.standard_normal((b, x.size))) / np.sqrt(2)
        return (x[None, :] * rot + np.sqrt(p) * n).astype(np.complex64)

    return (np.broadcast_to(cap.tx_packet, (b, cap.tx_packet.size)).astype(np.complex64),
            frames(cap.rx_packet), np.broadcast_to(cap.tx_lptot, (b, 160)).astype(np.complex64),
            frames(cap.rx_lptot))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gauss", "chol"])
@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_mmse_solve_capture_like_ill_conditioned(entry, method, dev):
    """The MMSE systems of capture-like frames (σ² ≈ 1e-7): z is good to a
    few percent at best in f32, so the estimate h = v·(uᴴz) is held, as on
    the main path: within 1e-2 of the plain version and 5e-2 of the rank-1
    closed form (tests/test_kernels.py:232-235)."""
    tx, rxp, txl, rxl = (torch.tensor(x, device=dev) for x in _capture_like_frames(256))
    tx_blocks, rx_blocks = SCH.extract_blocks(tx), SCH.extract_blocks(rxp)
    h_lt, ow2 = SCH.lt_ls(SCH.preamble_fft(txl), SCH.preamble_fft(rxl)), SCH.noise_power(rxl)
    assert float(ow2.median()) < 1e-5
    v = h_lt[:, None, :]
    u, rx = tx_blocks[:, :4] * v, rx_blocks[:, :4]
    w2 = torch.broadcast_to(ow2[:, None], u.shape[:-1])
    est = {}
    for plain in (False, True):
        if entry == "fused":
            fn = M.fused_rank1_plain if plain else M.fused_rank1_solve
            z = fn(u, rx, w2, method)
        else:
            fn = M.solve_batched_plain if plain else M.solve_batched
            z = fn(M.rank1_systems(u, w2), rx[..., None], method)[..., 0]
        est[plain] = (v * (u.conj() * z).sum(-1, keepdim=True)).mean(dim=-2)
    torch.cuda.synchronize()
    sm = SCH.ps_mmse_sm(tx_blocks, rx_blocks, ow2, h_lt)
    assert rel(to_np(est[False]), to_np(est[True])) < 1e-2
    assert rel(to_np(est[False]), to_np(sm)) < 5e-2


# -- the bench rows, the host stream, and the placement's offset check --------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TP.ROWS))
def test_bench_row_on_card(name, dev):
    """Every bench row at B=2,048 and loop length 2 on the card: its gates
    pass (a failure raises), and both fences read on both clocks."""
    row = TP.run_row(name, batch=2048, iters=2, device=dev)
    for fence in ("loop_ms", "batch_ms"):
        assert row[fence]["event"] > 0 and row[fence]["host"] > 0, fence
    assert row["idle_share"] is not None and row["idle_share"] < 1.0
    assert len(row["marginals_s"]["loop"]) == TP.REPS


@pytest.mark.cuda
def test_place_streams_reads_nothing_back(dev):
    """The placement kernel's wrapper, and one ``raw`` stream step around it,
    run under ``set_sync_debug_mode("error")``: no host read of the offsets
    (or of anything else) on the card."""
    gen = torch.Generator(device=dev).manual_seed(1)
    sig = Cplx(*(torch.randn(NS, 256, generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2)))
    noise = Cplx(*(torch.randn(NS, 256, generator=gen, device=dev) for _ in range(2)))
    offs = torch.randint(0, NS, (256,), generator=gen, device=dev, dtype=torch.int32)
    step, state = S.make_device_stream_step(1024, seed=3, gen="raw", device=dev)
    want = D.place_streams(sig, noise, offs)
    _, _, state = step(0, state)  # builds, loads and uploads the constants once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = D.place_streams(sig, noise, offs)
        summary, _, state = step(1, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert float(summary["detect_rate"]) > 0.9


@pytest.mark.cuda
def test_run_stream_on_card_matches_the_cpu(tmp_path, dev):
    """``run_stream`` on the card (pinned, non-blocking uploads) writes the
    shards the CPU run writes, within 1e-4 (h_mmse 1e-3), and resumes."""
    engine = "native" if native_engine.available() else "torch"

    def batches(n):
        return S.synthetic_batches(n, 512, seed=4, engine=engine)

    card = S.run_stream(batches(3), out_dir=str(tmp_path / "card"), device=dev)
    cpu = S.run_stream(batches(3), out_dir=str(tmp_path / "cpu"), device="cpu")
    assert card["frames"] == cpu["frames"] == 1536 and card["batches"] == 3
    for i in range(3):
        a, b = (np.load(tmp_path / d / f"h_est_{i:06d}.npz") for d in ("card", "cpu"))
        for k in S._STREAM_ESTS:
            assert rel(a[k], b[k]) <= (1e-3 if k == "h_mmse" else 1e-4), (i, k)
    again = S.run_stream(batches(4), out_dir=str(tmp_path / "card"), device=dev)
    assert again["batches"] == 1


@pytest.mark.cuda
def test_native_time_batches_into_fused_chain_on_card(dev):
    if not native_engine.available():
        pytest.skip("the native data engine does not build here")
    (args,) = list(S.native_time_batches(1, 1000, seed=9))
    got = F.fused_rx_chain(*(c.map(lambda t: t.to(dev)) for c in args))
    want = F.fused_rx_chain(*args)  # the plain version, on the CPU
    torch.cuda.synchronize()
    for name in (*F.OUT_NAMES, "eq"):
        tol = TOL["f32"]["eq" if name == "eq" else "h_mmse" if name == "h_mmse" else "h"]
        assert rel(to_np(got[name]), to_np(want[name])) <= tol, name


@pytest.mark.cuda
def test_quality_point_fused_on_card(dev):
    """The fused chain's quality point on the card against the plain
    version's on the CPU: other draws (a CUDA generator), the same
    statistics: NMSE within 1 dB at B=1,024."""
    got = Q.quality_point_fused(20.0, batch=1024, device=dev)["estimators"]
    want = Q.quality_point_fused(20.0, batch=1024, device="cpu")["estimators"]
    for name in got:
        assert abs(got[name]["nmse_db"] - want[name]["nmse_db"]) <= 1.0, name


@pytest.mark.cuda
def test_timeit_times_with_events(dev):
    a = torch.randn(512, 512, device=dev)
    s = timing.timeit(torch.mm, a, a, iters=5, device=dev)
    assert 0 < s < 1.0
    assert timing.time_ms(lambda: torch.mm(a, a), calls=2, reps=2) > 0


# -- the multi-device layer: a world of one on NCCL --------------------------------------------


@pytest.fixture
def nccl_one(dev, tmp_path):
    """A world of one on NCCL in this process, its (dp, blk) = (1, 1) mesh."""
    multihost.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device=dev)
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield PM.make_mesh(device=dev)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_shardmap_steps_on_card(nccl_one, dev):
    """The sm step equals ``sc.rx_chain_freq`` on the card within 1e-4
    (tests/test_mesh.py:94-105); the dense step launches the fused solve
    kernel (#8) once and equals sm at σ² = 0.25 within 1e-4."""
    fb = synthetic.generate(torch.Generator().manual_seed(3), 2048)
    args = tuple(x.to(dev) for x in (fb.tx_preamble_fft, fb.rx_preamble_fft, fb.tx_symb,
                                     fb.rx_symb, fb.ow2))
    step, nb_pad = PM.rx_step_shardmap(nccl_one)
    assert nb_pad == 15
    out, mse = step(*args)
    ref = SCH.rx_chain_freq(*args)
    for name in (*F.OUT_NAMES, "eq"):
        assert rel(to_np(getattr(out, name)), to_np(getattr(ref, name))) < 1e-4, name
    assert float(mse) == pytest.approx(float(ref.h_mmse.abs().square().mean()), rel=1e-4)
    dense_args = args[:4] + (torch.full_like(args[4], 0.25),)
    dense, _ = PM.rx_step_shardmap(nccl_one, solver="dense")
    before = launched("mmse_solve")
    out_d, mse_d = dense(*dense_args)
    torch.cuda.synchronize()
    assert launched("mmse_solve") == before + 1
    out_s, mse_s = step(*dense_args)
    assert rel(to_np(out_d.h_mmse), to_np(out_s.h_mmse)) < 1e-4
    assert float(mse_d) == pytest.approx(float(mse_s), rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("gen", S.MESH_GENERATORS)
def test_mesh_stream_step_on_card_is_the_single_chip_step(gen, nccl_one, dev):
    """At dp = 1 on NCCL the mesh step launches its kernel and equals the
    step without a mesh bit for bit over two chained batches."""
    kw = dict(snr_db=30.0, gen=gen, device=dev)
    mstep, m0 = S.make_device_stream_step(GEN_B, mesh=nccl_one, **kw)
    step, s0 = S.make_device_stream_step(GEN_B, **kw)
    before = (launched("gen_chain"), launched("raw_gen_chain"))
    for i in range(2):
        msum, msample, m0 = mstep(i, m0)
        ssum, ssample, s0 = step(i, s0)
        torch.cuda.synchronize()
        for k, v in msum.items():
            assert torch.equal(v, ssum[k]), (i, k)
        assert torch.equal(msample.re, ssample.re) and torch.equal(m0, s0)
    assert (launched("gen_chain"), launched("raw_gen_chain")) == (before[0] + 4 * (gen == "kernel"),
                                         before[1] + 4 * (gen == "kernel_raw"))


# -- the command line on the card --------------------------------------------------------------

CLI_MODES = ["math", "matlab", "c_parity"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CLI_MODES)
def test_cli_run_on_card_matches_the_cpu(mode, dev, capsys):
    """``run`` at complex128 on the card: the seven estimates equal the CPU's
    within 1e-12 (1e-8 for the MATLAB-mode MMSE's σ² division,
    tests/test_torch_models.py), and the command prints all of them."""
    from tpu80211_torch import cli
    from tpu80211_torch.config import ESTIMATOR_NAMES

    got = cli.run_estimators(ESTIMATOR_NAMES, mode, device=dev)
    want = cli.run_estimators(ESTIMATOR_NAMES, mode, device="cpu")
    for name in ESTIMATOR_NAMES:
        tol = 1e-8 if (mode, name) == ("matlab", "ps_mmse") else 1e-12
        assert rel(got[name][1], want[name][1]) <= tol, name
    assert cli.main(["run", "--mode", mode]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("H_EST[") for ln in lines) == 7 * 53


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CLI_MODES)
def test_cli_parity_on_card(mode, dev, capsys):
    import json

    from tpu80211_torch import cli

    assert cli.main(["parity", "--mode", mode]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["pass"] and all(v < 1e-6 for v in res["max_rel_err"].values())


@pytest.mark.cuda
def test_cli_raw_on_card_through_the_raw_chain_kernel(dev, capsys):
    """``raw`` at a small batch launches kernel #5 once and detects every
    stream within [-4, -2], as the same command on the CPU does."""
    import json

    from tpu80211_torch import cli

    before = launched("raw_chain")
    assert cli.main(["raw", "--batch", "200", "--seed", "3"]) == 0
    torch.cuda.synchronize()
    assert launched("raw_chain") == before + 1
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["raw", "--batch", "200", "--seed", "3", "--device", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["detected"] == got["streams"] == 200
    assert -4 <= got["timing_err_min"] <= got["timing_err_max"] <= -2
    for k in ("detected", "timing_err_min", "timing_err_max"):
        assert got[k] == want[k], k
    assert got["h_mmse_mean_abs"] == pytest.approx(want["h_mmse_mean_abs"], rel=1e-3)


# -- the program's spans and counters on the card --------------------------------


@pytest.mark.cuda
def test_traced_entry_holds_one_check_outputs_and_launch(frames, dev):
    """Under the profiler one `fused_rx_chain_txconst` call records its
    entry span and, inside it, exactly one each of check, outputs and
    launch; the profiler's trace carries them under the same names, and the
    chain kernel starts on the card after the launch span starts on the
    host (one clock)."""
    _, rx_pkt, _, rx_lp = frames[1]
    txc = _spectra(dev)
    rp, rl = _on(rx_pkt, torch.bfloat16, dev), _on(rx_lp, torch.bfloat16, dev)
    F.fused_rx_chain_txconst(*txc, rp, rl, serve=True)   # the library, the constants
    torch.cuda.synchronize()
    spans.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        F.fused_rx_chain_txconst(*txc, rp, rl, serve=True)
        torch.cuda.synchronize()
    recs = spans.records()
    (entry,) = [r for r in recs if r.name == "entry.fused_rx_chain_txconst"]
    inside = [r for r in recs if r.call_id == entry.call_id and r.parent == entry.name]
    assert sorted(r.name for r in inside) == ["check", "launch", "outputs"]
    assert all(entry.start_ns <= r.start_ns <= r.end_ns <= entry.end_ns for r in inside)
    events = list(prof.profiler.kineto_results.events())
    names = {e.name() for e in events}
    assert {spans.PREFIX + n for n in (entry.name, "check", "outputs", "launch")} <= names
    (launch,) = [r for r in inside if r.name == "launch"]
    kernels = [e.start_ns() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "fused_chain_kernel" in e.name()]
    assert len(kernels) == 1 and kernels[0] > launch.start_ns


@pytest.mark.cuda
def test_counters_count_each_call_and_its_launches(frames, dev):
    """An aligned call counts one call and one launch (the chain kernel); a
    raw call one call and two (the raw kernel, then ``det != 0``)."""
    def launches():
        return sum(v for k, v in spans.counters.snapshot().items() if k.startswith("launch."))

    def calls(entry):
        return spans.counters.snapshot().get(f"call.{entry}", 0)

    _, rx_pkt, _, rx_lp = frames[1]
    txc = _spectra(dev)
    rp, rl = _on(rx_pkt, torch.bfloat16, dev), _on(rx_lp, torch.bfloat16, dev)
    before = launches(), calls("fused_rx_chain_txconst")
    F.fused_rx_chain_txconst(*txc, rp, rl, serve=True)
    assert (launches(), calls("fused_rx_chain_txconst")) == (before[0] + 1, before[1] + 1)
    x, _, lsb = _streams("bf16", dev)
    before = launches(), calls("raw_rx_txconst_fused")
    R.raw_rx_txconst_fused(x, _taps(dev), *txc, lsb=lsb)
    assert (launches(), calls("raw_rx_txconst_fused")) == (before[0] + 2, before[1] + 1)
    torch.cuda.synchronize()
