"""The fused-chain CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import fused_chain as F

from _torch_inputs import TOL, assert_matches, lane_major, make_frames, torch_planes

B = 1000  # ragged: no multiple of the kernel's 32 frames per block
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.float32}
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
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the fused-chain kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames():
    return make_frames(seed=5, b=B), make_frames(seed=6, b=B, tx_const=True)


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
    before = F.launches
    got = F.fused_chain(rp, rl, tx, consts, **kw)
    torch.cuda.synchronize()
    assert F.launches == before + 1
    want = F.fused_chain_plain(rp, rl, tx, consts, **kw)
    assert_matches(got, want, B, TOL[dtype])


@pytest.mark.cuda
def test_batch_major_entry_matches_plain(frames, dev):
    """The batch-major public entry launches the kernel once and agrees
    with the plain version."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = frames[0]
    before = F.launches
    got = F.fused_rx_chain(*(torch_planes(x).map(lambda t: t.to(dev))
                             for x in (tx_pkt, rx_pkt, tx_lp, rx_lp)))
    want = F.fused_chain_plain(_on(rx_pkt, torch.float32, dev), _on(rx_lp, torch.float32, dev),
                               F.TxFrames(_on(tx_pkt, torch.float32, dev),
                                          _on(tx_lp, torch.float32, dev)),
                               F.chain_consts(dev))
    assert F.launches == before + 1
    lane = {k: v if v is None or k in ("ow2", "cfo", "checksum") else
            v.map(lambda t: t.permute(1, 2, 0) if t.dim() == 3 else t.T) for k, v in got.items()}
    assert_matches(lane, want, B, TOL["f32"])
