"""The seeded input generator: deterministic in the seed, and the deployment
it states (SNR, CFO, offsets)."""

import json
import math

import numpy as np
import torch

from perfbench import spec as S
from perfbench.inputs import frames

CFG_A = json.loads((S.HERE / "configs" / "aligned_a40.json").read_text())
CFG_R = json.loads((S.HERE / "configs" / "raw_a40.json").read_text())
BIG = 2**31 + 977  # the driver's seeds pass 32 signed bits


def aligned(seed, b=64, dtype=torch.float32):
    return frames.aligned_batch(CFG_A["deployment"], frames.generator(seed, "cpu"), b, dtype)


def raw(seed, b=32):
    d = CFG_R["deployment"]
    return frames.raw_batch(d, frames.generator(seed, "cpu"), b, torch.float32,
                            tuple(d["offset_range"]))


def test_same_seed_same_inputs():
    assert torch.equal(aligned(BIG), aligned(BIG))
    assert not torch.equal(aligned(BIG), aligned(BIG + 1))
    (x1, o1), (x2, o2) = raw(BIG), raw(BIG)
    assert torch.equal(x1, x2) and torch.equal(o1, o2)
    assert frames.generator(-5, "cpu").initial_seed() == (-5) % 2**64


def test_shapes_and_storage():
    x = aligned(3, 40, torch.bfloat16)
    assert x.shape == (frames.PACKED_ROWS, 40) and x.dtype == torch.bfloat16 and x.is_contiguous()
    xr, offs = raw(3, 20)
    assert xr.shape == (2 * CFG_R["deployment"]["stream_samples"], 20)
    lo, hi = CFG_R["deployment"]["offset_range"]
    assert bool(((offs >= lo) & (offs < hi)).all())


def test_noise_power_and_cfo():
    """Noise-only rows of a raw stream carry σ² = P/10^4; the phase of the
    LTS repeats turns by 2π·64·cfo/fs."""
    d = CFG_R["deployment"]
    x, offs = raw(11, 64)
    ns = d["stream_samples"]
    z = torch.complex(x[:ns].double(), x[ns:].double())
    head = z[:int(offs.min())]                        # before every frame: noise alone
    assert abs(float(head.abs().square().mean()) / frames.noise_power(d) - 1.0) < 0.05
    y = aligned(12, 256)
    lp = torch.complex(y[2400:2560].double(), y[2560:].double())
    c = (lp[32:96].conj() * lp[96:160]).sum()
    eps = math.atan2(float(c.imag), float(c.real)) / (2 * math.pi * 64)
    assert abs(eps - d["cfo_hz"] / d["sample_rate_hz"]) < 1e-5


def test_channel_is_normalised():
    p = frames.pdp(1.0, 8)
    assert abs(p.sum() - 1.0) < 1e-12 and np.all(np.diff(p) < 0)
