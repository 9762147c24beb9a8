"""The plain reference against the port's plain twins (``fused_chain_plain``,
``raw_chain_plain``), on the benchmark's own inputs at a small batch, with
the deployment's 20 kHz CFO and ``sync``, on the CPU."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec as S
from perfbench.configs import aligned_a40 as A
from perfbench.configs import raw_a40 as R
from perfbench.inputs import frames
from perfbench.reference import chain as ref

CFG_A = json.loads((S.HERE / "configs" / "aligned_a40.json").read_text())
CFG_R = json.loads((S.HERE / "configs" / "raw_a40.json").read_text())
H_AND_EQ = (*ref.H_NAMES, "eq")


def assert_same(got: dict, want: dict, names) -> None:
    """Bit for bit: the same operations in the same order on the CPU."""
    for k in names:
        for g, w in zip(got[k], want[k]):
            assert torch.equal(g, w), k
    for k in ("ow2", "cfo"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
@pytest.mark.parametrize("equalize_with", ["h_mmse", "h_linear"])
def test_aligned_reference_is_the_plain_chain(storage, equalize_with):
    cfg = {**CFG_A, "storage": storage, "entry": {**CFG_A["entry"], "equalize_with": equalize_with}}
    x = A.make_batch(cfg, frames.generator(7, "cpu"), 96)
    state = A.setup(cfg, "cpu")
    got = A.call(state, x)
    want = A.Reference(cfg, "cpu").outputs(x)
    assert_same(got, want, H_AND_EQ)
    # the CFO is found: 20 kHz at 20 MS/s is 1e-3 cycles a sample
    assert abs(float(want["cfo"].median()) - 1e-3) < 2e-5


def test_aligned_serving_reference():
    x = A.make_batch(CFG_A, frames.generator(8, "cpu"), 40)
    got = A.call(A.setup(CFG_A, "cpu"), x, serve=True)
    want = A.Reference(CFG_A, "cpu").outputs(x)
    assert got["h_lt"] is None
    assert_same(got, want, ("h_wiener", "h_mmse", "eq"))


def test_raw_reference_is_the_plain_receiver():
    x = R.make_batch(CFG_R, frames.generator(9, "cpu"), 48)
    got = R.call(R.setup(CFG_R, "cpu"), x)
    want = R.Reference(CFG_R, "cpu").outputs(x)
    assert torch.equal(got["detected"], want["detected"]) and bool(want["detected"].all())
    assert torch.equal(got["start"].to(torch.int64), want["start"])
    assert_same(got, want, H_AND_EQ)


def test_reference_imports_nothing_of_the_program():
    """perfbench.reference loads neither JAX, the JAX package nor the port."""
    code = ("import sys; import perfbench.reference.chain, perfbench.reference.detect, "
            "perfbench.reference.compare, perfbench.inputs.frames; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpu80211', 'tpu80211_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
