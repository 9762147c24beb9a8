"""The Monte Carlo cell on the CPU: the reference's draws and synthesis
against the program's, bit for bit, at a small batch; the seed word the
loop derives against the program's; the cell's files; and a run that loads
no JAX.  Its sound run, its control and its three planted faults run with
every other cell's in ``test_perfbench_run.py`` (sizes and faults in
``conftest.py``)."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec as S
from perfbench.configs import montecarlo_a as M
from perfbench.inputs import frames
from perfbench.reference import chain as ref
from perfbench.reference import draws

CFG = json.loads((S.HERE / "configs" / "montecarlo_a.json").read_text())
B, NS, SEED = 128, 2048, 5   # seed 5, as the card tests of the kernel use


@pytest.fixture(scope="module")
def program():
    from tpu80211_torch.cplx import Cplx
    from tpu80211_torch.kernels import fused_chain as F
    from tpu80211_torch.kernels import raw_gen_chain as RG

    lp, pkt = frames.tx_frame()

    def planes(z):
        return Cplx(*(torch.tensor(v, dtype=torch.float32) for v in (z.real, z.imag)))

    return RG, F.tx_spectra(planes(pkt), planes(lp))


def test_reference_draws_are_the_programs(program):
    RG, _ = program
    want = RG.raw_draws(SEED, B, 8, NS, "cpu")
    got = draws.Draws(SEED, 0, B, 8, NS, "cpu")
    for g, w in ((got.taps, want.taps), (got.noise, want.noise)):
        assert torch.equal(g[0], w.re) and torch.equal(g[1], w.im)
    assert torch.equal(got.offset_word, want.offset_word)
    assert torch.equal(got.cfo_word, want.cfo_word)
    # a block of streams draws what those streams draw in the whole batch
    part = draws.Draws(SEED, 64, 32, 8, NS, "cpu")
    assert torch.equal(part.noise[0], want.noise.re[:, 64:96])


@pytest.mark.parametrize("snr_db", [0.0, 40.0])
@pytest.mark.parametrize("cfo_khz", [0.0, 20.0])
def test_reference_synthesis_is_the_programs(program, snr_db, cfo_khz):
    """The field, the channel, the offsets and the CFO, bit for bit; and the
    reference's own transmit spectra equal the program's."""
    RG, (txs, tpre) = program
    p = RG.raw_draws(SEED, B, 8, NS, "cpu")
    want = RG.synthesize(p, txs, tpre, snr_db, "A", cfo_khz)
    rms = CFG["deployment"]["rms_delay_spread_ns"] * 1e-9 * CFG["deployment"]["sample_rate_hz"]
    got = draws.synthesize(draws.Draws(SEED, 0, B, 8, NS, "cpu"), tuple(txs), tuple(tpre), rms,
                           snr_db, cfo_khz)
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        assert torch.equal(g[0], w.re) and torch.equal(g[1], w.im)
    assert torch.equal(got[2].to(torch.int32), want[2]) and torch.equal(got[3], want[3])
    (br, bi), (pr, pi) = ref.tx_spectra(ref.Consts("cpu", ref.wiener_prior(rms, 40.0)),
                                        *frames.tx_frame())
    assert torch.equal(br, txs.re[:, :15]) and torch.equal(bi, txs.im[:, :15])
    assert torch.equal(pr, tpre.re) and torch.equal(pi, tpre.im)


@pytest.mark.parametrize("rank", range(4))
def test_seed_word_is_the_programs(rank):
    """Each dp rank's seed word too (rank 0: one card)."""
    from tpu80211_torch.kernels import gen_chain as G
    from tpu80211_torch.pipeline import stream

    for seed, i, state in ((0, 0, 0), (2**31 + 5, 7, 65535), (3 * 2**32 + 11, 40000, 123)):
        want = G.seed_word(stream.kernel_seed(seed, i, torch.tensor(state, dtype=torch.int32),
                                              rank), "cpu")
        assert M.seed_word(seed, i, state, rank) == int(want)


def test_the_cell_loads():
    cell = S.load("montecarlo_a.single")
    assert cell.workload["chips"] == 1 and cell.traffic["loop"] == "stream"
    assert set(cell.limits) == {"detect_miss", "timing_miss", "evm_rel", "nmse_rel", "h_rel"}
    assert [m.name for m in cell.per_layer] == ["raw_gen_chain_roofline", "device_idle_pct.stream",
                                                "step_host_us", "step_launches_per_call"]
    assert [m.name for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    # a step's least time: the table's bound of the kernel with the sync's work
    w = M.work(CFG, CFG["batch"])
    assert w["ops"] / 67e12 + w["tc_ops"] / 989e12 == pytest.approx(0.4987e-3, rel=1e-3)


def test_reference_one_precision_below_is_not_correct():
    """The reference with the frame's samples and the receiver's rows in
    float8 (e4m3), the precision below the configuration's bfloat16, fails
    the cell's limits against the program."""
    from perfbench.run import run_cell

    cell = S.load("montecarlo_a.single")
    cell.traffic = {**cell.traffic, "batch": 128, "warm_steps": 1, "sample_steps": 0}
    cell.config = {**cell.config, "storage": "float8_e4m3fn"}
    out = run_cell(cell, 2**31 + 7, 0.1, False, "cpu")
    assert not out["correct"], out["checks"]


def test_a_run_loads_no_jax():
    """A whole run of the cell (the program included) in a fresh process
    leaves no module of JAX or of the JAX package loaded."""
    code = ("import json, sys; from perfbench import spec as S; from perfbench.run import "
            "run_cell, forbidden_modules; c = S.load('montecarlo_a.single'); "
            "c.traffic = {**c.traffic, 'batch': 128, 'warm_steps': 1, 'sample_steps': 0}; "
            "out = run_cell(c, 1, 0.1, False, 'cpu'); "
            "print(json.dumps([out['correct'], forbidden_modules(), "
            "'tpu80211_torch' in sys.modules]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, [], True]
