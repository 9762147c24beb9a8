"""The port's generative chain against the JAX package, on the CPU.

``fused_gen_chain`` of the JAX package runs its CPU twin (``_gen_chain_jax``)
off the TPU: jax.random normals, then the chain in plain jnp.  Its normals
are rebuilt here by repeating its key splits and fed to the port's assembly
(``gen_assemble``), so both sides compute on the very same draws.  The
port's own draws come from Philox4x32-10 (csrc/gen.cuh), pinned by the
Random123 known-answer vectors.  The CUDA kernel is held against
``gen_chain_plain`` in test_torch_cuda.py.
"""

import math
import pathlib
import re
import struct
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.cplx import Cplx as JCplx
from tpu80211.kernels import fused_chain as JF
from tpu80211.kernels import gen_chain as JG
from tpu80211_torch import convert
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import gen_chain as TG
from tpu80211_torch.kernels import gen_tables as GT
from tpu80211_torch.ops import channel

from _torch_inputs import TOL, rel, to_np

B = 256


@pytest.fixture(scope="module")
def spectra():
    """(JAX (txs, tpre), the port's TxConst) of the shipped capture."""
    from tpu80211.datasets.loader import load_capture

    cap = load_capture()
    txs, tpre = JF.tx_spectra(JCplx.from_complex(cap.tx_packet, jnp.float32),
                              JCplx.from_complex(cap.tx_lptot, jnp.float32))
    port = convert.tx_spectra(*(np.asarray(a) for a in (txs.re, txs.im, tpre.re, tpre.im)),
                              device="cpu")
    return (txs, tpre), port


# -- the generator ---------------------------------------------------------------------------

KAT = {  # Random123's kat_vectors for philox4x32_10: counter, key → words
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    "ones": ((0xffffffff,) * 4, (0xffffffff,) * 2,
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    "pi": ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
           (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
}


@pytest.mark.parametrize("case", list(KAT))
def test_philox_known_answers(case):
    ctr, key, want = KAT[case]
    got = TG.philox(*(torch.tensor(c) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_normals_are_standard_and_uniforms_24_bit():
    w = TG.draw(12345, 4096, torch.arange(64)[:, None], TG.NOISE, device="cpu")
    u1, u2 = TG.uniform_open(w[0]), TG.uniform(w[1])
    # 24-bit grids: u2·2²⁴ is an integer, u1 sits half a step above one
    assert torch.equal(u2 * 2 ** 24, torch.floor(u2 * 2 ** 24))
    assert float(u1.min()) > 0.0 and float(u1.max()) <= 1.0
    z = TG.normal_pair(w[0], w[1])
    v = torch.cat([z.re.flatten(), z.im.flatten()]).double()
    # 524,288 normals: the mean's standard error is 1.4e-3, the variance's 2e-3
    assert abs(float(v.mean())) < 7e-3 and abs(float(v.var()) - 1.0) < 1e-2
    assert abs(float((z.re.double() * z.im.double()).mean())) < 1e-2


# -- the kernels' Box-Muller arithmetic (csrc/gen.cuh), emulated exactly -------------------

_GEN_CUH = pathlib.Path(TG.__file__).parent / "csrc" / "gen.cuh"


def _const(name: str) -> float:
    """A ``constexpr double`` of gen.cuh."""
    return float.fromhex(re.search(rf"constexpr double {name} = (\S+);", _GEN_CUH.read_text())[1])


def _fma(a: float, b: float, c: float) -> float:
    """a·b + c rounded once, as the card's fused multiply-add."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _f32_bits(u: float) -> int:
    return struct.unpack("<I", struct.pack("<f", u))[0]


def _ln_uniform(u: float) -> float:
    """gen::ln_uniform, operation for operation."""
    bits = _f32_bits(u)
    m = bits & 0x7FFFFF
    up = int(m >= 0x400000)
    y = struct.unpack("<d", struct.pack("<Q", (0x3FF - up) << 52 | m << 29))[0]
    e = float((bits >> 23) - 127 + up)
    r, hi, lo = GT.entry(m >> 15)
    t = _fma(y, float(r), -1.0)
    p = 1.0 / 7
    for c in (-1.0 / 6, 1.0 / 5, -1.0 / 4, 1.0 / 3, -1.0 / 2):
        p = _fma(p, t, c)
    h = _fma(e, _const("LN2_HI"), hi)
    tail = _fma(t * t, p, _fma(e, _const("LN2_LO"), float(lo)))
    s = h + t
    return s + ((t - (s - h)) + tail)


def _sincos_turn(w: int) -> tuple[float, float]:
    """gen::sincos_turn, operation for operation: (sin, cos)."""
    n = ((w >> 8) + (1 << 21)) >> 22
    d = TG._TWO_PI * ((w >> 8) * 2.0 ** -24)
    for part in ("PIO2_1", "PIO2_2", "PIO2_3"):
        d = _fma(-float(n), _const(part), d)
    d2 = d * d
    ps, pc = 1.0 / math.factorial(17), 1.0 / math.factorial(16)
    for k in range(15, 1, -2):
        ps = _fma(ps, d2, (-1) ** ((k - 1) // 2) / math.factorial(k))
        pc = _fma(pc, d2, (-1) ** ((k - 1) // 2) / math.factorial(k - 1))
    s, c = _fma(d2 * d, ps, d), _fma(d2, pc, 1.0)
    return ((s, c), (c, -s), (-s, -c), (-c, s))[n & 3]


def _ulps(x: float, y: float) -> int:
    def ordered(v: float) -> int:
        i = struct.unpack("<q", struct.pack("<d", v))[0]
        return -(2 ** 63) - i if i < 0 else i
    return abs(ordered(x) - ordered(y))


def test_ln_table_in_the_header_matches_its_generator():
    """gen.cuh's LN_TABLE and its ln 2 and pi/2 splits are gen_tables'; R
    is 1 on the two intervals that touch 1, every |y R - 1| is at most
    2^-8 (2^-8.9 where R is not 1), and hi lies on the 2^-45 grid."""
    text = _GEN_CUH.read_text()
    body = text[text.index("LN_TABLE[LN_ENTRIES] = {"):]
    body = body[body.index("\n") + 1:body.index("\n};")]
    assert body == GT.c_table()
    assert (_const("LN2_HI"), _const("LN2_LO")) == GT.ln2_split()
    assert tuple(_const(f"PIO2_{i}") for i in (1, 2, 3)) == GT.pio2_split()
    for i in range(2 ** GT.N_BITS):
        r, hi, _ = GT.entry(i)
        lo_y, hi_y = GT.interval(i)
        t = max(abs(lo_y * float(r) - 1), abs(hi_y * float(r) - 1))
        assert t <= (2 ** -8 if float(r) == 1.0 else 2 ** -8.9), i
        assert (hi / GT.QUANTUM).is_integer(), i
        assert (float(r) == 1.0) == (i in (0, 2 ** GT.N_BITS - 1)), i


_EDGES = [0, 1, 2, 2 ** 21 - 1, 2 ** 21, 2 ** 21 + 1, 2 ** 22 - 1, 2 ** 22, 2 ** 22 + 1,
          3 * 2 ** 21, 2 ** 23 - 1, 2 ** 23, 2 ** 23 + 1, 3 * 2 ** 22, 7 * 2 ** 21,
          2 ** 24 - 2, 2 ** 24 - 1]


@pytest.mark.parametrize("term", ["radius", "angle"])
def test_kernel_box_muller_within_an_ulp_of_the_plain_version(term):
    """The kernels take ln from a table and sin and cos by their own
    reduction and series (csrc/gen.cuh), fused multiply-adds included.
    Emulated exactly, on 3,000 seeded 24-bit values and the edges (u1 = 1
    and 2^-25, the quadrants and octants of u2), each term is within an f64
    ulp of the plain version's (torch's log, sqrt, sin and cos), and the
    float32 normals are the plain version's bit for bit."""
    rng = np.random.default_rng(11)
    m = [*_EDGES, *rng.integers(0, 2 ** 24, 3000).tolist()]
    words = [(v << 8) | 0xA5 for v in m]
    fixed = [0x3C6EF372] * len(words)
    a, b = (words, fixed) if term == "radius" else (fixed, words)
    ta, tb = torch.tensor(a, dtype=torch.int64), torch.tensor(b, dtype=torch.int64)
    u1 = TG.uniform_open(ta).double()
    r_plain = torch.sqrt(-2.0 * torch.log(u1))
    th = TG._TWO_PI * TG.uniform(tb).double()
    want = TG.normal_pair(ta, tb)
    for i in range(len(m)):
        r = math.sqrt(-2.0 * _ln_uniform(float(u1[i])))
        sn, cs = _sincos_turn(b[i])
        assert _ulps(r, float(r_plain[i])) <= 1, (i, m[i])
        assert _ulps(sn, float(torch.sin(th[i]))) <= 1 and _ulps(cs, float(torch.cos(th[i]))) <= 1, i
        assert (np.float32(r * cs), np.float32(r * sn)) == (want.re[i].item(), want.im[i].item()), i


def test_draws_depend_on_seed_and_frame_only(spectra):
    """A frame's numbers are a function of (seed, frame): the first 128
    frames of a batch of 256 are those of a batch of 128; an int seed and
    the same value as an int32 tensor agree; another seed differs."""
    small = TG.gen_draws(9, 128, device="cpu")
    big = TG.gen_draws(torch.tensor(9, dtype=torch.int32), 256, device="cpu")
    for a, b in zip(small, big):
        assert torch.equal(a.re, b.re[..., :128]) and torch.equal(a.im, b.im[..., :128])
    other = TG.gen_draws(10, 128, device="cpu")
    assert not torch.equal(other.blocks.re, small.blocks.re)
    # negative seeds are their 32-bit words
    neg = TG.gen_draws(-1, 128, device="cpu")
    assert torch.equal(neg.taps.re, TG.gen_draws(2 ** 32 - 1, 128, device="cpu").taps.re)


@pytest.mark.parametrize("model", [None, "A", "E"])
def test_constants_equal_jax(model):
    n = channel.n_taps_for(model)
    for got, want in zip(TG._cfr_mats(n), JG._cfr_mats(n)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TG._pdp_scale(model), JG._pdp_scale(model))


# -- value parity on the twin's own draws ------------------------------------------------------


def _twin_draws(seed: int, batch: int, n_taps: int) -> TG.GenDraws:
    """The CPU twin's unit normals, by its own key splits (gen_chain.py:488-503)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(seed, jnp.int32))
    k_t, k_n = jax.random.split(key)
    tn = np.asarray(jax.random.normal(k_t, (2, n_taps, batch), jnp.float32))
    nz = np.asarray(jax.random.normal(k_n, (2, 2 + 15, 53, batch), jnp.float32))
    c = lambda re, im: Cplx(torch.tensor(re), torch.tensor(im))  # noqa: E731
    return TG.GenDraws(c(tn[0], tn[1]), c(nz[0, 0], nz[1, 0]), c(nz[0, 1], nz[1, 1]),
                       c(nz[0, 2:], nz[1, 2:]))


TWIN_CASES = {"legacy-snr20": (None, 20.0), "A-snr35": ("A", 35.0), "C-snr20": ("C", 20.0)}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_assembly_matches_jax_twin(spectra, case):
    """Every output at the f32 tolerances: the twin scales each noise first
    and sums the channel in f32, the port at the kernel's rounding points
    and in f64, so they differ by f32 roundings only."""
    model, snr = TWIN_CASES[case]
    (jtxs, jtpre), port = spectra
    want = JG.fused_gen_chain(jnp.int32(3), B, jtxs, jtpre, snr_db=snr, eq_dtype=jnp.float32,
                              channel_model=model)
    draws = _twin_draws(3, B, channel.n_taps_for(model))
    got = TG.gen_assemble(draws, *port, snr_db=snr, eq_dtype=torch.float32, channel_model=model)
    tol = TOL["f32"]
    for name in (*TG._OUT_NAMES, "eq", "h_true"):
        lim = tol["eq"] if name == "eq" else tol.get(name, tol["h"])
        assert rel(to_np(got[name]), to_np(want[name])) < lim, (name, rel(to_np(got[name]),
                                                                         to_np(want[name])))
    np.testing.assert_allclose(to_np(got["ow2"]), to_np(want["ow2"]), rtol=1e-4)
    # the checksum sums ~2,000 signed terms per frame; on deep fades (channel
    # C) a few eq terms reach 1e3 and carry their own f32 differences, so the
    # bound is 1e-4 of each frame's Σ|term| rather than of the largest sum
    scale = sum(np.abs(to_np(got[n]).real).sum(axis=tuple(range(to_np(got[n]).ndim - 1)))
                + np.abs(to_np(got[n]).imag).sum(axis=tuple(range(to_np(got[n]).ndim - 1)))
                for n in (*TG._OUT_NAMES, "eq"))
    assert (np.abs(to_np(got["checksum"]) - to_np(want["checksum"])) <= 1e-4 * scale).all()


def test_bf16_checksum_follows_the_kernel(spectra):
    """The TPU kernel adds eq to the checksum in f32, before its bf16 cast
    (gen_chain.py:294-299); the twin after it (:542-545).  The port follows
    the kernel, so against the twin its checksum differs by exactly
    Σ(bf16(eq) − eq), up to f32 summation order."""
    (jtxs, jtpre), port = spectra
    want = JG.fused_gen_chain(jnp.int32(4), B, jtxs, jtpre, eq_dtype=jnp.bfloat16)
    draws = _twin_draws(4, B, TG.N_TAPS)
    got = TG.gen_assemble(draws, *port)
    f32 = TG.gen_assemble(draws, *port, eq_dtype=torch.float32)
    assert got["eq"].re.dtype == torch.bfloat16
    assert torch.equal(got["checksum"], f32["checksum"])
    gap = sum((c.to(torch.bfloat16).double() - c.double()).sum((0, 1)) for c in f32["eq"]).numpy()
    # the f32 checksum tolerance (1e-4 of the largest checksum) holds once
    # the gap is added, and the gap is far above it (measured: 3.9 against a
    # largest checksum of ~2e3)
    want_chk = to_np(want["checksum"])
    assert np.abs(gap).max() > 10 * 1e-4 * np.abs(want_chk).max()
    assert rel(to_np(got["checksum"]) + gap, want_chk) < 1e-4


# -- statistics and the contract of the port's own draws -----------------------------------------


def test_contract_statistics_determinism(spectra):
    """tests/test_stream.py:227-259 on the port: NMSE bounds at SNR 35, σ̂²
    unbiased, determinism and seed sensitivity."""
    _, port = spectra
    out = TG.fused_gen_chain(7, B, *port, snr_db=35.0)
    h = to_np(out["h_true"])
    assert out["eq"].re.shape == (15, 53, B) and out["eq"].re.dtype == torch.bfloat16
    for name, bound_db in (("h_lt", -12.0), ("h_mmse", -12.0), ("h_wiener", -5.0)):
        e = to_np(out[name])
        nmse = 10 * np.log10(np.sum(np.abs(e - h) ** 2) / np.sum(np.abs(h) ** 2))
        assert nmse < bound_db, (name, nmse)
    # unit channel power on average (the PDP is normalized)
    assert abs(np.mean(np.abs(h) ** 2) - 1.0) < 0.1
    target = 10 ** (-3.5) / 64
    assert abs(float(out["ow2"].mean()) - target) / target < 0.2
    again = TG.fused_gen_chain(7, B, *port, snr_db=35.0)
    assert torch.equal(out["h_mmse"].re, again["h_mmse"].re)
    other = TG.fused_gen_chain(8, B, *port, snr_db=35.0)
    assert not torch.equal(out["h_mmse"].re, other["h_mmse"].re)


def test_noise_power_unbiased_over_many_frames(spectra):
    """E[σ̂²] = σ_t² (the 64/53 factor): the mean over 2,048 frames within
    2% (its standard error is ~0.4%)."""
    _, port = spectra
    out = TG.fused_gen_chain(1, 2048, *port, snr_db=20.0)
    target = 10 ** (-2.0) / 64
    assert abs(float(out["ow2"].double().mean()) - target) / target < 0.02


def test_stream_sums_match_full_run(spectra):
    """tests/test_stream.py:262-294 on the port: the sums equal those of the
    full run, the record is its last 128 frames, the checksum equal."""
    _, port = spectra
    full = TG.fused_gen_chain(5, B, *port, snr_db=30.0)
    st = TG.fused_gen_chain(5, B, *port, snr_db=30.0, stream_sums=True)
    assert st["sums"].shape == (8, 128)
    h = full["h_true"].to_complex(torch.complex128)
    want = [float((full[n].to_complex(torch.complex128) - h).abs().square().sum())
            for n in TG._OUT_NAMES] + [float(h.abs().square().sum())]
    np.testing.assert_allclose(st["sums"].double().sum(-1).numpy(), want, rtol=1e-5)
    for name in (*TG._OUT_NAMES, "h_true", "eq"):
        for a, b in zip(st[name], full[name]):
            assert torch.equal(a, b[..., -128:]), name
    assert torch.equal(st["ow2"], full["ow2"][-128:])
    assert torch.equal(st["checksum"], full["checksum"])


def test_entry_checks_and_never_falls_back(spectra):
    _, port = spectra
    with pytest.raises(ValueError, match="multiple of 128"):
        TG.fused_gen_chain(0, 100, *port)
    meta = [c.map(lambda t: t.to("meta")) for c in port]
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        TG.fused_gen_chain(0, 128, *meta)
