"""The synced chain's derotation phases, emulated on the CPU.

``csrc/chain.cuh`` takes the cos and sin of each derotated sample's f32
angle ang = fl(w t), w = fl(-2 pi cfo), from e^{i w t} in f64: the product
of two phase factors (x for the window's base plus 8j, y for the row r),
turned by the f32 angle's rounding error to second order, with a guard that
hands any value too near an f32 rounding midpoint to the library's
sincos(ang).  This file emulates that arithmetic in plain float64 torch
(products and sums rounded one by one, where the kernel fuses some: one
rounding more, which the guard's margin covers) and holds it to
torch.cos / torch.sin of the f64 angle rounded to f32, bit for bit, over
every t the kernel derotates.  The kernel derotates so where the windows
move in runs of 8 frames; the card tests hold it to a build that calls the
library for every sample.
"""

import math
import re

import pytest
import torch

from tpu80211_torch.kernels import _build

F32, F64, I32 = torch.float32, torch.float64, torch.int32
NEG_TWO_PI = torch.tensor(-6.28318530717958647692, dtype=F32)
PREAMBLE, N_CP, SAMP_PER_BLOCK, LTS0, LTS1 = 160, 16, 80, 32, 96
N_AVG, N_BLOCKS = 4, 15
SOURCE = (_build.CSRC / "chain.cuh").read_text()


def _constant(name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1)


# the guard's constants, as the kernel states them
TWO_K = int(_constant("GUARD_2K"))
CHEAP = TWO_K << 10
MID, LOW = 1 << 28, (1 << 29) - 1
SHIFTS = int(_constant("GUARD_SHIFTS"))
COS_EM = int(_constant("COS_EM"))
SMALL = float.fromhex(_constant("SMALL_ANGLE").rstrip("f"))


def test_the_emulated_guard_is_the_kernels():
    assert (TWO_K, SHIFTS, COS_EM, SMALL) == (128, 20, 1022, 2.0 ** -13)
    assert "and K = 64." in SOURCE and _constant("F32_TO_F64_EXP") == "896"
    assert _constant("GUARD_CHEAP") == "GUARD_2K << 10"
    for line in ("const uint32_t shift = em - ex;", "return shift <= GUARD_SHIFTS && low > 2u * ulps;",
                 "(static_cast<uint32_t>(__double2loint(x)) + ulps - GUARD_MID) & GUARD_LOW;",
                 "return fabsf(xf) >= floor && low > 2u * GUARD_CHEAP;",
                 "far_from_midpoint(cs.x, r.x, 0x1p-10f)",
                 "far_from_midpoint(cs.y, r.y, sine_scale(ang) * 0x1p-9f)",
                 "return fminf(fabsf(ang) * 1.0001f, 1.f);"):
        assert line in SOURCE, line


def _lib(x: torch.Tensor):
    return torch.cos(x), torch.sin(x)


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[1] * b[0] + a[0] * b[1]


def _rows(x, y, n):
    """x[n // 8] y[n % 8] for the rows n of a window."""
    return _cmul((x[0][n // 8], x[1][n // 8]), (y[0][n % 8], y[1][n % 8]))


def phases(w: torch.Tensor):
    """(t, e^{i w t}) for every derotated sample of a frame, as the kernel
    forms them: the two LTS repeats, then windows 0..18 (blocks 0..3, then
    0..14), each window's x from the library in every fourth window and one
    step of 80 samples on in the others."""
    wd = w.double()
    j = torch.arange(8, dtype=F64)
    y = _lib(wd * j)
    y = (torch.where(j == 0, 1.0, y[0]), torch.where(j == 0, 0.0, y[1]))
    n = torch.arange(64)
    first = _rows(_lib(wd * (LTS0 + 8 * j)), y, n)
    ts, es = [LTS0 + n, LTS1 + n], [first, _cmul(first, _lib(wd * (LTS1 - LTS0)))]
    step, x = _lib(wd * SAMP_PER_BLOCK), None
    for i in range(N_AVG + N_BLOCKS):
        base = PREAMBLE + (i if i < N_AVG else i - N_AVG) * SAMP_PER_BLOCK + N_CP
        x = _lib(wd * (base + 8 * j)) if i % 4 == 0 else _cmul(x, step)
        ts.append(base + n)
        es.append(_rows(x, y, n))
    return torch.cat(ts), (torch.cat([e[0] for e in es]), torch.cat([e[1] for e in es]))


def _far_from_midpoint(x, xf, floor):
    """The kernel's cheap test: |xf| >= floor and x's low 29 bits further
    than 2K << 10 from the f32 rounding midpoint."""
    low = ((x.view(torch.int64) & 0xFFFFFFFF) + CHEAP - MID) & LOW
    return (xf.abs() >= floor) & (low > 2 * CHEAP)


def _clear_of_midpoint(x, em):
    """The kernel's integer test: x's low 29 bits further than 2K << (em - ex)
    from the f32 rounding midpoint, em - ex in 0..20 (ex x's exponent)."""
    bits = x.view(torch.int64)
    shift = em - ((bits >> 52) & 0x7FF)
    ulps = TWO_K << shift.clamp(0, 31)
    low = ((bits & 0xFFFFFFFF) + ulps - MID) & LOW
    return (shift >= 0) & (shift <= SHIFTS) & (low > 2 * ulps)


def cis(w: torch.Tensor, t: torch.Tensor, e):
    """The kernel's cis: (cos, sin, took the library, ang) for the angles
    fl(w t) given e = e^{i w t}."""
    tf = t.to(F32)
    ang = w * tf
    a = w.double() * tf.double() - ang.double()  # exact: the product's rounding error
    ah = 0.5 * a
    c_, s_ = e
    c = c_ + a * (s_ - ah * c_)
    s = s_ - a * (c_ + ah * s_)
    cf, sf = c.float(), s.float()
    aa = ang.abs()
    m = torch.clamp(aa * torch.tensor(1.0001, dtype=F32), max=1.0)
    sine_em = (m.view(I32) >> 23).long() + 896
    small = aa < SMALL
    cheap = _far_from_midpoint(c, cf, 2.0 ** -10) & _far_from_midpoint(s, sf, m * 2.0 ** -9)
    exact = _clear_of_midpoint(c, COS_EM) & _clear_of_midpoint(s, sine_em)
    library = ~small & ~cheap & ~exact
    want = _reference(ang)
    cf = torch.where(small, 1.0, torch.where(library, want[0], cf))
    sf = torch.where(small, ang, torch.where(library, want[1], sf))
    return cf, sf, library, ang


def _reference(ang: torch.Tensor):
    """The library's value: cos and sin of the f64 angle, rounded to f32."""
    return torch.cos(ang.double()).float(), torch.sin(ang.double()).float()


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(I32)


def derotate_frame(cfo: float):
    w = NEG_TWO_PI * torch.tensor(cfo, dtype=F32)
    t, e = phases(w)
    cf, sf, library, ang = cis(w, t, e)
    return cf, sf, library, ang, t


def _near_a_zero(ang: torch.Tensor) -> torch.Tensor:
    """Angles within 2^-10 of a multiple of pi/2, where cos or sin is too
    small for the factors' absolute error."""
    a = ang.double()
    return (a - torch.round(a / (math.pi / 2)) * (math.pi / 2)).abs() < 2.0 ** -10


def _jittered(n: int, seed: int, kind: str) -> list[float]:
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(n, generator=gen, dtype=F64).tolist()
    if kind == "cell":  # 20 kHz at 20 MS/s, +-10%, either sign
        return [(1e-3 * (0.9 + 0.2 * v)) * (-1) ** i for i, v in enumerate(u)]
    return [(2 * v - 1) / 128 for v in u]  # any CFO the estimate can give


GRID = {"0": 0.0, "+1e-9": 1e-9, "-1e-9": -1e-9, "+1/128": 1 / 128, "-1/128": -1 / 128,
        "+1e-3": 1e-3, "-1e-3": -1e-3,
        **{f"cell{i}": c for i, c in enumerate(_jittered(6, 1, "cell"))},
        **{f"any{i}": c for i, c in enumerate(_jittered(4, 2, "any"))}}


def test_the_frame_holds_every_time_the_kernel_derotates():
    t = derotate_frame(1e-3)[4]
    blocks = [PREAMBLE + b * SAMP_PER_BLOCK + N_CP + torch.arange(64) for b in range(N_BLOCKS)]
    assert t.numel() == 2 * 64 + (N_AVG + N_BLOCKS) * 64 == 1344
    assert torch.equal(t[:128], torch.arange(32, 160))
    assert torch.equal(t[128:], torch.cat(blocks[:N_AVG] + blocks))


@pytest.mark.parametrize("cfo", list(GRID.values()), ids=list(GRID))
def test_phases_are_the_librarys_bit_for_bit(cfo):
    """Every derotated sample's cos and sin equal the library value's f32
    rounding; the guard sends a sample to the library only where its angle
    lies near a zero of cos or sin (then the factors' absolute error is too
    coarse for the value's f32 spacing)."""
    cf, sf, library, ang, _ = derotate_frame(cfo)
    rc, rs = _reference(ang)
    assert torch.equal(_bits(cf), _bits(rc)) and torch.equal(_bits(sf), _bits(rs))
    assert bool(_near_a_zero(ang[library]).all()), ang[library]


@pytest.mark.parametrize("kind", ["cell", "any"])
def test_fallback_share_is_small(kind):
    """On CFOs spread as the cells' estimates spread (20 kHz +-10%) and over
    the whole range an estimate can take, fewer than 1e-4 of the derotated
    samples take the library, and every sample is the library's bits."""
    taken = total = 0
    for cfo in _jittered(150, 3, kind):
        cf, sf, library, ang, _ = derotate_frame(cfo)
        rc, rs = _reference(ang)
        assert torch.equal(_bits(cf), _bits(rc)) and torch.equal(_bits(sf), _bits(rs)), cfo
        taken += int(library.sum())
        total += library.numel()
    assert taken / total < 1e-4, (taken, total)


# f32 angles whose cos or sin (in f64) lies within 32 f64 ulps of a midpoint
# between two f32 values (found by scanning the f32 angles from 0.55 up)
NEAR_MIDPOINT = {"cos": ["0x1.0c4d4ap+0", "0x1.21497ep+1", "0x1.4b3ef8p+1"],
                 "sin": ["0x1.41f49cp+0", "0x1.3e42p+1", "0x1.ce1026p+2"]}


@pytest.mark.parametrize("fn", list(NEAR_MIDPOINT))
def test_near_midpoint_values_take_the_library(fn):
    """At t = 32 (w = ang / 32 exactly) the guard hands these angles to the
    library, and the result is the library's."""
    ang = torch.tensor([float.fromhex(h) for h in NEAR_MIDPOINT[fn]], dtype=F32)
    v = getattr(torch, fn)(ang.double())
    assert bool((((v.view(torch.int64) & LOW) - MID).abs() < 32).all())
    w = ang / 32
    t = torch.full_like(w, 32, dtype=torch.int64)
    assert torch.equal(w * 32, ang)
    cf, sf, library, got = cis(w, t, _lib(w.double() * 32))
    rc, rs = _reference(ang)
    assert torch.equal(got, ang) and bool(library.all())
    assert torch.equal(_bits(cf), _bits(rc)) and torch.equal(_bits(sf), _bits(rs))


def test_small_angles_round_to_one_and_the_angle():
    """Below 2^-13 the library's cos rounds to 1 and its sin to the angle
    itself: every f32 angle near the bound, subnormals and both zeros."""
    bound = torch.tensor(SMALL, dtype=F32).view(I32)
    near = (bound - torch.arange(1, 4096, dtype=I32)).view(F32)
    tiny = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-40, 2.0 ** -126, 1e-30, 3e-8],
                        dtype=F32)
    ang = torch.cat([near, -near, tiny])
    assert bool((ang.abs() < SMALL).all())
    rc, rs = _reference(ang)
    assert torch.equal(_bits(rc), _bits(torch.ones_like(ang)))
    assert torch.equal(_bits(rs), _bits(ang))
