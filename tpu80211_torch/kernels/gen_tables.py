"""The constants of ``csrc/gen.cuh``'s Box-Muller: its logarithm table (and
the C text that holds it) and the splits of ln 2 and pi/2.

    python -m tpu80211_torch.kernels.gen_tables   # prints them as C

``gen::ln_uniform`` takes ln u of a uniform u in (0, 1] (an f32 value) as
e ln 2 + ln y with y in [0.75, 1.5), then ln y = -ln R + ln(1 + t), t =
y R - 1, from the entry of y's interval: the top 8 bits of u's mantissa
pick one of 256 intervals (width 2^-8 of y in [1, 1.5), 2^-9 of y in
[0.75, 1), where u's mantissa is 1.5 or more and y is half of it).  R is
an f32 value close to 1 over the interval's centre, so y R is exact in
f64; R is 1 on the two intervals that touch 1 (there ln u near 0 keeps its
relative precision).  -ln R is kept as hi + lo: hi a multiple of 2^-45
(so e ln2_hi + hi is exact in f64), lo an f32 correction.  The values are
computed here in 60-digit decimal arithmetic; a CPU test holds the header
to them.

``gen::sincos_turn`` reduces the angle by n pi/2 (n <= 4) with pi/2 in
three parts, the first two on a 45-bit grid so that n times them is exact.
"""

from __future__ import annotations

import decimal
import re

import numpy as np

N_BITS = 8
QUANTUM = 2 ** -45  # hi's grid: e ln2_hi + hi is exact for |e| <= 26
PI = "3.14159265358979323846264338327950288419716939937510582097494459"


def _ln(x: decimal.Decimal) -> decimal.Decimal:
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        return x.ln()


def interval(i: int) -> tuple[float, float]:
    """[lo, hi) of y for mantissa index ``i``."""
    lo, hi = 1 + i / 2 ** N_BITS, 1 + (i + 1) / 2 ** N_BITS
    return (lo / 2, hi / 2) if i >= 2 ** (N_BITS - 1) else (lo, hi)


def entry(i: int) -> tuple[np.float32, float, np.float32]:
    """(R, hi, lo) of interval ``i``: -ln R = hi + lo to about 2^-70."""
    lo, hi = interval(i)
    r = np.float32(1.0) if i in (0, 2 ** N_BITS - 1) else np.float32(2.0 / (lo + hi))
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        neg_ln = -_ln(decimal.Decimal(float(r)))
        q = decimal.Decimal(QUANTUM)
        h = (neg_ln / q).to_integral_value(rounding=decimal.ROUND_HALF_EVEN) * q
        return r, float(h), np.float32(float(neg_ln - h))


def ln2_split() -> tuple[float, float]:
    """ln 2 as hi (a multiple of 2^-45) + lo (f64)."""
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        ln2 = _ln(decimal.Decimal(2))
        q = decimal.Decimal(QUANTUM)
        h = (ln2 / q).to_integral_value(rounding=decimal.ROUND_HALF_EVEN) * q
        return float(h), float(ln2 - h)


def pio2_split() -> tuple[float, float, float]:
    """pi/2 = p1 + p2 + p3 (to about 2^-150): p1 and p2 with 45 significant
    bits."""
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        rest = decimal.Decimal(PI) / 2
        parts = []
        for _ in range(2):
            _, exp = np.frexp(float(rest))
            q = decimal.Decimal(2) ** (int(exp) - 45)
            part = (rest / q).to_integral_value(rounding=decimal.ROUND_HALF_EVEN) * q
            parts.append(float(part))
            rest -= part
        return parts[0], parts[1], float(rest)


def hex_float(x: float) -> str:
    """``x`` as a C hex float with no trailing zeros."""
    return re.sub(r"\.?0*p", "p", float(x).hex())


def c_table() -> str:
    """The table's C initializer, one entry a line, as gen.cuh holds it."""
    lines = []
    for i in range(2 ** N_BITS):
        r, h, lo = entry(i)
        lines.append(f"    {{{hex_float(r)}f, {hex_float(lo)}f, {hex_float(h)}}},")
    return "\n".join(lines)


if __name__ == "__main__":
    hi, lo = ln2_split()
    print(f"LN2_HI = {hex_float(hi)}, LN2_LO = {hex_float(lo)}")
    print("PIO2_1..3 = " + ", ".join(hex_float(x) for x in pio2_split()))
    print(c_table())
