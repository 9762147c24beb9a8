"""The matched filter's Toeplitz product on the FP64 tensor cores, emulated
on the CPU.

``csrc/detect.cuh`` (``mf_item``) takes the 64-tap matched filter over each
detected stream's staged window as a product on the tensor cores: offsets
q = 8a + b, the Hankel rows A[a][u] = x[8a + u] of the window times the
72 x 8 Toeplitz block of taps H[u][b] = h[u - b] (zero outside [0, 64)), as
yr = Xr Hr + Xi Hi and yi = Xi Hr + Xr (-Hi), a warp an item of 16 rows
(128 offsets) in K-steps of 4 (``mma.sync.m16n8k4`` with f64 operands and
sums).  This file emulates that in float64 torch: the stage of one stream
(its window, then zeros up to the row stride, NaN past it), each lane's
fragments by the kernel's maps, the products K-step by K-step, the items
rounded up past the window, the stores masked at its end.  The |MF|
values, rounded to float32, must equal ``detect_plain``'s and the benchmark
reference's bit for bit.  The card tests hold the kernels' detection to the
plain version.
"""

import re

import numpy as np
import pytest
import torch

from perfbench.reference import detect as ref
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import _build
from tpu80211_torch.kernels import detect_kernel as D

from _torch_inputs import lts_taps, make_streams

F32, F64 = torch.float32, torch.float64
SOURCE = (_build.CSRC / "detect.cuh").read_text()


def _constant(name: str) -> int:
    expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1)
    return eval(re.sub(r"[A-Z_]+", lambda m: str(_constant(m.group(0))), expr))


LAG, MF_ROWS, MF_K, H_PAD = (_constant(n) for n in ("LAG", "MF_ROWS", "MF_K", "H_PAD"))
MF_ITEM, MF_EXTRA, WIN_EXTRA = (_constant(n) for n in ("MF_ITEM", "MF_EXTRA", "WIN_EXTRA"))
SMEM_TARGET = _constant("SMEM_TARGET")
REST_AT = 16 * (H_PAD + MF_K) + 8 * 256 * 2 + 4 * 256 + 4 * 32 * 5  # offsetof(Smem, rest)
NS, SEARCH = 2048, 192
PAIR_BYTES = {"f32": 8, "bf16": 4, "int8": 2}
GROUP = {"f32": 8, "bf16": 16, "int8": 16}  # streams staged at once at the default search
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4  # a lane's group and its thread in the group


def test_the_emulated_tiling_is_the_kernels():
    assert (LAG, MF_ROWS, MF_K, H_PAD, MF_ITEM) == (64, 16, 72, 8, 128)
    assert (MF_EXTRA, WIN_EXTRA, SMEM_TARGET) == (68, 131, 96 * 1024)
    for line in ("double2 h[H_PAD + MF_K];",
                 "const int sp = ((n_mf + MF_ITEM - 1) / MF_ITEM * MF_ITEM + LAG) | 1;",
                 "const int ms = n_mf | 2;",
                 "const P* xa = x + 8 * g + t;",
                 "const double2* hb = h + H_PAD + t - g;",
                 "for (int k = 0; k < MF_K; k += 4) {",
                 "const double2 a0 = unpack(xa[k]), a1 = unpack(xa[k + LAG]);",
                 "mma_f64(yr, a0.x, a1.x, b.x);", "mma_f64(yr, a0.y, a1.y, b.y);",
                 "mma_f64(yi, a0.y, a1.y, b.x);", "mma_f64(yi, a0.x, a1.x, -b.y);",
                 "const int q = 8 * (g + 8 * (j >> 1)) + 2 * t + (j & 1);",
                 "if (q < n) mag[q] = static_cast<float>(sqrt(yr[j] * yr[j] + yi[j] * yi[j]));",
                 "mf_item(stage + j * sp + q0, s.h, t & 31, n - q0, mf + j * lay.mf_stride + q0);",
                 "for (int r = hi + (t >> lg); r < lo + sp; r += step) clear(dst[r]);",
                 "m16n8k4.row.col.f64.f64.f64.f64"):
        assert line in SOURCE, line


def layout(storage: str, stride: int) -> tuple:
    """``detect::layout``: (streams a group, staged rows a stream, |MF|
    offsets of a full window, |MF| values a stream, the block's bytes)."""
    sf = SEARCH + (stride if stride > 1 else 0)
    n_mf = 2 * sf + MF_EXTRA
    sp = (-(-n_mf // MF_ITEM) * MF_ITEM + LAG) | 1
    ms = n_mf | 2
    for lg in range(5, -1, -1):
        stage = (PAIR_BYTES[storage] * (sp << lg) + 15) // 16 * 16
        size = REST_AT + stage + 4 * (ms << lg)
        if size <= SMEM_TARGET or lg == 0:
            return 1 << lg, sp, n_mf, ms, size


def mf_items(stage: torch.Tensor, h: torch.Tensor, n: int) -> torch.Tensor:
    """|MF| at offsets [0, n) of one stream's stage (complex128 rows from its
    window's first), as the kernel's warps take them; float32 (n,)."""
    hp = torch.zeros(H_PAD + MF_K, dtype=torch.complex128)
    hp[H_PAD:H_PAD + LAG] = h
    out = torch.full((n,), float("nan"), dtype=F32)
    k = 4 * torch.arange(MF_K // 4)[:, None]  # (K-steps, 1)
    for q0 in range(0, n, MF_ITEM):
        rows = q0 + 8 * G + T + k              # a0: A[g][k + t]; a1 the row 64 on
        taps = H_PAD + T - G + k               # b: H[k + t][g]
        assert rows.min() >= 0 and int(rows.max()) + LAG < stage.numel()
        ar, ai = (torch.zeros((k.numel(), MF_ROWS, 4), dtype=F64) for _ in range(2))
        br, bi = (torch.zeros((k.numel(), 4, 8), dtype=F64) for _ in range(2))
        for a, bb, plane in ((ar, br, torch.real), (ai, bi, torch.imag)):
            a[:, G, T] = plane(stage[rows])
            a[:, G + 8, T] = plane(stage[rows + LAG])
            bb[:, T, G] = plane(hp[taps])
        yr = torch.zeros((MF_ROWS, 8), dtype=F64)
        yi = torch.zeros((MF_ROWS, 8), dtype=F64)
        for s in range(k.numel()):
            yr = yr + ar[s] @ br[s]
            yr = yr + ai[s] @ bi[s]
            yi = yi + ai[s] @ br[s]
            yi = yi + ar[s] @ -bi[s]
        for j in range(4):
            row, col = G + 8 * (j >> 1), 2 * T + (j & 1)
            q = 8 * row + col
            keep = q0 + q < n
            mag = torch.sqrt(yr[row, col] ** 2 + yi[row, col] ** 2).to(F32)
            out[q0 + q[keep]] = mag[keep]
    return out


def _streams(storage: str, seed: int) -> Cplx:
    """Lane-major (NS, 12) streams in the storage type: 6 with the capture's
    frame over 1e-4 AWGN, 6 of random samples at the frame's scale (int8:
    ADC words of the batch's full scale)."""
    x, _ = make_streams(seed=seed, b=6, ns=NS)
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal((6, NS)) + 1j * rng.standard_normal((6, NS))) * 0.05
    x = np.concatenate([x, noise])
    re, im = (torch.tensor(np.ascontiguousarray(v.T), dtype=F32) for v in (x.real, x.imag))
    if storage == "int8":
        lsb = max(float(re.abs().max()), float(im.abs().max())) / 127
        re, im = (torch.clamp(torch.round(v / lsb), -127, 127) for v in (re, im))
    return Cplx(re.to(STORAGE[storage]), im.to(STORAGE[storage]))


def _reference_mf(xr: torch.Tensor, xi: torch.Tensor, h: Cplx) -> torch.Tensor:
    """|MF| as perfbench/reference/detect.py's ``detect`` forms it."""
    wr, wi = ref._bands(h.re), ref._bands(h.im)
    n_chunks = (NS - ref.CHUNK) // LAG + 1
    cr = torch.stack([xr[c * LAG:c * LAG + ref.CHUNK] for c in range(n_chunks)])
    ci = torch.stack([xi[c * LAG:c * LAG + ref.CHUNK] for c in range(n_chunks)])
    yr = (wr @ cr + wi @ ci).reshape(-1, xr.shape[1])[:NS - LAG]
    yi = (wr @ ci - wi @ cr).reshape(-1, xr.shape[1])[:NS - LAG]
    return torch.sqrt(yr * yr + yi * yi).to(F32)


def test_reference_forms_the_matched_filter_as_emulated_here():
    text = open(ref.__file__).read()
    for line in ("yr = (wr @ cr + wi @ ci).reshape(-1, b)[:ns - LAG]",
                 "yi = (wr @ ci - wi @ cr).reshape(-1, b)[:ns - LAG]",
                 "mf = torch.sqrt(yr * yr + yi * yi).to(torch.float32).to(f64)"):
        assert line in text, line


@pytest.mark.parametrize("stride", [1, 16, 32, 64])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_toeplitz_tiles_equal_the_plain_matched_filter(storage, stride):
    """Windows at each frame's coarse hit, at random rows, and clipped at
    n_pair (NS - 132) and at NS: every |MF| value of the tiled product is
    the plain version's and the reference's, bit for bit; the group fits
    SMEM_TARGET with the streams the card tests expect, and every item's
    rows lie in its stream's stage."""
    gs, sp, n_mf, ms, size = layout(storage, stride)
    assert (gs, size <= SMEM_TARGET) == (GROUP[storage], True)
    assert sp >= -(-n_mf // MF_ITEM) * MF_ITEM + LAG and ms >= n_mf and ms % 4 == 2
    x = _streams(storage, seed=100 + stride)
    xr, xi = (v.to(F32).to(F64) for v in x)
    h = lts_taps()
    taps = Cplx(torch.tensor(h.real.copy()), torch.tensor(h.imag.copy()))
    want = D.mf_plain(xr, xi, taps)
    assert torch.equal(want, _reference_mf(xr, xi, taps))
    det = D.detect_plain(x, taps, decimate=stride if stride > 1 else False)
    sf = SEARCH + (stride if stride > 1 else 0)
    n_pair = NS - 2 * LAG - 4
    rng = np.random.default_rng(stride)
    hc = torch.tensor(h.astype(np.complex128))
    checked = 0
    for lane in range(xr.shape[1]):
        starts = [int(rng.integers(0, n_pair)), n_pair - 2 * sf + 3, n_pair - 1 - lane,
                  NS - 2 * sf - WIN_EXTRA + 5]
        if det.detected[lane]:
            starts.append(int(det.coarse[lane]))
        for lo in starts:
            i_end = min(lo + 2 * sf, n_pair)
            n = i_end - lo + MF_EXTRA
            hi = min(NS, lo + 2 * sf + WIN_EXTRA)
            # the stream's stage: its window, the rows the copy zeroes, then
            # what the stage holds past it (the next stream's rows, the |MF|)
            stage = torch.full((sp + 2 * MF_ITEM,), complex("nan+nanj"), dtype=torch.complex128)
            stage[:hi - lo] = torch.complex(xr[lo:hi, lane], xi[lo:hi, lane])
            stage[hi - lo:sp] = 0
            got = mf_items(stage, hc, n)
            assert torch.equal(got, want[lo:lo + n, lane]), (lane, lo)
            checked += n
    assert checked > 15_000
    assert det.detected[:6].all()
