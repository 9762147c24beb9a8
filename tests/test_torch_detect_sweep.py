"""Detection's threshold sweep, emulated on the CPU.

``csrc/detect.cuh`` (``sweep``, phase 1 of ``detect::run``) forms the
Schmidl & Cox metric of a block's 32 streams over the grid in grid order, a
tile of points at a time taken by the whole block, and stops after the tile
in which every live stream has its first crossing.  On a grid of stride 16
and up warp g sums block i + NB - 1 of the tile's point i = i0 + g (the first
tile also blocks 0 .. NB - 2) into a ring of RING slots in shared memory, and
after a barrier forms point i's window from blocks i .. i + NB - 1 added in
that order; finer grids give each warp a part of 64/stride points and a
running window restarted at the part's first point.  A stream whose
crossing the block has seen stops reading; an undetected stream keeps its
peak metric over the points before 2·search as the sweep passes them.

This file emulates that in float64 torch: the products and block sums in
the kernel's order, the ring and its slots, the stop vote, the lanes that
stop reading, the dead lanes.  Its detections, coarse rows and undetected
peaks must equal ``detect_plain``'s (and its detections the benchmark
reference's) bit for bit, on blocks built to catch a sweep that stops too
early: a stream that crosses only at the last grid point, crossings on a
tile's last point, an undetected stream among detected ones, dead lanes,
and NaN rows after every crossing.  The card tests hold the kernels to the
plain version and to their full-sweep twin.
"""

import math
import re

import numpy as np
import pytest
import torch

from perfbench.reference import detect as ref
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import _build
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import detect_variants as DV

from _torch_inputs import (lts_taps, nan_after_crossings, storage_planes, sweep_streams,
                           sweep_tile)

F64 = torch.float64
SOURCE = (_build.CSRC / "detect.cuh").read_text()
NS, SEARCH, THRESHOLD = 2048, 192, 0.5


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", SOURCE).group(1))


LAG, LANES, WARPS, RING = (_constant(n) for n in ("LAG", "LANES", "WARPS", "RING"))
REST_AT = 16 * (8 + 72) + 8 * 256 * 2 + 4 * 256 + 4 * 32 * 5  # offsetof(Smem, rest)
SWEEP_BYTES = 8 * RING * 4 * LANES + 4 * 2 * WARPS            # sizeof(Sweep)
PAIR_BYTES = {"f32": 8, "bf16": 4, "int8": 2}


def test_the_emulated_sweep_is_the_kernels():
    assert (LAG, LANES, WARPS, RING) == (64, 32, 8, 16)
    assert WARPS + LAG // 16 - 1 <= RING  # a tile's blocks and those it carries
    for line in ("double sums[RING][4][LANES];", "unsigned int hit[2][WARPS];",
                 "const int part = NB ? 1 : LAG / stride;",
                 "const unsigned dead = ~__ballot_sync(FULL, live);",
                 "if (NB > 1 && g < NB - 1 && active) put(sw, g, lane, "
                 "block_sums<S, SWEEP_UNROLL>(x, g * S));",
                 "for (int i0 = 0, k = 0; i0 < nm; i0 += WARPS * part, k ^= 1) {",
                 "const int i = i0 + g;",
                 "put(sw, i + NB - 1, lane, block_sums<S, SWEEP_UNROLL>(x, (i + NB - 1) * S));",
                 "Win w = get(sw, i, lane);",
                 "for (int b = 1; b < NB; ++b) w.add(get(sw, i + b, lane));",
                 "scan_running(x, stride, i0 + g * part, min(nm, i0 + (g + 1) * part), ",
                 "seen |= __ballot_sync(FULL, hit);", "if (lane == 0) sw.hit[k][g] = seen;",
                 "for (int w = 0; w < WARPS; ++w) hits |= sw.hit[k][w];",
                 "if (hits == FULL) break;", "active = live && !(hits >> lane & 1u);",
                 "sw.sums[b & (RING - 1)]",
                 "for (int j = d; j < d + N; ++j) w.add(x, j, 1.0);",
                 "for (int j = i0 * stride; j < i0 * stride + LAG; ++j) w.add(x, j, 1.0);",
                 "w.add(x, d + j, -1.0);", "w.add(x, d + LAG + j, 1.0);",
                 "pr += sign * (a.x * b.x + a.y * b.y);", "pi += sign * (a.y * b.x - a.x * b.y);",
                 "e1 += sign * (a.x * a.x + a.y * a.y);", "e2 += sign * (b.x * b.x + b.y * b.y);",
                 "return (pr * pr + pi * pi) / fmax(e1 * e2, 1e-30);",
                 "const int i_pk = min(nm, (2 * c.search + st - 1) / st);",
                 "Scan r{nm, 0.0};", "if (i < i_pk) r.peak = fmax(r.peak, m);",
                 "const bool hit = m > threshold;", "if (hit && r.first == nm) r.first = i;",
                 "case 16: r = sweep<4>(", "case 32: r = sweep<2>(", "case 64: r = sweep<1>(",
                 "default: r = sweep<0>(", "s.ired[g * LANES + lane] = r.first;",
                 "s.dred[g * LANES + lane] = r.peak;",
                 "for (int w = 0; w < WARPS; ++w) peak = fmax(peak, s.dred[w * LANES + lane]);"):
        assert line in SOURCE, line


@pytest.mark.parametrize("storage", list(PAIR_BYTES))
def test_the_ring_fits_where_the_stage_will_lie(storage):
    """Phase 1 keeps its ring in Smem::rest; at every search and stride the
    stage and |MF| values need more, so the ring never grows the block's
    shared memory."""
    for stride in (1, 2, 4, 8, 16, 32, 64):
        for search in range(1, D.MAX_SEARCH + 1):
            sf = search + (stride if stride > 1 else 0)
            n_mf = 2 * sf + 68
            sp = (-(-n_mf // 128) * 128 + LAG) | 1
            for lg in range(5, -1, -1):   # detect::layout's group
                rest = (PAIR_BYTES[storage] * (sp << lg) + 15) // 16 * 16 + 4 * ((n_mf | 2) << lg)
                if REST_AT + rest <= 96 * 1024 or lg == 0:
                    break
            assert rest >= SWEEP_BYTES, (stride, search)


def _grid(stride: int) -> int:
    return (NS - LAG) // stride - LAG // stride + 1


def emulate_block(xr: torch.Tensor, xi: torch.Tensor, live: torch.Tensor, stride: int):
    """Phase 1 on one block: (NS, 32) float64 planes (the storage's values),
    ``live`` (32,) bool.  Returns the warps' first crossings and peaks
    (WARPS, 32), and the products the tiles taken span (bool, NS − 64)."""
    nb = LAG // stride if stride >= 16 else 0
    part, s = (1, LAG // nb) if nb else (LAG // stride, 1)
    nm = _grid(stride)
    i_pk = min(nm, -(-2 * SEARCH // stride))
    ar, ai, br, bi = xr[:-LAG], xi[:-LAG], xr[LAG:], xi[LAG:]
    prod = torch.stack([ar * br + ai * bi, ai * br - ar * bi, ar * ar + ai * ai,
                        br * br + bi * bi])                    # (4, NS − 64, 32)
    first = torch.full((WARPS, LANES), nm)
    peak = torch.zeros((WARPS, LANES), dtype=F64)
    ring = torch.full((RING, 4, LANES), float("nan"), dtype=F64)
    hit_words = [[0] * WARPS for _ in range(2)]
    seen = [0] * WARPS
    bits = 1 << torch.arange(LANES)
    dead = int(bits[~live].sum())
    taken = torch.zeros(NS - LAG, dtype=torch.bool)
    active = live.clone()

    def metric(w):
        return (w[0] * w[0] + w[1] * w[1]) / torch.fmax(w[2] * w[3], torch.tensor(1e-30, dtype=F64))

    def put_block(b, act):
        acc = torch.zeros((4, LANES), dtype=F64)
        for j in range(b * s, b * s + s):
            acc = acc + prod[:, j]
        ring[b % RING][:, act] = acc[:, act]   # a lane that is not active writes nothing
        taken[b * s:b * s + s] = True

    def visit(g, i, m, act):
        if i < i_pk:
            peak[g, act] = torch.fmax(peak[g, act], m[act])
        hit = act & (m > THRESHOLD)
        first[g, hit & (first[g] == nm)] = i
        return hit

    for g in range(nb - 1):
        put_block(g, active)
    for tile, i0 in enumerate(range(0, nm, WARPS * part)):
        k = tile & 1
        hit = torch.zeros((WARPS, LANES), dtype=torch.bool)
        if nb:
            for g in range(WARPS):
                if i0 + g < nm:
                    put_block(i0 + g + nb - 1, active)
            for g in range(WARPS):            # after the barrier
                i = i0 + g
                if i < nm:
                    w = ring[i % RING].clone()
                    for b in range(1, nb):
                        w = w + ring[(i + b) % RING]
                    hit[g] = visit(g, i, metric(w), active)
        else:
            for g in range(WARPS):
                lo, hi = i0 + g * part, min(nm, i0 + (g + 1) * part)
                if lo >= hi:
                    continue
                taken[lo * stride:(hi - 1) * stride + LAG] = True
                go = active.clone()          # each lane stops at its crossing
                w = torch.zeros((4, LANES), dtype=F64)
                for j in range(lo * stride, lo * stride + LAG):
                    w = w + prod[:, j]
                i = lo
                while True:
                    h = visit(g, i, metric(w), go)
                    hit[g] |= h
                    go &= ~h
                    i += 1
                    if i >= hi:
                        break
                    d = (i - 1) * stride
                    for j in range(stride):
                        w = w - prod[:, d + j]
                        w = w + prod[:, d + LAG + j]
        for g in range(WARPS):
            seen[g] |= int(bits[hit[g]].sum())
            hit_words[k][g] = seen[g]
        hits = dead
        for g in range(WARPS):                # after the barrier: every thread reads the same
            hits |= hit_words[k][g]
        if hits == (1 << LANES) - 1:
            break
        active = live & ((hits & bits) == 0)
    return first, peak, taken


def emulate(x: Cplx, stride: int):
    """Phase 1 over (NS, B) planes in their storage type, block by block,
    then ``run``'s reduction: (detected, coarse (−1 where undetected), the
    undetected streams' peak as float32 (0 elsewhere), taken (blocks,
    NS − 64))."""
    xr, xi = (v.to(torch.float32).to(F64) for v in x)
    b = xr.shape[1]
    nm = _grid(stride)
    det, coarse, peak, taken = [], [], [], []
    for b0 in range(0, b, LANES):
        n = min(LANES, b - b0)
        pad = lambda v: torch.cat([v[:, b0:b0 + n], torch.zeros((NS, LANES - n), dtype=F64)], 1)
        live = torch.arange(LANES) < n
        first, pk, tk = emulate_block(pad(xr), pad(xi), live, stride)
        cross = first.min(0).values
        d = live & (cross < nm)
        c = torch.clamp(cross * stride - stride, min=0) if stride > 1 else cross
        p = torch.where(live & ~d, pk.amax(0), 0.0)   # fmax over warps: no NaN in them here
        det.append(d[:n])
        coarse.append(torch.where(d, c, -1)[:n])
        peak.append(p.to(torch.float32)[:n])
        taken.append(tk)
    return torch.cat(det), torch.cat(coarse).to(torch.int32), torch.cat(peak), torch.stack(taken)


def _taps() -> Cplx:
    h = lts_taps()
    return Cplx(torch.tensor(h.real.copy()), torch.tensor(h.imag.copy()))


@pytest.mark.parametrize("stride", [16, 32, 64, 8])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_sweep_equals_the_plain_detection(storage, stride):
    """Detections, coarse rows and the undetected stream's peak of the
    emulated sweep are detect_plain's bit for bit (its detections also the
    reference's), with NaN rows after every crossing (int8 has no NaN);
    block 0 sweeps the whole grid, block 1 stops early, and its tiles end
    at the tile of its last first crossing."""
    x = sweep_streams(stride)
    clean = Cplx(*storage_planes(x, storage))
    want = D.detect_plain(clean, _taps(), THRESHOLD, SEARCH, decimate=stride)
    nm, tile = _grid(stride), sweep_tile(stride)
    c = want.coarse.long() // stride + 1
    assert want.detected[[0, 1, 33]].all() and not want.detected[2]
    assert c[[0, 1, 33]].tolist() == [nm - 1, tile - 1, 2 * tile - 1]
    if storage != "int8":
        x = nan_after_crossings(x, want.detected, want.coarse, stride)
    planes = Cplx(*storage_planes(x, storage))
    want = D.detect_plain(planes, _taps(), THRESHOLD, SEARCH, decimate=stride)
    got_det, got_coarse, got_peak, taken = emulate(planes, stride)
    assert torch.equal(got_det, want.detected)
    assert torch.equal(got_coarse, want.coarse)
    undetected = ~want.detected
    assert torch.equal(got_peak[undetected], want.metric[undetected])
    assert float(want.metric[2]) > 0
    xr, xi = (v.to(torch.float32).to(F64) for v in planes)
    lts = tuple(torch.tensor(v.copy(), dtype=torch.float32) for v in (lts_taps().real,
                                                                      lts_taps().imag))
    assert torch.equal(got_det, ref.detect(xr, xi, lts, THRESHOLD, SEARCH, 4, stride)["detected"])
    # block 0 holds an undetected stream: every product; block 1 stops at the
    # tile of its last first crossing
    assert bool(taken[0].all())
    last = int(c[32:][want.detected[32:]].max())
    points = min(nm, (last // tile + 1) * tile)
    assert int(taken[1].sum()) == min(NS - LAG, (points - 1) * stride + LAG) < NS - LAG


@pytest.mark.parametrize("stride", [16, 64, 8])
def test_swept_share_counts_the_emulated_sweep(stride):
    """``swept_share`` from the detection rows alone is the share of every
    stream's products that the emulated sweep's tiles span, block by block,
    over ragged blocks and streams that cross at the first grid point."""
    x = sweep_streams(stride, seed=4, b=93)
    x[64:69, :] = x[64:69, :] * 0 + x[64:69, :1]   # constant streams: M = 1 from point 0
    planes = Cplx(*storage_planes(x, "bf16"))
    det, coarse, _, taken = emulate(planes, stride)
    assert bool((coarse[64:69] == 0).all())
    brute = float(taken.sum()) / taken.numel()
    assert DV.swept_share(det, coarse, stride, NS) == pytest.approx(brute, rel=0, abs=1e-12)
    assert 0 < brute < 1


def test_swept_share_by_hand():
    """One block whose last first crossing lies at grid point 39 (stride
    16: tiles 0-4, 40 points, blocks 0 .. 42 of 124), one with an
    undetected stream (all 124), one ragged block of 3 streams crossing at
    point 7 (tile 0: blocks 0 .. 10)."""
    det = torch.ones(67, dtype=torch.bool)
    coarse = torch.full((67,), 16 * 5, dtype=torch.int32)
    coarse[5] = 16 * 38                 # point 39
    det[40] = False
    coarse[40] = -1
    coarse[64:] = 16 * 6               # point 7
    assert DV.swept_share(det, coarse, 16, NS) == pytest.approx((43 + 124 + 11) / (3 * 124))
    assert DV.swept_share(det[:32], coarse[:32], 16, NS) == pytest.approx(43 / 124)
    # full resolution: coarse is the crossing (608, in tile 1 of 512 points)
    assert DV.swept_share(det[:32], coarse[:32], 1, NS) == pytest.approx((1023 + 64) / (NS - 64))
    assert math.isclose(DV.swept_share(det[32:64], coarse[32:64], 64, NS), 1.0)
