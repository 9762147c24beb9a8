"""The plain reference of packet detection and frame extraction on raw
streams, in plain PyTorch and float64.

Lane-major (NS, B) planes, the stream axis last.  Per stream:

* coarse detection, the Schmidl & Cox lag-64 metric
  M(d) = |Σ_{k<64} x[d+k]·conj(x[d+64+k])|² / (Σ|x[d+k]|²·Σ|x[d+64+k]|²)
  on the grid d = i·stride (the lag products summed over each stride first),
  and the first crossing of ``threshold``;
* fine timing, the magnitude of the matched filter against the 64-sample
  LTS, summed over 5 samples and over the two repeats 64 apart, whose peak is
  searched in 2·(search + stride) positions from the coarse hit; the long
  preamble starts ``32 + advance`` samples before the first repeat;
* the 160 + 1200 frame rows cut at that start (clipped into the stream).

Float64 throughout (a float32 running sum drifts, and a drift can move a
crossing by a sample); the matched filter's magnitude is rounded to float32
once, as the program's kernel keeps it.  Imports nothing of the program.
"""

from __future__ import annotations

import torch

LAG = 64
WIN = 64
CHUNK = 2 * LAG
FRAME = 160 + 1200


def _window_sums(v: torch.Tensor, w: int) -> torch.Tensor:
    c = torch.cumsum(v, dim=0)
    c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)
    return c[w:] - c[:-w]


def _bands(h: torch.Tensor) -> torch.Tensor:
    """W[d, j] = h[j − d], d < 64, j < 128: one product with 128 rows of a
    stream gives the correlation at 64 offsets."""
    dev = h.device
    d = torch.arange(LAG, device=dev)[:, None]
    cols = d + torch.arange(LAG, device=dev)[None, :]
    w = torch.zeros((LAG, CHUNK), dtype=torch.float64, device=dev)
    w[d.expand(LAG, LAG), cols] = h.to(torch.float64)[None, :].expand(LAG, LAG)
    return w


def detect(xr: torch.Tensor, xi: torch.Tensor, lts: tuple, threshold: float, search: int,
           advance: int, stride: int) -> dict:
    """Detection of (NS, B) planes; ``lts`` (re, im) (64,) float32.  Returns
    detected (B,) bool and start (B,) int64 (−1 where undetected)."""
    f64 = torch.float64
    ns, b = xr.shape
    dev = xr.device
    xr, xi = xr.to(torch.float32).to(f64), xi.to(torch.float32).to(f64)

    ar, ai, br, bi = xr[:-LAG], xi[:-LAG], xr[LAG:], xi[LAG:]
    planes = (ar * br + ai * bi, ai * br - ar * bi, ar * ar + ai * ai, br * br + bi * bi)
    if stride > 1:
        nblk = (ns - LAG) // stride
        planes = [v[:nblk * stride].view(nblk, stride, b).sum(1) for v in planes]
        p_re, p_im, e1, e2 = (_window_sums(v, WIN // stride) for v in planes)
    else:
        p_re, p_im, e1, e2 = (_window_sums(v, WIN) for v in planes)
    m = (p_re * p_re + p_im * p_im) / torch.clamp(e1 * e2, min=1e-30)
    nm = m.shape[0]
    above = m > threshold
    det = above.any(0)
    cross = torch.where(det, above.to(torch.int8).argmax(0), nm)
    if stride > 1:
        coarse = torch.clamp(cross * stride - stride, min=0)
        search_fine = search + stride
    else:
        coarse, search_fine = cross, search

    wr, wi = _bands(lts[0]), _bands(lts[1])
    n_chunks = (ns - CHUNK) // LAG + 1
    cr = torch.stack([xr[c * LAG:c * LAG + CHUNK] for c in range(n_chunks)])
    ci = torch.stack([xi[c * LAG:c * LAG + CHUNK] for c in range(n_chunks)])
    yr = (wr @ cr + wi @ ci).reshape(-1, b)[:ns - LAG]
    yi = (wr @ ci - wi @ cr).reshape(-1, b)[:ns - LAG]
    mf = torch.sqrt(yr * yr + yi * yi).to(torch.float32).to(f64)
    mf2 = mf[:-1] + mf[1:]
    mf5 = (mf2[:-2] + mf2[2:])[:-1] + mf[4:]
    pair = mf5[:-LAG] + mf5[LAG:]
    idx = torch.arange(pair.shape[0], device=dev)[:, None]
    mask = (idx >= coarse) & (idx < coarse + 2 * search_fine)
    start = torch.where(mask, pair, 0.0).argmax(0) + 2 - 32 - advance
    return {"detected": det, "start": torch.where(det, start, torch.full_like(start, -1))}


def extract(xr: torch.Tensor, xi: torch.Tensor, start: torch.Tensor):
    """(packet (re, im) (1200, B), preamble (re, im) (160, B)) cut at each
    start (−1 taken as 0), clipped to [0, NS − 1360]; storage type kept."""
    ns = xr.shape[0]
    s = torch.clamp(start.to(torch.int64), 0, ns - FRAME)
    rows = s[None, :] + torch.arange(FRAME, device=s.device)[:, None]
    fr, fi = torch.gather(xr, 0, rows), torch.gather(xi, 0, rows)
    return (fr[160:], fi[160:]), (fr[:160], fi[:160])
