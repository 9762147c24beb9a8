"""Packet detection, alignment and stream placement on lane-major streams.

The counterpart of ``tpu80211/kernels/detect_kernel.py``.  Streams are
(NS, B) split planes, the stream axis last.  Two hand-written CUDA kernels
(``csrc/detect.cu``) do the work on the card:

* ``detect_streams`` / ``detect_and_align``: the Schmidl & Cox metric (full
  resolution or decimated), the LTS matched filter, timing, and with
  alignment each stream's 160 + 1200 frame rows cut at its start;
* ``place_streams``: each stream's frame rolled down by its offset, plus
  noise.

``detect_plain`` and ``place_plain`` are the same functions in plain
PyTorch; a wrapper runs them for CPU tensors only, and a CUDA tensor
launches the kernel or raises.  ``detect_plain`` follows
``_detect_core`` (``tpu80211/kernels/detect_kernel.py:98``), decimation
included, with its window sums and matched filter in float64: an f32
running sum drifts, and a drift can move a threshold crossing by a sample.
Unlike the TPU kernel, B need not be a multiple of 128.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import _ffi
from tpu80211_torch.kernels._ffi import DOUBLE, INT, INT_PTR, PTR, STORAGE
from tpu80211_torch.ops.detect import DEFAULT_THRESHOLD, LAG, WIN
from tpu80211_torch.utils import spans

FRAME = C.PREAMBLE_SAMPLES + C.PACKET_SAMPLES  # 1360 rows cut per stream
MIN_NS = -(-FRAME // LAG) * LAG                # 1408: the least multiple of 64 that holds a frame
MF_CHUNK = 2 * LAG                             # matched-filter rows per band product
MAX_SEARCH = 512  # the matched filter's window must fit one block's shared memory
PLACE_STORAGE = (torch.float32, torch.bfloat16)
_count_detect = spans.counter("launch.detect")
_count_place = spans.counter("launch.place")
LIB = _ffi.Library("detect", {
    "detect_launch": (PTR, INT, INT, INT, INT, DOUBLE, INT, INT, INT, INT, PTR),
    "place_launch": (PTR, INT, INT, INT, INT, INT, PTR),
    "detect_attributes": (INT, INT, INT, INT, INT_PTR),
    "place_attributes": (INT, INT, INT, INT, INT_PTR),
})


class Detection(NamedTuple):
    """Per-stream rows, (B,) each: int32 indices are −1 where undetected."""

    detected: torch.Tensor  # bool
    coarse: torch.Tensor    # int32, the first metric crossing (samples)
    start: torch.Tensor     # int32, the long preamble's first row
    metric: torch.Tensor    # float32, the peak metric in the search window


def stride_of(decimate) -> tuple[int, bool]:
    """``decimate`` → (metric grid step, decimated?): False → full
    resolution; True → 16; an int dividing 64 (2 … 64) → that stride."""
    if decimate is False or decimate is None or decimate == 0:
        return 1, False
    s = 16 if decimate is True else int(decimate)
    if s < 2 or WIN % s:
        raise ValueError(f"decimate must be False, True or a divisor of {WIN} "
                         f"from 2 to {WIN}, got {decimate!r}")
    return s, True


def mf_taps(lts_ref: Cplx) -> Cplx:
    """The matched filter's banded shift matrices, W[d, j] = h[j − d] for
    d < 64, j < 128: one product of W with 128 rows of a stream gives the
    correlation at 64 offsets (``detect_kernel._mf_bands`` of the JAX
    package).  Float32 on ``lts_ref``'s device."""
    dev = lts_ref.re.device
    d = torch.arange(LAG, device=dev)[:, None]
    cols = d + torch.arange(LAG, device=dev)[None, :]

    def band(h):
        w = torch.zeros((LAG, MF_CHUNK), dtype=torch.float32, device=dev)
        w[d.expand(LAG, LAG), cols] = h.to(torch.float32)[None, :].expand(LAG, LAG)
        return w

    return lts_ref.map(band)


def check_length(ns: int) -> None:
    """Raise unless ``ns`` rows are a multiple of 64 that holds a frame
    (at least ``MIN_NS``), as the kernels and the JAX detector take."""
    if ns % LAG or ns < MIN_NS:
        raise ValueError(f"NS must be a multiple of {LAG} that holds the {FRAME}-row frame "
                         f"(at least {MIN_NS}), got {ns}")


def _check_pair(name: str, x: Cplx, dtypes, like: torch.Tensor | None = None) -> None:
    """Raise unless ``x`` is two (NS, B) planes of one dtype of ``dtypes``,
    contiguous, with the shape and device of ``like`` (default: ``x.re``)."""
    like = x.re if like is None else like
    _ffi.check_planes(name, x, like.shape, dtypes, like.device)
    if x.im.dtype != x.re.dtype:
        raise TypeError(f"{name}: want one dtype, got {x.re.dtype} and {x.im.dtype}")
    if x.re.dim() != 2:
        raise ValueError(f"{name}: want (NS, B) planes, got {tuple(x.re.shape)}")


def check_lts_ref(lts_ref: Cplx, device: torch.device) -> None:
    """Raise unless ``lts_ref`` is the (64,) float32 LTS, contiguous on
    ``device``."""
    _ffi.check_planes("lts_ref", lts_ref, (LAG,), torch.float32, device)


def check_streams(x: Cplx, lts_ref: Cplx, search: int) -> None:
    """Raise on streams or taps the kernels do not take."""
    _check_pair("streams", x, STORAGE)
    ns, b = x.re.shape
    if b < 1:
        raise ValueError("empty batch")
    check_length(ns)
    if not 1 <= search <= MAX_SEARCH:
        raise ValueError(f"search must be in [1, {MAX_SEARCH}], got {search}")
    check_lts_ref(lts_ref, x.re.device)


# -- the plain versions -----------------------------------------------------------


def _window_sums(v: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding sums of ``w`` rows along axis 0: out[d] = Σ_{k<w} v[d+k]."""
    c = torch.cumsum(v, dim=0)
    c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)
    return c[w:] - c[:-w]


def mf_plain(xr: torch.Tensor, xi: torch.Tensor, lts_ref: Cplx) -> torch.Tensor:
    """The matched filter's magnitude |Σ_t x[d+t]·conj(h[t])| of (NS, B)
    float64 planes at every offset d < NS − 64, by banded products in
    float64, rounded to float32 once: (NS − 64, B)."""
    ns, b = xr.shape
    wr, wi = (t.to(torch.float64) for t in mf_taps(lts_ref))
    n_chunks = (ns - MF_CHUNK) // LAG + 1
    cr = torch.stack([xr[c * LAG:c * LAG + MF_CHUNK] for c in range(n_chunks)])
    ci = torch.stack([xi[c * LAG:c * LAG + MF_CHUNK] for c in range(n_chunks)])
    yr = (wr @ cr + wi @ ci).reshape(-1, b)[:ns - LAG]
    yi = (wr @ ci - wi @ cr).reshape(-1, b)[:ns - LAG]
    return torch.sqrt(yr * yr + yi * yi).to(torch.float32)


def detect_plain(x: Cplx, lts_ref: Cplx, threshold: float = DEFAULT_THRESHOLD,
                 search: int = 192, advance: int = 4, decimate=False) -> Detection:
    """Detection of lane-major (NS, B) streams in plain PyTorch, on any
    device: ``_detect_core``'s semantics, with its index conventions,
    decimation grid, windows and masks, in float64."""
    check_streams(x, lts_ref, search)
    stride, decimated = stride_of(decimate)
    f64 = torch.float64
    ns, b = x.re.shape
    dev = x.re.device
    xr, xi = x.re.to(torch.float32).to(f64), x.im.to(torch.float32).to(f64)

    # -- Schmidl & Cox: M on the grid d = i·stride --
    ar, ai, br, bi = xr[:-LAG], xi[:-LAG], xr[LAG:], xi[LAG:]
    planes = (ar * br + ai * bi, ai * br - ar * bi, ar * ar + ai * ai, br * br + bi * bi)
    if decimated:
        nblk = (ns - LAG) // stride
        planes = [v[:nblk * stride].view(nblk, stride, b).sum(1) for v in planes]
        p_re, p_im, e1, e2 = (_window_sums(v, WIN // stride) for v in planes)
    else:
        p_re, p_im, e1, e2 = (_window_sums(v, WIN) for v in planes)
    m = (p_re * p_re + p_im * p_im) / torch.clamp(e1 * e2, min=1e-30)   # (nm, B)
    nm = m.shape[0]
    above = m > threshold
    det = above.any(0)
    cross = torch.where(det, above.to(torch.int8).argmax(0), nm)
    if decimated:
        coarse = torch.clamp(cross * stride - stride, min=0)
        search_fine = search + stride
    else:
        coarse, search_fine = cross, search

    # -- matched filter, then 5-sums and the pair sum --
    mf = mf_plain(xr, xi, lts_ref).to(f64)                             # (NS−64, B)
    mf2 = mf[:-1] + mf[1:]
    mf5 = (mf2[:-2] + mf2[2:])[:-1] + mf[4:]
    pair = mf5[:-LAG] + mf5[LAG:]                                       # (NS−132, B)
    idx = torch.arange(pair.shape[0], device=dev)[:, None]
    mask = (idx >= coarse) & (idx < coarse + 2 * search_fine)
    rep1 = torch.where(mask, pair, 0.0).argmax(0) + 2
    start = rep1 - 32 - advance

    # -- peak metric: the detected window, or [0, 2·search) --
    idx_m = torch.arange(nm, device=dev)[:, None] * stride
    lo_m = torch.where(det, coarse, 0)
    hi_m = lo_m + torch.where(det, 2 * search_fine, 2 * search)
    peak = torch.where((idx_m >= lo_m) & (idx_m < hi_m), m, 0.0).amax(0)
    neg = torch.full_like(coarse, -1)
    return Detection(det, torch.where(det, coarse, neg).to(torch.int32),
                     torch.where(det, start, neg).to(torch.int32), peak.to(torch.float32))


def extract_lane_major(x: Cplx, start: torch.Tensor) -> tuple[Cplx, Cplx]:
    """(preamble (160, B), packet (1200, B)) cut from (NS, B) streams at each
    stream's ``start``, clipped to [0, NS − 1360]; storage dtype kept."""
    ns = x.re.shape[0]
    s = torch.clamp(start.to(torch.int64), 0, ns - FRAME)
    rows = s[None, :] + torch.arange(FRAME, device=s.device)[:, None]
    fr, fi = torch.gather(x.re, 0, rows), torch.gather(x.im, 0, rows)
    n = C.PREAMBLE_SAMPLES
    return Cplx(fr[:n], fi[:n]), Cplx(fr[n:], fi[n:])


def place_plain(sig: Cplx, noise: Cplx, offs: torch.Tensor) -> Cplx:
    """x[r, l] = sig[(r − offs[l]) mod NS, l] + noise[r, l], added in
    float32 and rounded to sig's dtype."""
    _check_place(sig, noise, offs)
    ns = sig.re.shape[0]
    rows = (torch.arange(ns, device=offs.device)[:, None] - offs.to(torch.int64)[None, :]) % ns
    return Cplx(*((torch.gather(s, 0, rows).to(torch.float32) + n.to(torch.float32)).to(s.dtype)
                  for s, n in zip(sig, noise)))


def _check_place(sig: Cplx, noise: Cplx, offs: torch.Tensor) -> None:
    _check_pair("sig", sig, PLACE_STORAGE)
    _check_pair("noise", noise, PLACE_STORAGE, sig.re)
    ns, b = sig.re.shape
    if tuple(offs.shape) != (b,) or offs.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"offs: want ({b},) int32, got {tuple(offs.shape)} {offs.dtype}")
    if offs.device != sig.re.device:
        raise ValueError(f"offs lies on {offs.device}, sig on {sig.re.device}")
    inside = ((offs >= 0) & (offs < ns)).all()
    if offs.device.type == "cpu":
        if not bool(inside):
            raise ValueError(f"offs must lie in [0, {ns})")
    else:
        # no host read on the card (it would stall every stream step): the
        # check runs on the device, and a failure surfaces at the next sync
        torch._assert_async(inside)


# -- the kernels --------------------------------------------------------------------


def place_attributes(sig_dtype: torch.dtype, noise_dtype: torch.dtype, ns: int,
                     batch: int) -> dict:
    """`_ffi.attributes` of the placement kernel that ``place_streams``
    launches for these types and shapes, and streams per ``strip`` (0: too
    long a stream to stage, sig read in place)."""
    return _ffi.attributes(LIB.place_attributes, STORAGE[sig_dtype], STORAGE[noise_dtype], ns,
                           batch, names=(*_ffi.ATTRIBUTES, "strip"))


def detect_attributes(dtype: torch.dtype = torch.bfloat16, search: int = 192,
                      decimate=16, lib=None) -> dict:
    """`_ffi.attributes` of the detection kernel for streams of ``dtype``,
    with or without alignment (32 streams a block).  ``lib``: a card probe's
    build (`Library.at`)."""
    stride, decimated = stride_of(decimate)
    return _ffi.attributes((lib or LIB).detect_attributes, STORAGE[dtype], search, stride,
                           decimated)


def detection_rows(b: int, device: torch.device) -> list:
    """The kernels' (B,) detection outputs: det, coarse, start (int32),
    metric (float32)."""
    return [torch.empty(b, dtype=torch.int32, device=device) for _ in range(3)] + [
        torch.empty(b, dtype=torch.float32, device=device)]


def _launch_detect(x: Cplx, lts_ref: Cplx, threshold, search, advance, decimate,
                   align: bool, lib=None):
    """One launch; ``lib``: a card probe's build of the source (`Library.at`)."""
    check_streams(x, lts_ref, search)
    stride, decimated = stride_of(decimate)
    ns, b = x.re.shape
    dev = x.re.device
    rows = detection_rows(b, dev)
    planes = [None] * 4
    if align:
        planes = [torch.empty((n, b), dtype=x.re.dtype, device=dev)
                  for n in (C.PREAMBLE_SAMPLES,) * 2 + (C.PACKET_SAMPLES,) * 2]
    _ffi.launch((lib or LIB).detect_launch, [*x, *lts_ref, *rows, *planes], STORAGE[x.re.dtype],
                b, ns, float(threshold), int(search), int(advance), stride, decimated,
                counter=_count_detect)
    det, coarse, start, metric = rows
    _ffi.count_torch()   # det != 0: one elementwise kernel
    res = Detection(det != 0, coarse, start, metric)
    if not align:
        return res
    return res, Cplx(planes[0], planes[1]), Cplx(planes[2], planes[3])


def detect_streams(x: Cplx, lts_ref: Cplx, threshold: float = DEFAULT_THRESHOLD,
                   search: int = 192, advance: int = 4, decimate=False) -> dict:
    """Detection of lane-major (NS, B) streams against the (64,) float32 LTS
    ``lts_ref``: a dict of (B,) tensors ``detected`` (bool), ``coarse`` and
    ``start`` (int32, −1 where undetected) and ``metric`` (float32).  The
    CUDA kernel for CUDA tensors, ``detect_plain`` for CPU tensors.

    ``decimate`` evaluates the Schmidl & Cox metric every 16 (True), 32 or
    64 samples only, exactly on that grid: ``coarse`` becomes
    stride-granular, and the fine window, anchored one stride early,
    widens by one stride."""
    if x.re.device.type == "cpu":
        return detect_plain(x, lts_ref, threshold, search, advance, decimate)._asdict()
    return _launch_detect(x, lts_ref, threshold, search, advance, decimate, False)._asdict()


def detect_and_align(x: Cplx, lts_ref: Cplx, threshold: float = DEFAULT_THRESHOLD,
                     search: int = 192, advance: int = 4) -> tuple[dict, Cplx, Cplx]:
    """Detection and alignment in one pass: (detection dict, preamble Cplx
    (160, B), packet Cplx (1200, B)), the planes in the storage dtype, bit
    for bit the stream's rows from ``start`` on (clipped to
    [0, NS − 1360]; undetected streams are cut at row 0: gate on
    ``detected``)."""
    if x.re.device.type == "cpu":
        det = detect_plain(x, lts_ref, threshold, search, advance)
        lp, pkt = extract_lane_major(x, torch.where(det.detected, det.start, 0))
        return det._asdict(), lp, pkt
    det, lp, pkt = _launch_detect(x, lts_ref, threshold, search, advance, False, True)
    return det._asdict(), lp, pkt


def place_streams(sig: Cplx, noise: Cplx, offs: torch.Tensor) -> Cplx:
    """x[r, l] = sig[(r − offs[l]) mod NS, l] + noise[r, l] for lane-major
    (NS, B) planes: each stream's frame placed at its offset in a noise
    field.  ``offs`` (B,) lies in [0, NS).  The output has sig's dtype; the
    sum is taken in float32.  The CUDA kernel for CUDA tensors,
    ``place_plain`` for CPU tensors."""
    if sig.re.device.type == "cpu":
        return place_plain(sig, noise, offs)
    return _launch_place(sig, noise, offs)


def _launch_place(sig: Cplx, noise: Cplx, offs: torch.Tensor, lib=None) -> Cplx:
    """One launch; ``lib``: a card probe's build of the source (`Library.at`)."""
    _check_place(sig, noise, offs)
    ns, b = sig.re.shape
    out = Cplx(torch.empty_like(sig.re), torch.empty_like(sig.im))
    offs = offs.to(torch.int32).contiguous()
    _ffi.launch((lib or LIB).place_launch, [*sig, *noise, offs, *out], STORAGE[sig.re.dtype],
                STORAGE[noise.re.dtype], ns, b, counter=_count_place)
    return out
