"""Packet detection and timing from a raw sample stream, batch-major.

The counterpart of ``tpu80211/ops/detect.py``, on complex tensors (…, N):

* **coarse detection**: the Schmidl & Cox lag-64 metric
  M(d) = |Σ_{k<64} x[d+k]·conj(x[d+64+k])|² / (Σ|x[d+k]|² · Σ|x[d+64+k]|²),
  ≈ 1 over the LTS plateau and ≈ 0 in noise; a packet is declared where
  M first exceeds ``threshold``;
* **fine timing**: the magnitude of the matched filter against the known
  64-sample LTS, 5-sample smoothing, and the sum of the two repeat peaks
  64 apart, searched in a window after the coarse hit.

This is the plain reference of the semantics; the lane-major kernels and
their plain twins are in ``kernels/detect_kernel.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu80211_torch import constants as C

LAG = C.N_FFT            # 64: the LTS repeat period
WIN = C.N_FFT            # the correlation window
DEFAULT_THRESHOLD = 0.5  # on the normalized metric M ∈ [0, 1]


def _window_sums(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding sums of length ``w`` along the last axis by a cumulative
    sum: out[d] = Σ_{k<w} x[d+k], shape (…, N−w+1)."""
    c = torch.cumsum(x, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return c[..., w:] - c[..., :-w]


def autocorr_metric(x: torch.Tensor) -> torch.Tensor:
    """The normalized lag-64 metric M(d), (…, N−127), real.  Both window
    energies normalize it, so M ≤ 1; an all-zero window gives 0."""
    a, b = x[..., :-LAG], x[..., LAG:]
    prod = a * b.conj()
    p = _window_sums(prod, WIN)
    e1 = _window_sums(a.abs().square(), WIN)
    e2 = _window_sums(b.abs().square(), WIN)
    return p.abs().square() / torch.clamp(e1 * e2, min=1e-30)


def matched_filter(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|Σ_k x[d+k]·conj(ref[k])|, (…, N−len(ref)+1): a cross-correlation,
    as ``conv1d`` computes it (no kernel flip)."""
    *lead, n = x.shape
    ref = ref.to(x.dtype)
    corr = F.conv1d(x.reshape(-1, 1, n), ref.conj().reshape(1, 1, -1))
    return corr.reshape(*lead, -1).abs()


def detect_packet(x: torch.Tensor, lts_ref: torch.Tensor,
                  threshold: float = DEFAULT_THRESHOLD, search: int = 192,
                  advance: int = 4) -> dict:
    """Detect the packet in each (…, N) stream.  Returns (…,) tensors:
    ``detected`` (bool, M crossed ``threshold``), ``coarse`` (first
    crossing), ``start`` (the long preamble's start: the rep-1 matched-filter
    peak − 32 − ``advance``) and ``metric`` (the peak M in the search
    window).  ``coarse`` and ``start`` are −1 where nothing was detected.

    ``search``: half-width of the fine window after the coarse hit.
    ``advance``: samples of timing advance (early extraction inside the
    cyclic prefix is a phase ramp the estimators absorb; late costs ISI)."""
    m = autocorr_metric(x)
    above = m > threshold
    detected = above.any(-1)
    coarse = above.to(torch.int8).argmax(-1)          # first crossing

    mf = matched_filter(x, lts_ref)
    mf_s = _window_sums(mf, 5)                        # centred at d+2
    pair = mf_s[..., :-LAG] + mf_s[..., LAG:]         # both repeat peaks
    idx = torch.arange(pair.shape[-1], device=x.device)
    lo = coarse[..., None]
    mask = (idx >= lo) & (idx < lo + 2 * search)
    rep1 = torch.where(mask, pair, torch.zeros_like(pair)).argmax(-1) + 2
    start = rep1 - 32 - advance                       # lptot = [32 CP | rep | rep]

    idx_m = torch.arange(m.shape[-1], device=x.device)
    mask_m = (idx_m >= lo) & (idx_m < lo + 2 * search)
    peak = torch.where(mask_m, m, torch.zeros_like(m)).amax(-1)
    neg = torch.full_like(coarse, -1)
    return {"detected": detected,
            "coarse": torch.where(detected, coarse, neg),
            "start": torch.where(detected, start, neg),
            "metric": peak}


def extract_packet(x: torch.Tensor, start: torch.Tensor):
    """(lptot (…, 160), packet (…, 1200)) cut from (…, N) streams at each
    row's ``start``, clipped to [0, N − 1360]."""
    total = C.PREAMBLE_SAMPLES + C.PACKET_SAMPLES
    s = torch.clamp(start, 0, x.shape[-1] - total)
    rows = s[..., None] + torch.arange(total, device=x.device)
    frame = torch.gather(x, -1, rows)
    return frame[..., :C.PREAMBLE_SAMPLES], frame[..., C.PREAMBLE_SAMPLES:]


def lts_time_symbol(tx_lptot) -> torch.Tensor:
    """The known 64-sample LTS (the matched-filter reference): the last
    repeat of a (…, 160) transmit preamble, as a complex tensor."""
    return torch.as_tensor(tx_lptot)[..., -C.N_FFT:]
