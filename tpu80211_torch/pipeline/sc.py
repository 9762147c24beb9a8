"""The full RX chain in plain PyTorch, on complex tensors.

The counterpart of ``tpu80211/pipeline/sc.py`` (MATH mode, plus MATLAB
mode for the MMSE): time-domain samples → 53-bin block spectra → seven
channel estimates → blended equalization.  It computes in the dtype of
its inputs, ``torch.complex64`` or ``torch.complex128``; the block DFT is
one product against the (64, 53) matrix of ``ops/specmats.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.ops import specmats
from tpu80211_torch.ops.interp import interp_matrix

_PILOTS = list(C.PILOT_IDX)


def _dc_mask(device: torch.device) -> torch.Tensor:
    mask = torch.zeros(C.N_SC, dtype=torch.bool, device=device)
    mask[C.DC_IDX] = True
    return mask


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.complex128 else torch.float32


def _const(w, like: torch.Tensor) -> torch.Tensor:
    """A numpy constant as a tensor of ``like``'s complex dtype and device."""
    return torch.as_tensor(w).to(device=like.device, dtype=like.dtype)


def _block_dft(like: torch.Tensor) -> torch.Tensor:
    w_re, w_im = specmats.block_dft()
    return _const(w_re + 1j * w_im, like)


# -- front end -----------------------------------------------------------------


def extract_blocks(packet: torch.Tensor) -> torch.Tensor:
    """(…, 1200) time-domain packet → (…, 15, 53) frequency-domain blocks."""
    *lead, n = packet.shape
    assert n == C.PACKET_SAMPLES, packet.shape
    blocks = packet.reshape(*lead, C.N_BLOCKS, C.SAMP_PER_BLOCK)[..., C.N_CP:]
    return blocks @ _block_dft(packet)


def preamble_fft(lptot: torch.Tensor) -> torch.Tensor:
    """(…, 160) long preamble → (…, 53) averaged LTS spectrum (WiFi_RX.m:19-29)."""
    assert lptot.shape[-1] == C.PREAMBLE_SAMPLES, lptot.shape
    rep1 = lptot[..., -C.N_FFT:]
    rep2 = lptot[..., -2 * C.N_FFT:-C.N_FFT]
    return ((rep1 + rep2) * 0.5) @ _block_dft(lptot)


def noise_power(rx_lptot: torch.Tensor) -> torch.Tensor:
    """σ² from the LTS repeat difference (WiFi_RX.m:31); real (…,) tensor."""
    rep1 = rx_lptot[..., -C.N_FFT:]
    rep2 = rx_lptot[..., -2 * C.N_FFT:-C.N_FFT]
    return (rep2 - rep1).abs().square().sum(-1) / (2 * C.N_FFT)


# -- estimators ----------------------------------------------------------------


def lt_ls(tx_pre: torch.Tensor, rx_pre: torch.Tensor) -> torch.Tensor:
    """LT-LS estimate (…, 53); DC forced to 0 (WiFi_channel_estimation_LT_LS.m)."""
    dc = _dc_mask(tx_pre.device)
    denom = tx_pre.abs().square()
    denom = torch.where(dc, torch.ones_like(denom), denom)
    h = tx_pre.conj() * rx_pre / denom
    return torch.where(dc, torch.zeros_like(h), h)


def pilot_ratios(tx: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """(…, 53) → (…, 4) pilot ratios rx[p]/tx[p]."""
    return rx[..., _PILOTS] / tx[..., _PILOTS]


def ps_interp(
    tx_blocks: torch.Tensor,
    rx_blocks: torch.Tensor,
    kind: str,
    mode: EstimatorMode = EstimatorMode.MATH,
    avg_blocks: int = C.N_AVG_BLOCKS,
    channel_model: str | None = None,
    snr_db: float | None = None,
) -> torch.Tensor:
    """Pilot-LS + static-matrix interpolation, averaged over the first
    ``avg_blocks`` blocks (…, 53).  ``channel_model``/``snr_db`` set the
    prior of kind="wiener" (ops/interp.py)."""
    if mode == EstimatorMode.C_PARITY:
        avg_blocks = 1
    hp = pilot_ratios(tx_blocks[..., :avg_blocks, :], rx_blocks[..., :avg_blocks, :])
    w = interp_matrix(kind, mode, channel_model=channel_model, snr_db=snr_db)
    # interpolation is linear: interpolating the block mean equals the
    # mean of the interpolated blocks (..._PS_Linear.m:23)
    return hp.mean(dim=-2) @ _const(w, hp)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᴴ·b along the last axis."""
    return (a.conj() * b).sum(-1)


def ps_mmse_sm(
    tx_blocks: torch.Tensor,
    rx_blocks: torch.Tensor,
    ow2: torch.Tensor,     # (…,) real noise power
    h_lt: torch.Tensor,    # (…, 53)
    avg_blocks: int = C.N_AVG_BLOCKS,
    mode: EstimatorMode = EstimatorMode.MATH,
) -> torch.Tensor:
    """Rank-1 (Sherman-Morrison) MMSE.

    Rhh = ifft(H_LT)·ifft(H_LT)ᴴ is rank one, so Ryy = σ²I + u·uᴴ and the
    53×53 inverse reduces to dots; v = F·ifft(H_LT) is exactly H_LT.  MATH
    mode uses the correct X4ᴴ in Rhy; MATLAB mode reproduces the X4 slip
    of ..._PS_MMSE.m:30."""
    tx = tx_blocks[..., :avg_blocks, :]
    rx = rx_blocks[..., :avg_blocks, :]
    vb = h_lt[..., None, :]
    u = tx * vb
    denom = ow2[..., None] + u.abs().square().sum(-1)  # (…, avg) real
    urx = _vdot(u, rx)
    if mode == EstimatorMode.MATLAB:
        upp = tx.conj() * vb
        s = (_vdot(upp, rx) - _vdot(upp, u) * (urx / denom)) / ow2[..., None]
    else:
        s = urx / denom
    return (vb * s[..., None]).mean(dim=-2)


def equalize(
    rx_blocks: torch.Tensor, h_lt: torch.Tensor, h_ps: torch.Tensor,
    block_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blended-CFR equalization (WiFi_Equalization.m:3-8); DC column zero.

    ``block_ids`` (0-based global block indices, one per local block) is
    for callers holding a subset of the frame's blocks: the blend weight
    uses the global 1-based index over the 15-block frame, and ids past
    the end clamp to the final all-PS blend."""
    real = _real_dtype(rx_blocks)
    if block_ids is None:
        n = rx_blocks.shape[-2]
        i = torch.arange(1, n + 1, dtype=real, device=rx_blocks.device)
    else:
        n = C.N_BLOCKS
        i = torch.clamp(block_ids + 1, max=n).to(real)
    i = i[:, None]
    h_util = (n - i) / n * h_lt[..., None, :] + i / n * h_ps[..., None, :]
    dc = _dc_mask(rx_blocks.device)
    safe = torch.where(dc, torch.ones_like(h_util), h_util)
    eq = rx_blocks / safe
    return torch.where(dc, torch.zeros_like(eq), eq)


# -- full chain ----------------------------------------------------------------


class RxOutputs(NamedTuple):
    """Per-frame outputs of the full RX chain (complex except ow2)."""

    h_lt: torch.Tensor       # (…, 53) LT-LS estimate
    h_linear: torch.Tensor   # (…, 53)
    h_cubic: torch.Tensor    # (…, 53)
    h_sinc: torch.Tensor     # (…, 53)
    h_spline: torch.Tensor   # (…, 53)
    h_wiener: torch.Tensor   # (…, 53) MMSE-optimal pilot interpolation
    h_mmse: torch.Tensor     # (…, 53)
    eq: torch.Tensor         # (…, 15, 53) equalized symbols
    ow2: torch.Tensor        # (…,) estimated noise power


def rx_chain(
    tx_packet: torch.Tensor,   # (…, 1200)
    rx_packet: torch.Tensor,   # (…, 1200)
    tx_lptot: torch.Tensor,    # (…, 160)
    rx_lptot: torch.Tensor,    # (…, 160)
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
    sync: bool = False,
) -> RxOutputs:
    """The full WiFi_RX.m chain, batched: time-domain samples → estimates →
    equalized symbols.  ``equalize_with`` names the PS estimate blended
    into the equalizer CFR; the golden model fixes PS-Linear
    (WiFi_RX.m:60)."""
    if sync:
        raise NotImplementedError(
            "rx_chain(sync=True) needs the CFO/CPE stages of ops/cfo.py, "
            "which are not ported yet (ROADMAP A4)")
    return rx_chain_freq(
        preamble_fft(tx_lptot), preamble_fft(rx_lptot),
        extract_blocks(tx_packet), extract_blocks(rx_packet),
        noise_power(rx_lptot),
        avg_blocks=avg_blocks, equalize_with=equalize_with,
    )


def rx_chain_freq(
    tx_pre: torch.Tensor,      # (…, 53)
    rx_pre: torch.Tensor,      # (…, 53)
    tx_blocks: torch.Tensor,   # (…, 15, 53)
    rx_blocks: torch.Tensor,   # (…, 15, 53)
    ow2: torch.Tensor,         # (…,)
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
    wiener_model: str | None = None,
    wiener_snr_db: float | None = None,
) -> RxOutputs:
    """Frequency-domain entry (the C drivers' view, inputs.h:20-928):
    estimators + equalization, MATH mode.  ``wiener_model``/``wiener_snr_db``
    set the Wiener estimator's channel prior (ops/interp.py)."""
    h_lt = lt_ls(tx_pre, rx_pre)
    est = {
        f"h_{kind}": ps_interp(tx_blocks, rx_blocks, kind, avg_blocks=avg_blocks)
        for kind in ("linear", "cubic", "sinc", "spline")
    }
    est["h_wiener"] = ps_interp(tx_blocks, rx_blocks, "wiener", avg_blocks=avg_blocks,
                                channel_model=wiener_model, snr_db=wiener_snr_db)
    est["h_mmse"] = ps_mmse_sm(tx_blocks, rx_blocks, ow2, h_lt, avg_blocks=avg_blocks)
    eq = equalize(rx_blocks, h_lt, est[equalize_with])
    return RxOutputs(h_lt=h_lt, **est, eq=eq, ow2=ow2)
