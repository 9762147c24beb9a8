"""Pilot-subcarrier LS estimators with linear, cubic, sinc, spline and
Wiener interpolation (the counterpart of ``tpu80211/models/ps_interp.py``).

Each interpolator is a static (4, 53) matrix (``ops/interp.py``), so a
block's estimate is ``(rx[pilots] / tx[pilots]) @ W``.  The frame-level
estimate is the average over the first ``avg_blocks`` blocks
(..._PS_Linear.m:23); C-parity mode takes block 0 only (main.c:16,29-33).
"""

from __future__ import annotations

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.ops.interp import interp_matrix

_PILOTS = list(C.PILOT_IDX)


def pilot_ratios(tx: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """(…, 53) → (…, 4) pilot ratios rx[p]/tx[p]."""
    return rx[..., _PILOTS] / tx[..., _PILOTS]


def _apply(hp: torch.Tensor, kind: str, mode: EstimatorMode, channel_model: str | None,
           snr_db: float | None) -> torch.Tensor:
    w = interp_matrix(kind, mode, channel_model=channel_model, snr_db=snr_db)
    return hp @ torch.as_tensor(w).to(device=hp.device, dtype=hp.dtype)


def ps_interp_per_block(
    tx: torch.Tensor,  # (…, 53)
    rx: torch.Tensor,  # (…, 53)
    kind: str,
    mode: EstimatorMode = EstimatorMode.MATH,
    channel_model: str | None = None,
    snr_db: float | None = None,
) -> torch.Tensor:
    """Single-block estimate, (…, 53)."""
    return _apply(pilot_ratios(tx, rx), kind, mode, channel_model, snr_db)


def ps_interp(
    tx_blocks: torch.Tensor,  # (…, n_blocks, 53)
    rx_blocks: torch.Tensor,  # (…, n_blocks, 53)
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
    # interpolation is linear: interpolating the block mean equals the
    # mean of the interpolated blocks (..._PS_Linear.m:23)
    return _apply(hp.mean(dim=-2), kind, mode, channel_model, snr_db)
