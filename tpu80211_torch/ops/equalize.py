"""Blended-CFR equalization (the counterpart of ``tpu80211/ops/equalize.py``)."""

from __future__ import annotations

import torch

from tpu80211_torch import constants as C


def equalize(
    rx_blocks: torch.Tensor, h_lt: torch.Tensor, h_ps: torch.Tensor,
    block_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blended-CFR equalization (WiFi_Equalization.m:3-8); DC column zero.

    ``block_ids`` (0-based global block indices, one per local block) is
    for callers holding a subset of the frame's blocks: the blend weight
    uses the global 1-based index over the 15-block frame, and ids past
    the end clamp to the final all-PS blend."""
    real = rx_blocks.real.dtype
    if block_ids is None:
        n = rx_blocks.shape[-2]
        i = torch.arange(1, n + 1, dtype=real, device=rx_blocks.device)
    else:
        n = C.N_BLOCKS
        i = torch.clamp(block_ids + 1, max=n).to(real)
    i = i[:, None]
    h_util = (n - i) / n * h_lt[..., None, :] + i / n * h_ps[..., None, :]
    dc = torch.zeros(C.N_SC, dtype=torch.bool, device=rx_blocks.device)
    dc[C.DC_IDX] = True
    safe = torch.where(dc, torch.ones_like(h_util), h_util)
    eq = rx_blocks / safe
    return torch.where(dc, torch.zeros_like(eq), eq)
