"""LT-LS: least-squares channel estimate from the long-training preamble
(the counterpart of ``tpu80211/models/lt_ls.py``).

MATLAB golden model: H = conj(X)·Y ./ (conj(X)·X) on every bin but DC,
which is forced to 0 (WiFi_channel_estimation_LT_LS.m:1-5).  C-parity mode
reproduces main.c:66-75, whose "conjugate" is the real scalar Re(tx) −
Im(tx) (SURVEY.md §2.5.3), with the C code's order of operations.
"""

from __future__ import annotations

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode


def lt_ls(
    tx_pre: torch.Tensor,  # (…, 53) transmitted LTS spectrum
    rx_pre: torch.Tensor,  # (…, 53) received LTS spectrum
    mode: EstimatorMode = EstimatorMode.MATH,
) -> torch.Tensor:
    """(…, 53) channel frequency response; the DC bin is exactly zero."""
    if mode == EstimatorMode.C_PARITY:
        conj = (tx_pre.real - tx_pre.imag).to(tx_pre.dtype)  # main.c:69-70
        denom = conj * tx_pre
    else:
        conj = tx_pre.conj()
        denom = tx_pre.abs().square()  # conj(X)·X is real
    dc = torch.zeros(C.N_SC, dtype=torch.bool, device=tx_pre.device)
    dc[C.DC_IDX] = True
    # guard the DC division, then force DC to 0
    denom = torch.where(dc, torch.ones_like(denom), denom)
    h = conj * rx_pre / denom
    return torch.where(dc, torch.zeros_like(h), h)
