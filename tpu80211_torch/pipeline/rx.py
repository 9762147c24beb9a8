"""The complex-dtype RX chain with every estimator mode and MMSE solver
(the counterpart of ``tpu80211/pipeline/rx.py``).

Composes the ops and the estimators of ``models/`` into the WiFi_RX.m
pipeline (WiFi_RX.m:17-60), at complex64 or complex128.  Unlike
``pipeline/sc.py`` (MATH mode, rank-1 MMSE, the kernels' plain twin), it
takes ``mode`` (MATH, MATLAB, C_PARITY) and ``mmse_solver`` ("sm",
"dense", "dense_pallas": the last one runs the hand-written solve kernel
on CUDA tensors).
"""

from __future__ import annotations

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.config import EstimatorMode
from tpu80211_torch.models import lt_ls, ps_interp, ps_mmse
from tpu80211_torch.ops.blocks import extract_blocks, noise_power_estimate, preamble_fft
from tpu80211_torch.ops.equalize import equalize
from tpu80211_torch.pipeline.sc import RxOutputs

__all__ = ["RxOutputs", "rx_chain", "rx_chain_freq"]


def rx_chain(
    tx_packet: torch.Tensor,  # (…, 1200)
    rx_packet: torch.Tensor,  # (…, 1200)
    tx_lptot: torch.Tensor,   # (…, 160)
    rx_lptot: torch.Tensor,   # (…, 160)
    mode: EstimatorMode = EstimatorMode.MATH,
    mmse_solver: str = "sm",
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
) -> RxOutputs:
    """WiFi_RX.m:17-60, batched over leading dims.  ``equalize_with`` names
    the PS estimate blended into the equalizer CFR; the golden model fixes
    PS-Linear (WiFi_RX.m:60)."""
    return rx_chain_freq(
        preamble_fft(tx_lptot), preamble_fft(rx_lptot),
        extract_blocks(tx_packet), extract_blocks(rx_packet),
        noise_power_estimate(rx_lptot),
        mode=mode, mmse_solver=mmse_solver, avg_blocks=avg_blocks,
        equalize_with=equalize_with,
    )


def rx_chain_freq(
    tx_pre: torch.Tensor,     # (…, 53)
    rx_pre: torch.Tensor,     # (…, 53)
    tx_blocks: torch.Tensor,  # (…, 15, 53)
    rx_blocks: torch.Tensor,  # (…, 15, 53)
    ow2,                      # (…,) or a scalar
    mode: EstimatorMode = EstimatorMode.MATH,
    mmse_solver: str = "sm",
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
) -> RxOutputs:
    """Frequency-domain entry (the C drivers' view, inputs.h)."""
    h_lt = lt_ls(tx_pre, rx_pre, mode=mode)
    kw = dict(mode=mode, avg_blocks=avg_blocks)
    est = {f"h_{kind}": ps_interp(tx_blocks, rx_blocks, kind, **kw)
           for kind in ("linear", "cubic", "sinc", "spline", "wiener")}
    est["h_mmse"] = ps_mmse(tx_blocks, rx_blocks, ow2, h_lt, mode=mode, solver=mmse_solver,
                            avg_blocks=avg_blocks)
    eq = equalize(rx_blocks, h_lt, est[equalize_with])
    ow2 = torch.as_tensor(ow2, dtype=h_lt.real.dtype, device=h_lt.device)
    return RxOutputs(h_lt=h_lt, **est, eq=eq, ow2=ow2)
