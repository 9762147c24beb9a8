"""The full RX chain in plain PyTorch, on complex tensors.

The counterpart of ``tpu80211/pipeline/sc.py`` (MATH mode, plus MATLAB
mode for the MMSE): time-domain samples → 53-bin block spectra → seven
channel estimates → blended equalization.  It computes in the dtype of
its inputs, ``torch.complex64`` or ``torch.complex128``.  The stages are
those of ``ops/`` and ``models/``, under the JAX module's names; this
module composes them, and adds ``ps_mmse_dense`` (the fused solve).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.kernels.mmse_solve import fused_rank1_solve
from tpu80211_torch.models.lt_ls import lt_ls
from tpu80211_torch.models.ps_interp import pilot_ratios, ps_interp
from tpu80211_torch.models.ps_mmse import ps_mmse_sm, vdot
from tpu80211_torch.ops import cfo
from tpu80211_torch.ops.blocks import extract_blocks, preamble_fft
from tpu80211_torch.ops.blocks import noise_power_estimate as noise_power
from tpu80211_torch.ops.equalize import equalize

__all__ = [
    "extract_blocks", "preamble_fft", "noise_power", "lt_ls", "pilot_ratios", "ps_interp",
    "ps_mmse_sm", "ps_mmse_dense", "equalize", "RxOutputs", "rx_chain", "rx_chain_freq",
]


def ps_mmse_dense(
    tx_blocks: torch.Tensor,
    rx_blocks: torch.Tensor,
    ow2: torch.Tensor,     # (…,) real noise power
    h_lt: torch.Tensor,    # (…, 53)
    avg_blocks: int = C.N_AVG_BLOCKS,
) -> torch.Tensor:
    """MMSE through the fused build-and-solve kernel: the reference's
    computational shape (an explicit regularized 53×53 Hermitian solve per
    block, main.c:201), kept as a path to measure.  Equal to `ps_mmse_sm`
    in MATH mode (s = uᴴ·Ryy⁻¹·rx with Ryy = σ²I + u·uᴴ); the solve runs in
    complex64 whatever the input dtype."""
    tx = tx_blocks[..., :avg_blocks, :]
    rx = rx_blocks[..., :avg_blocks, :]
    vb = h_lt[..., None, :]
    u = tx * vb
    z = fused_rank1_solve(u, rx, torch.broadcast_to(ow2[..., None], u.shape[:-1]))
    return (vb * vdot(u, z)[..., None]).mean(dim=-2)


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
    (WiFi_RX.m:60).

    ``sync=True`` adds the synchronization stages of ``ops/cfo.py``: the
    Moose CFO is removed from both rx streams before the front end (so σ²
    and the LTS average come from the corrected preamble), and each
    equalized block's pilot CPE is removed after equalization."""
    if sync:
        rx_packet, rx_lptot, _ = cfo.correct_cfo(rx_packet, rx_lptot)
    tx_blocks = extract_blocks(tx_packet)
    out = rx_chain_freq(
        preamble_fft(tx_lptot), preamble_fft(rx_lptot),
        tx_blocks, extract_blocks(rx_packet),
        noise_power(rx_lptot),
        avg_blocks=avg_blocks, equalize_with=equalize_with,
    )
    if sync:
        out = out._replace(eq=cfo.cpe_correct(out.eq, tx_blocks))
    return out


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
