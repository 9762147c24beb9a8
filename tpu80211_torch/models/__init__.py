"""Estimator registry (the counterpart of ``tpu80211/models``).

Five estimator families, mirroring the reference inventory (SURVEY.md §2):
LT-LS (main.c:66, WiFi_channel_estimation_LT_LS.m), PS linear/cubic/sinc
(main.c:77/103/124, WiFi_channel_estimation_PS_{Linear,Cubic,Sinc}.m), the
csapi spline (WiFi_channel_estimation_PS_Third.m) and PS-MMSE (main.c:148,
WiFi_channel_estimation_PS_MMSE.m), plus the Wiener interpolator.
"""

from __future__ import annotations

import functools

from tpu80211_torch.models.lt_ls import lt_ls
from tpu80211_torch.models.ps_interp import pilot_ratios, ps_interp, ps_interp_per_block
from tpu80211_torch.models.ps_mmse import ps_mmse

ps_linear = functools.partial(ps_interp, kind="linear")
ps_cubic = functools.partial(ps_interp, kind="cubic")
ps_sinc = functools.partial(ps_interp, kind="sinc")
ps_spline = functools.partial(ps_interp, kind="spline")
# MMSE-optimal pilot interpolation (ops/interp.py), beyond the reference's
# estimator set, with the same (tx_blocks, rx_blocks) API
ps_wiener = functools.partial(ps_interp, kind="wiener")

# pilot-based estimators share the signature (tx_blocks, rx_blocks, **kw)
PS_ESTIMATORS = {
    "ps_linear": ps_linear,
    "ps_cubic": ps_cubic,
    "ps_sinc": ps_sinc,
    "ps_spline": ps_spline,
    "ps_wiener": ps_wiener,
}

__all__ = [
    "lt_ls",
    "ps_interp",
    "ps_interp_per_block",
    "pilot_ratios",
    "ps_mmse",
    "ps_linear",
    "ps_cubic",
    "ps_sinc",
    "ps_spline",
    "ps_wiener",
    "PS_ESTIMATORS",
]
