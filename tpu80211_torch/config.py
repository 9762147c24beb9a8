"""Estimator semantics selector (the counterpart of ``tpu80211/config.py``)."""

from __future__ import annotations

import enum


class EstimatorMode(enum.Enum):
    """Which semantics an estimator implements.

    MATH     — textbook-correct estimators; the primary API.  Identical to
               MATLAB for every estimator except PS-MMSE, where the MATLAB
               code builds Rhy = Rhh·F'·X4
               (WiFi_channel_estimation_PS_MMSE.m:30) although the true
               cross-covariance E[h·yᴴ] = Rhh·Fᴴ·X4ᴴ needs the *adjoint*
               of X4.
    MATLAB   — the golden-model semantics (WiFi_channel_estimation_*.m),
               including the X4-conjugation slip above.
    C_PARITY — reproduces the C sequential implementation's quirks
               (uniform divided-difference deltas main.c:108-118, one
               averaged block, ...).
    """

    MATH = "math"
    MATLAB = "matlab"
    C_PARITY = "c_parity"
