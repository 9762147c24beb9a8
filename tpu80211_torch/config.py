"""Run configuration and the estimator semantics selector (the counterpart
of ``tpu80211/config.py``: the same fields, defaults and strings, so one
configuration means the same thing in both packages)."""

from __future__ import annotations

import dataclasses
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


ESTIMATOR_NAMES = (
    "lt_ls", "ps_linear", "ps_cubic", "ps_sinc", "ps_spline", "ps_wiener",
    "ps_mmse",
)


@dataclasses.dataclass(frozen=True)
class Config:
    """One run's settings, field for field those of ``tpu80211.config.Config``.
    The mesh shape (``dp`` frame shards, ``blk`` block shards) is that of
    ``parallel.make_mesh``: there, one process per device.

    ``mmse_solver="dense_pallas"`` names the solver backed by the
    hand-written solve kernel (``kernels/mmse_solve.py``); the name is the
    JAX package's, kept so that one configuration selects the same solver
    in both packages."""

    # which estimators to run; "all" expands to ESTIMATOR_NAMES
    estimators: tuple = ESTIMATOR_NAMES
    mode: EstimatorMode = EstimatorMode.MATH

    # batch of concurrent frames processed per step
    batch: int = 1024
    # complex compute dtype: "complex64", or "complex128" for parity runs
    dtype: str = "complex64"

    # MMSE solve strategy: "sm" (Sherman-Morrison rank-1, no solve),
    # "dense" (torch.linalg.solve on the built 53x53 systems — the
    # reference's computational shape), "dense_pallas" (the same systems
    # through the hand-written solve kernel)
    mmse_solver: str = "sm"

    # mesh: number of data-parallel shards over frames, and over OFDM blocks
    dp: int = 1
    blk: int = 1

    # number of blocks averaged into pilot-based estimates
    avg_blocks: int = 4

    def mesh_shape(self):
        return {"dp": self.dp, "blk": self.blk}
