"""The table of peaks and the least time of a piece of work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): 67 TFLOP/s in float32 outside the tensor
cores, 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.  A
card set below 700 W runs slower under load; the run prints the card's
power limit beside its numbers.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_ops_per_s": 67e12, "bf16_tc_ops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind`` (the H100's for a name it does
    not hold: the benchmark is defined on that card)."""
    return PEAKS.get(kind, PEAKS[DEFAULT])


def least_time_s(work: dict, kind: str = DEFAULT) -> float:
    """The least time the card could take for ``work``: the larger of its
    bytes (each input read once, each output written once) at the HBM rate
    and its operations, ``ops`` at the float32 rate plus ``tc_ops`` at the
    tensor cores' bf16 rate."""
    p = peaks(kind)
    t_bytes = work["bytes"] / p["hbm_bytes_per_s"]
    t_ops = work["ops"] / p["f32_ops_per_s"] + work.get("tc_ops", 0.0) / p["bf16_tc_ops_per_s"]
    return max(t_bytes, t_ops)


def share_pct(work: dict, kind: str, seconds: float) -> float:
    """The least time of ``work`` as a share of ``seconds``, in %."""
    return 100.0 * least_time_s(work, kind) / seconds
