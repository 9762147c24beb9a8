"""CFR and constellation figures (the counterpart of
``tpu80211/utils/plots.py``: the same figures and file names).

The reference's only accuracy record is four PNGs of the estimated channel
frequency response: real/imag parts of all five estimators with pilot
markers (WiFi_RX.m:66-111 → Real_Part.png, Imag_Part.png,
Real_Part_LTS.png, Imag_Part_LTS.png).  `plot_cfr` draws that figure
family from a dict of estimates; `plot_constellation` draws equalized
symbols.  Estimates and symbols may be numpy arrays or tensors on any
device (tensors are moved to the host).

matplotlib is imported inside each function, so importing this module
needs none; a call without it raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu80211_torch import constants as C

# MATLAB plots mark pilots at ±7 and ±21 of the centered axis
# (WiFi_RX.m:70-75); on the 0-based 53-bin axis those are the pilot indices.
_PILOTS = list(C.PILOT_IDX)


def _pyplot(fn: str):
    """matplotlib's pyplot on the Agg backend, or an ImportError naming the
    caller."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(f"{fn} needs matplotlib, which is not installed") from e
    return plt


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def plot_cfr(estimates: dict, out_prefix: str, title: str = "") -> list:
    """Write ``<prefix>_real.png`` and ``<prefix>_imag.png``.

    estimates: {label: (53,) complex array or tensor}.  Returns the paths
    written."""
    plt = _pyplot("plot_cfr")
    k = np.arange(C.N_SC) - C.FFT_SHIFT  # centered subcarrier axis −26…+26
    paths = []
    for part, fn in (("real", np.real), ("imag", np.imag)):
        fig, ax = plt.subplots(figsize=(8, 5))
        for label, h in estimates.items():
            h = _host(h)
            ax.plot(k, fn(h), label=label, linewidth=1.2)
            ax.plot(k[_PILOTS], fn(h)[_PILOTS], "o", markersize=4)
        ax.set_xlabel("subcarrier")
        ax.set_ylabel(f"{part}(H)")
        ax.set_title(title or f"CFR {part} part")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
        path = f"{out_prefix}_{part}.png"
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def plot_constellation(panels: dict, out_path: str, ref_points=None) -> str:
    """Write a constellation scatter figure: one panel per entry of
    ``panels`` ({title: (N,) complex symbols}).  ``ref_points``: ideal
    constellation points to overlay (e.g. the QPSK alphabet).  Returns
    ``out_path``.

    The reference records only CFR curves (WiFi_RX.m:66-111); the
    constellation shows what equalization and sync do to the symbols the
    receiver decides on."""
    plt = _pyplot("plot_constellation")
    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(4.2 * n, 4.2), squeeze=False)
    for ax, (title, sym) in zip(axes[0], panels.items()):
        sym = _host(sym).ravel()
        ax.scatter(sym.real, sym.imag, s=2, alpha=0.25, linewidths=0)
        if ref_points is not None:
            rp = _host(ref_points).ravel()
            ax.scatter(rp.real, rp.imag, s=60, marker="x", color="k", zorder=3)
        ax.set_title(title, fontsize=10)
        ax.set_xlabel("I")
        ax.set_ylabel("Q")
        ax.set_xlim(-2, 2)
        ax.set_ylim(-2, 2)
        ax.set_aspect("equal")
        ax.grid(True, alpha=0.3)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
