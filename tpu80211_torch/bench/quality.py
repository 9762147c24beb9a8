"""Estimator quality against SNR: NMSE, EVM and BER.

The counterpart of ``tpu80211/bench/quality.py``.  For each SNR point a
batch of synthetic frames with a known channel (``datasets/synthetic.py``,
on a ``torch.Generator`` of the chosen device) goes through the seven
estimators, and each point reports

* the CFR NMSE (dB) of each estimator against the true channel, and
* the post-equalization EVM and hard-decision BER with each estimator on
  the pilot side of the blended equalizer (WiFi_Equalization.m:6-7).

`quality_point` computes with the complex-dtype estimators of ``models/``;
`quality_point_fused` runs the frames, as time-domain samples in a storage
dtype, through the fused chain kernel in per-frame-tx mode (its plain
version on the CPU).  The JAX package draws other random numbers from the
same seed, so the two agree in statistics, not frame by frame.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets import synthetic
from tpu80211_torch.models import lt_ls, ps_interp, ps_mmse
from tpu80211_torch.ops.equalize import equalize
from tpu80211_torch.utils import metrics

KINDS = ("linear", "cubic", "sinc", "spline", "wiener")
DEFAULT_SNRS = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0)
MODULATION_ORDER = {"qpsk": 4, "qam16": 16, "qam64": 64}


def quality_point(snr_db: float, batch: int = 512, seed: int = 0,
                  channel_model: str | None = None, modulation: str = "qpsk",
                  device="cuda") -> dict:
    """One SNR point: {estimator: {nmse_db, evm_rms, ber}} and its settings.
    ``channel_model`` ∈ {None, 'A'..'E'} (ops/channel.py, WiFi_RX.m:6);
    ``modulation`` ∈ {"qpsk", "qam16", "qam64"} (Gray-coded BER)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fb = synthetic.generate(gen, batch, snr_db=snr_db, dtype=torch.complex64,
                            channel_model=channel_model, modulation=modulation)
    txb, rxb = fb.tx_symb, fb.rx_symb
    h_lt = lt_ls(fb.tx_preamble_fft, fb.rx_preamble_fft)
    ests = {"lt_ls": h_lt}
    for kind in KINDS:
        # the Wiener prior matches the channel model and SNR being drawn
        # (the receiver knows its operating environment); the others ignore it
        kw = {"channel_model": channel_model, "snr_db": snr_db} if kind == "wiener" else {}
        ests[f"ps_{kind}"] = ps_interp(txb, rxb, kind, **kw)
    ests["ps_mmse"] = ps_mmse(txb, rxb, fb.ow2, h_lt)

    m = MODULATION_ORDER[modulation]
    row = {"snr_db": float(snr_db), "batch": int(batch), "channel_model": channel_model,
           "modulation": modulation, "estimators": {}}
    for name, h in ests.items():
        eq = equalize(rxb, h_lt, h)
        row["estimators"][name] = {
            "nmse_db": round(metrics.cfr_nmse_db(h, fb.h_true), 2),
            "evm_rms": round(metrics.evm_rms(eq, txb), 4),
            "ber": round(metrics.qam_ber(eq, txb, m), 5),
        }
    return row


def quality_sweep(snrs: Sequence[float] = DEFAULT_SNRS, batch: int = 512, seed: int = 0,
                  channel_model: str | None = None, modulation: str = "qpsk",
                  device="cuda") -> list[dict]:
    return [quality_point(s, batch=batch, seed=seed + i, channel_model=channel_model,
                          modulation=modulation, device=device)
            for i, s in enumerate(snrs)]


def quality_point_fused(snr_db: float, batch: int = 256, seed: int = 0,
                        dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """The same metrics through the fused chain (``fused_rx_chain``: the
    CUDA kernel on a card, per-frame tx) with samples stored in ``dtype``.

    The rx preamble carries independent noise on each LTS repeat, so the
    chain's σ² estimate (WiFi_RX.m:31) is a real one.  EVM and BER are the
    kernel's PS-Linear blended equalizer's (WiFi_RX.m:60); NMSE is reported
    for every estimator."""
    from tpu80211_torch.kernels.fused_chain import OUT_NAMES, fused_rx_chain

    gen = torch.Generator(device=device).manual_seed(seed)
    fb = synthetic.generate(gen, batch, snr_db=snr_db, dtype=torch.complex64)
    pkt_tx = synthetic.synthesize_time(fb.tx_symb)
    pkt_rx = synthetic.synthesize_time(fb.rx_symb)
    tx_lp = synthetic.synthesize_preamble_time(fb.tx_preamble_fft)

    # rx preamble: the channel-filtered LTS plus independent noise per repeat
    sigma = np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    gen2 = torch.Generator(device=device).manual_seed(seed + 9999)
    clean = fb.tx_preamble_fft * fb.h_true

    def repeat() -> torch.Tensor:
        noise = torch.complex(*(torch.randn(clean.shape, generator=gen2, device=clean.device)
                                for _ in range(2)))
        return synthetic._to_time(clean + noise * sigma)

    t1, t2 = repeat(), repeat()
    rx_lp = torch.cat([t1[..., -32:], t1, t2], dim=-1)

    out = fused_rx_chain(*(Cplx.from_complex(x, dtype) for x in (pkt_tx, pkt_rx, tx_lp, rx_lp)))
    row = {"snr_db": float(snr_db), "batch": int(batch), "path": "fused_chain",
           "dtype": str(dtype).split(".")[-1], "estimators": {}}
    for name in OUT_NAMES:
        key = {"h_lt": "lt_ls"}.get(name, "ps_" + name[2:])
        row["estimators"][key] = {
            "nmse_db": round(metrics.cfr_nmse_db(out[name], fb.h_true), 2)}
    eq = out["eq"].to_complex()
    row["eq_linear_blend"] = {"evm_rms": round(metrics.evm_rms(eq, fb.tx_symb), 4),
                              "ber": round(metrics.qpsk_ber(eq, fb.tx_symb), 5)}
    return row


def quality_sweep_fused(snrs: Sequence[float] = DEFAULT_SNRS, batch: int = 256, seed: int = 0,
                        dtype: torch.dtype = torch.bfloat16, device="cuda") -> list[dict]:
    return [quality_point_fused(s, batch=batch, seed=seed + i, dtype=dtype, device=device)
            for i, s in enumerate(snrs)]


def plot_quality(rows: list[dict], out_path: str, fused_rows: list[dict] | None = None) -> str:
    """NMSE and BER against SNR per estimator → PNG (the quantitative
    successor of the reference's Real_Part/Imag_Part.png accuracy record).
    ``fused_rows`` (`quality_sweep_fused`) overlays the fused chain's
    storage-dtype series as dashed NMSE curves.  Needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(rows[0]["estimators"].keys())
    snrs = [r["snr_db"] for r in rows]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    for name in names:
        ax1.plot(snrs, [r["estimators"][name]["nmse_db"] for r in rows], marker="o", label=name)
        ax2.semilogy(snrs, [max(r["estimators"][name]["ber"], 1e-6) for r in rows],
                     marker="o", label=name)
    if fused_rows:
        fsnrs = [r["snr_db"] for r in fused_rows]
        dt = fused_rows[0]["dtype"]
        for name in fused_rows[0]["estimators"]:
            ax1.plot(fsnrs, [r["estimators"][name]["nmse_db"] for r in fused_rows],
                     linestyle="--", marker="x", alpha=0.7, label=f"{name} [fused {dt}]")
        ax2.semilogy(fsnrs, [max(r["eq_linear_blend"]["ber"], 1e-6) for r in fused_rows],
                     linestyle="--", marker="x", color="k", label=f"eq blend [fused {dt}]")
    ax1.legend(fontsize=6)
    ax1.set_xlabel("SNR (dB)")
    ax1.set_ylabel("CFR NMSE (dB)")
    ax1.set_title("Channel-estimation error")
    ax1.grid(True, alpha=0.3)
    ax2.set_xlabel("SNR (dB)")
    ax2.set_ylabel("QPSK BER (floor 1e-6)")
    ax2.set_title("Post-equalization BER (blended equalizer)")
    ax2.grid(True, alpha=0.3)
    ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
