"""Accuracy of the generative raw system against SNR, and the detector's
false-alarm rate on pure noise against its threshold (the port of
``scripts/bench_raw_quality.py``).  A record: nothing is timed.

    python -m tpu80211_torch.bench.raw_quality              # B=4,096 a point, on the card
    python -m tpu80211_torch.bench.raw_quality --device cpu 256 --fa-streams 256   # a rehearsal

Each SNR in `SNRS` runs ``raw_gen_chain.gen_raw_system`` (channel, AWGN, a
random timing offset and a 20 kHz CFO per stream, in the kernel) with seed
100 + i and ``equalize_with="h_mmse"``; `quality_row` gives the script's
five rates: detection, timing in the [−4, −2] band and within the cyclic
prefix [−8, 0] (of the detected streams), the median CFO error in Hz and
the post-CPE EVM over the detected streams.

The false-alarm rows: numpy noise (seed 0, 2,048 × 8,192 complex, × 0.01)
through ``detect_streams`` at each threshold in `THRESHOLDS`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import raw_gen_chain as RG

SNRS = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 30.0, 40.0)
BATCH = 4096
SEED0 = 100            # the seed of SNR i is 100 + i
CFO_KHZ = 20.0
THRESHOLDS = (0.3, 0.4, 0.5, 0.6)
FA_STREAMS = 8192      # noise streams of the false-alarm rows
FA_NS = 2048
FS = 20e6              # samples per second: the CFO in cycles a sample → Hz
KERNELS = ("detect", "raw_gen_chain")
METRIC = ("generative raw system accuracy vs SNR (detection, timing, CFO recovery, post-CPE "
          "EVM; cfo_khz=20, equalize_with=h_mmse)")


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def quality_row(out: dict, snr_db: float, batch: int, den: float) -> dict:
    """The script's row (bench_raw_quality.py:66-86) from one
    ``gen_raw_system`` output (torch tensors or arrays); ``den`` is Σ|tx|²
    over the 15 blocks' bins, over 15."""
    det = _np(out["detected"]).astype(bool)
    err = _np(out["start"]).astype(np.int64) - _np(out["offsets"]).astype(np.int64)
    cfo_err_hz = np.abs(_np(out["cfo"]) - _np(out["cfo_true"])) * FS
    evm_s = _np(out["evm_sums"])
    n_det = max(det.sum(), 1)
    return {
        "snr_db": float(snr_db),
        "batch": batch,
        "detect_rate": round(float(det.mean()), 4),
        "timing_in_band_rate": round(float(((err >= -4) & (err <= -2) & det).sum() / n_det), 4),
        "timing_within_cp_rate": round(float(((err >= -8) & (err <= 0) & det).sum() / n_det), 4),
        "cfo_median_err_hz": round(float(np.median(cfo_err_hz[det])), 1) if det.any() else None,
        "evm_rms_detected": (round(float(np.sqrt(evm_s[det].mean() / (15.0 * den))), 4)
                             if det.any() else None),
    }


def fa_noise(streams: int = FA_STREAMS) -> np.ndarray:
    """The false-alarm rows' noise, (2,048, streams) complex128 (the script's
    numpy draws)."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((FA_NS, streams))
            + 1j * rng.standard_normal((FA_NS, streams))) * 0.01


def false_alarms(noise: np.ndarray, lts: Cplx, dev) -> list[dict]:
    """The detected share of ``noise``'s streams at each threshold."""
    xn = Cplx(*(torch.tensor(p, dtype=torch.float32, device=dev)
                for p in (noise.real, noise.imag)))
    rows = []
    for thr in THRESHOLDS:
        res = D.detect_streams(xn, lts, threshold=thr)
        rows.append({"threshold": thr, "false_alarm_rate": float(res["detected"].double().mean()),
                     "streams": noise.shape[1]})
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("raw_quality", __doc__)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH,
                    help=f"streams a point (default {BATCH})")
    ap.add_argument("--fa-streams", type=int, default=FA_STREAMS,
                    help=f"noise streams of the false-alarm rows (default {FA_STREAMS})")
    args = ap.parse_args(argv)
    dev = CM.open_device(args.device, "raw_quality", KERNELS)
    if dev is None:
        return 1
    txc, lts, evm_den = TP.capture_consts(load_capture(), dev)
    rows = []
    for si, snr in enumerate(SNRS):
        out = RG.gen_raw_system(SEED0 + si, args.batch, *txc, lts, snr_db=snr,
                                equalize_with="h_mmse", cfo_khz=CFO_KHZ)
        rows.append(quality_row(out, snr, args.batch, evm_den / 15.0))
        CM.emit(rows[-1])
    fa_rows = false_alarms(fa_noise(args.fa_streams), lts, dev)
    for row in fa_rows:
        CM.emit(row)
    doc = {"metric": METRIC, "device": TP.device_name(dev), "rows": rows,
           "false_alarm_on_noise": fa_rows}
    last = {
        "metric": "raw system accuracy vs SNR: [snr, detect, in band, within CP, CFO err Hz, "
                  "EVM]; false alarms [threshold, rate]",
        "device": doc["device"], "batch": args.batch,
        "rows": [[r["snr_db"], r["detect_rate"], r["timing_in_band_rate"],
                  r["timing_within_cp_rate"], r["cfo_median_err_hz"], r["evm_rms_detected"]]
                 for r in rows],
        "false_alarm": [[r["threshold"], r["false_alarm_rate"]] for r in fa_rows],
    }
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
