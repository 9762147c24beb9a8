"""Packet detection in plain PyTorch on the card: ``ops.detect.detect_packet``
in streams/s (the port of ``scripts/bench_detect.py``).

    python -m tpu80211_torch.bench.detect                   # B=4,096 streams of 2,048, n=24
    python -m tpu80211_torch.bench.detect --device cpu 32 2048 2   # a rehearsal

The workload (`make_streams`, the script's numpy code): seed 0, offsets in
[50, N − 1400), complex AWGN × 0.002, the capture's frame added at each
offset; complex64 on the device.  Step i scales the streams by
(1 + 1e-6·i) and detects, as the script's step does.

Gate, before timing (the script's assert): every stream detected, and
|start − offset| <= 4.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.ops import detect

BATCH, STREAM_LEN, ITERS = 4096, 2048, 24
METRIC = "packet detection + timing sync, streams/s, serialized"


def make_streams(batch: int, n: int) -> tuple[np.ndarray, np.ndarray, object]:
    """The script's streams: (streams (B, n) complex128, offsets (B,),
    the capture)."""
    cap = load_capture()
    rng = np.random.default_rng(0)
    offs = rng.integers(50, n - 1400, batch)
    stream = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))) * 0.002
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    for i, o in enumerate(offs):
        stream[i, o:o + 1360] += frame
    return stream, offs, cap


def detect_case(batch: int, n: int, dev) -> tuple[TP.Case, list[int]]:
    """The gated steps at B and B/2, and the timing error's [min, max]."""
    stream, offs, cap = make_streams(batch, n)
    x = torch.tensor(stream, dtype=torch.complex64, device=dev)
    ref = detect.lts_time_symbol(cap.tx_lptot).to(device=dev, dtype=torch.complex64)
    res = detect.detect_packet(x, ref)
    err = res["start"].cpu().numpy() - offs
    band = [int(err.min()), int(err.max())]
    gates = {"detected": bool(res["detected"].all()), "timing_err_range": band}
    TP.gate("detect", gates["detected"], gates, "a stream not detected")
    TP.gate("detect", bool((np.abs(err) <= 4).all()), gates, "|start - offset| > 4")

    def make_step(k: int):
        xs = x if k == batch else x[:k].contiguous()
        return lambda i: detect.detect_packet(xs * (1.0 + 1e-6 * i), ref)

    return TP.Case(gates, make_step(batch), make_step(batch // 2)), band


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("detect", __doc__)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH, help=f"B (default {BATCH})")
    ap.add_argument("stream_len", nargs="?", type=int, default=STREAM_LEN,
                    help=f"samples a stream (default {STREAM_LEN})")
    ap.add_argument("iters", nargs="?", type=int, default=ITERS,
                    help=f"the loop length n (default {ITERS})")
    args = ap.parse_args(argv)
    dev = CM.open_device(args.device, "detect")
    if dev is None:
        return 1
    case, band = detect_case(args.batch, args.stream_len, dev)
    m = TP.measure(case, args.batch, args.iters, dev)
    ms = m["loop_ms"]["host"]
    doc = {
        "metric": METRIC, "streams_per_s": m["per_s"], "ms_per_batch": ms,
        "samples_per_s": m["per_s"] * args.stream_len, "batch": args.batch,
        "stream_len": args.stream_len, "timing_err_range": band,
        "device": TP.device_name(dev), "gates": case.gates, **CM.fences(m),
    }
    CM.emit({k: v for k, v in doc.items() if k not in ("marginals_s", "single_s")})
    last = {"metric": METRIC + " (host loop marginal)", "device": doc["device"],
            "streams_per_s": round(m["per_s"]), "batch": args.batch,
            "stream_len": args.stream_len, "timing_err_range": band, **CM.short(doc)}
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
