"""The raw-sample-stream receiver on the card: detection alone, the staged
system, the one-kernel system, its serving shape and int8 serving (the port
of ``scripts/bench_raw_stream.py``).

    python -m tpu80211_torch.bench.raw_stream               # B=16,384 streams of 2,048, n=24
    python -m tpu80211_torch.bench.raw_stream --device cpu 256 2   # a rehearsal

The workload (`make_streams`, the script's ``_make_streams``): numpy, seed
0, B streams of NS = 2,048 samples of 1e-4 complex AWGN, each carrying the
capture's frame at an offset in [40, NS − 1400), converted from float64
straight to lane-major bf16 planes.  Rows (`ROWS`):

* ``detect`` and ``detect_decimated``: ``detect_streams`` at full
  resolution and at stride 16, streams/s;
* ``system``: the staged receiver ``pipeline.raw.raw_rx_txconst``
  (detection and alignment, then the tx-constant chain), frames/s;
* ``system_fused``, ``system_fused_serve``: the one-kernel receiver,
  ``serve`` off and on;
* ``system_fused_i8_serve``: the same on int8 ADC words
  (``fused_chain.quantize_i8``, the step passed as ``lsb``).

**Gates, all before any timing** (the script's asserts): every stream
detected with start − offset in [−4, −2] (full and decimated detection),
the staged system's checksum finite, the one-kernel system's checksum
finite and its starts in band, the int8 system's starts in band.

Serialization: a system step i runs with ``eps`` = 1e-6·i.  Detection is
scale-free, so where the script rescales the streams each step (an extra
pass over them), a detection step here moves the threshold by 1e-6·i.
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
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.pipeline import raw as P

NS = 2048
BATCH, ITERS = 16384, 24
KERNELS = ("fused_chain", "detect", "raw_chain")
ROWS = ("detect", "detect_decimated", "system", "system_fused", "system_fused_serve",
        "system_fused_i8_serve")
DETECT_NOTE = ("detection is scale-free: step i moves the threshold by 1e-6*i in place of "
               "the script's (1+eps) pass over the streams")


def make_streams(batch: int, rng: np.random.Generator, device="cuda",
                 dtype=torch.bfloat16) -> tuple[Cplx, np.ndarray, object]:
    """The script's ``_make_streams``: (x (NS, B) planes in ``dtype`` on
    ``device``, the offsets (B,) int64, the capture)."""
    cap = load_capture()
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    x = (rng.standard_normal((batch, NS)) + 1j * rng.standard_normal((batch, NS))) * 1e-4
    offs = rng.integers(40, NS - 1400, batch)
    for i, o in enumerate(offs):
        x[i, o:o + 1360] += frame
    xt = np.ascontiguousarray(x.T)
    xc = Cplx(*(torch.from_numpy(np.ascontiguousarray(p)).to(dtype).to(device)
                for p in (xt.real, xt.imag)))
    return xc, offs, cap


def _band(out: dict, offs: torch.Tensor) -> list[int]:
    err = out["start"].long() - offs
    return [int(err.min()), int(err.max())]


def _in_band(band: list[int]) -> bool:
    return -4 <= band[0] and band[1] <= -2


def cases(x: Cplx, offs: np.ndarray, cap, dev) -> tuple[dict, dict]:
    """Every row's gates checked (before any timing) and its steps at B and
    B/2: ({row: Case}, {"timing_err_band": [min, max]})."""
    batch = x.re.shape[1]
    txc, lts, _ = TP.capture_consts(cap, dev)
    offs_t = torch.from_numpy(offs).to(dev)
    xq, lsb = F.quantize_i8(x.map(lambda t: t.float()))
    lsb = float(lsb)   # a host float: a tensor would be read back every step
    halves = {id(x): TP.columns(x, batch // 2), id(xq): TP.columns(xq, batch // 2)}

    def detect(dec):
        return lambda xs, i: D.detect_streams(xs, lts, D.DEFAULT_THRESHOLD * (1 + 1e-6 * i),
                                              decimate=dec)

    def fused(**kw):
        return lambda xs, i: R.raw_rx_txconst_fused(xs, lts, *txc, eps=1e-6 * i, **kw)

    steps = {
        "detect": (x, detect(False)),
        "detect_decimated": (x, detect(True)),
        "system": (x, lambda xs, i: P.raw_rx_txconst(xs, lts, *txc, eps=1e-6 * i)),
        "system_fused": (x, fused()),
        "system_fused_serve": (x, fused(serve=True)),
        "system_fused_i8_serve": (xq, fused(lsb=lsb, serve=True)),
    }
    gates = {}
    for name in ("detect", "detect_decimated"):
        res = steps[name][1](x, 0)
        band = _band(res, offs_t)
        gates[name] = {"detected": bool(res["detected"].all()), "band": band}
        TP.gate(name, gates[name]["detected"], gates[name], "missed packets")
        TP.gate(name, _in_band(band), gates[name], "start - offset outside [-4, -2]")
    for name in ("system", "system_fused", "system_fused_i8_serve"):
        xin, fn = steps[name]
        out = fn(xin, 0)
        gates[name] = {"finite": bool(torch.isfinite(out["checksum"]).all())}
        if name != "system_fused_i8_serve":
            TP.gate(name, gates[name]["finite"], gates[name], "checksum not finite")
        if name != "system":
            gates[name]["band"] = _band(out, offs_t)
            TP.gate(name, _in_band(gates[name]["band"]), gates[name],
                    "start - offset outside [-4, -2]")
    gates["system_fused_serve"] = gates["system_fused"]
    res = {}
    for name, (xin, fn) in steps.items():
        half = halves[id(xin)]
        res[name] = TP.Case(gates[name], lambda i, xin=xin, fn=fn: fn(xin, i),
                            lambda i, half=half, fn=fn: fn(half, i))
    return res, {"timing_err_band": gates["detect"]["band"]}


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("raw_stream", __doc__)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH, help=f"B (default {BATCH})")
    ap.add_argument("iters", nargs="?", type=int, default=ITERS,
                    help=f"the loop length n (default {ITERS})")
    args = ap.parse_args(argv)
    dev = CM.open_device(args.device, "raw_stream", KERNELS)
    if dev is None:
        return 1
    x, offs, cap = make_streams(args.batch, np.random.default_rng(0), dev)
    rows, extra = cases(x, offs, cap, dev)
    doc = {"device": TP.device_name(dev), "batch": args.batch, "ns": NS, **extra}
    for name, case in rows.items():
        m = TP.measure(case, args.batch, args.iters, dev)
        unit = "streams_per_s" if name.startswith("detect") else "frames_per_s"
        doc[name] = {unit: m["per_s"], "ms_per_step": m["loop_ms"]["host"],
                     **({"note": DETECT_NOTE} if name == "detect" else {}),
                     "gates": case.gates, **CM.fences(m)}
        CM.emit({name: {k: v for k, v in doc[name].items()
                        if k not in ("marginals_s", "single_s", "note")}})
    last = {
        "metric": "raw-stream receiver rows, gated, loop-length marginal (host)",
        "device": doc["device"], "batch": args.batch, "ns": NS, **extra,
        "rows": {k: {"per_s": round(doc[k].get("streams_per_s") or doc[k]["frames_per_s"]),
                     **CM.short(doc[k])} for k in ROWS},
    }
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
