"""The one-kernel raw receiver's stage floors on the card, and detection's
sensitivity against its stride (the port of ``scripts/bench_raw_anatomy.py``).

    python -m tpu80211_torch.bench.raw_anatomy              # B=32,768 streams of 2,048, n=24
    python -m tpu80211_torch.bench.raw_anatomy --device cpu 256 2 --sens-batch 256   # a rehearsal

`CONFIGS`, all in this one process (the script ran each in a fresh
process against its runtime's cross-talk), each gated before it is timed
by `throughput.measure`:

* ``chain``: the tx-constant chain on inputs aligned once, untimed, by
  ``detect_and_align``: the receiver's floor if detection were free
  (gate: every stream detected by the alignment, a finite checksum);
* ``detect16/32/64``: ``detect_streams`` at Schmidl & Cox strides 16, 32,
  64 (gates: every stream detected, start − offset in [−4, −2]);
* ``raw16/32/64``: ``raw_rx_txconst_fused`` with ``stream_sums``, h_mmse,
  at those strides (gates: as detection, and EVM rms < 0.1);
* ``raw_i8_serve_stride32``: the same on int8 ADC words, serving outputs,
  stride 32.

Workload: `throughput.raw_pieces` placed by ``place_streams`` (bench.py's
raw rows': the capture's frame at an offset in [40, NS − 1400) over 1e-4
AWGN, bf16).  A step runs with ``eps`` = 1e-6·i; a detection step moves the
threshold by 1e-6·i (detection is scale-free).

The ``sens`` rows: ``generate_raw_lane_major`` with channel A, seed 11,
float32, B = 4,096 a point (``--sens-batch``), SNR 10, 0 and −5 dB, the
detection rate at strides 16, 32 and 64.  ``floors_ms`` as the script
computes them.
"""

from __future__ import annotations

import sys

import torch

from tpu80211_torch.bench import common as CM
from tpu80211_torch.bench import throughput as TP
from tpu80211_torch.datasets import synthetic_sc as SC
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import raw_chain as R

CONFIGS = ("chain", "detect16", "detect32", "detect64",
           "raw16", "raw32", "raw64", "raw_i8_serve_stride32")
BATCH, ITERS = 32768, 24
SENS_BATCH = 4096
SENS_SNRS = (10.0, 0.0, -5.0)
SENS_SEED = 11
STRIDES = (16, 32, 64)
EVM_MAX = 0.1
KERNELS = ("fused_chain", "detect", "raw_chain")
METRIC = "one-kernel raw receiver stage anatomy (one process, serialized marginal)"
DECISION = ("the reference's: default stays stride 16 (matches every committed sensitivity "
            "artifact); decimate=32 recommended high-SNR serving knob; decimate=64 trades "
            "-5 dB detection for max throughput")


class Workload:
    """The raw rows' streams on the device, their offsets, the detector's LTS,
    the tx-constant spectra and the EVM denominator."""

    def __init__(self, batch: int, dev):
        cap = load_capture()
        self.txc, self.lts, self.evm_den = TP.capture_consts(cap, dev)
        sig, noise, self.offs = TP.raw_pieces(cap, batch, dev)
        self.x = D.place_streams(sig, noise, self.offs)
        self.batch = batch


def _gate_detection(name: str, out: dict, offs: torch.Tensor, gates: dict) -> None:
    err = out["start"].long() - offs.long()
    gates["detected"] = bool(out["detected"].all())
    gates["timing_err_band"] = [int(err.min()), int(err.max())]
    TP.gate(name, gates["detected"], gates, "a stream not detected")
    TP.gate(name, -4 <= gates["timing_err_band"][0] and gates["timing_err_band"][1] <= -2,
            gates, "start - offset outside [-4, -2]")


def config_case(config: str, w: Workload) -> TP.Case:
    """One configuration gated, with its steps at B and B/2."""
    gates = {}
    if config == "chain":
        det, lp, pkt = D.detect_and_align(w.x, w.lts)  # aligned once, untimed
        gates["detected"] = bool(det["detected"].all())
        TP.gate(config, gates["detected"], gates, "a stream not detected by the alignment")

        def fn(ins, i):
            return F.fused_rx_chain_txconst(*w.txc, *ins, eps=1e-6 * i)

        full, half = (pkt, lp), (TP.columns(pkt, w.batch // 2), TP.columns(lp, w.batch // 2))
        out = fn(full, 0)
        gates["finite"] = bool(torch.isfinite(out["checksum"]).all())
        TP.gate(config, gates["finite"], gates, "checksum not finite")
        return TP.Case(gates, lambda i: fn(full, i), lambda i: fn(half, i))
    if config.startswith("detect"):
        stride = int(config[len("detect"):])

        def fn(xs, i):
            return D.detect_streams(xs, w.lts, D.DEFAULT_THRESHOLD * (1 + 1e-6 * i),
                                    decimate=stride)

        x = w.x
        _gate_detection(config, fn(x, 0), w.offs, gates)
    else:
        kw = dict(stream_sums=True, equalize_with="h_mmse")
        if config == "raw_i8_serve_stride32":
            x, lsb = F.quantize_i8(w.x.map(lambda t: t.float()))
            kw.update(lsb=float(lsb), serve=True, decimate=32)
        else:
            x = w.x
            kw.update(decimate=int(config[len("raw"):]))

        def fn(xs, i):
            return R.raw_rx_txconst_fused(xs, w.lts, *w.txc, eps=1e-6 * i, **kw)

        out = fn(x, 0)
        _gate_detection(config, out, w.offs, gates)
        gates["evm_rms"] = float(torch.sqrt(out["evm_sums"].double().sum()
                                            / (w.batch * w.evm_den)))
        TP.gate(config, gates["evm_rms"] < EVM_MAX, gates, f"EVM rms not below {EVM_MAX}")
    half = TP.columns(x, w.batch // 2)
    return TP.Case(gates, lambda i: fn(x, i), lambda i: fn(half, i))


def row_name(config: str) -> str:
    """The script's name of a configuration's row."""
    if config == "chain":
        return "chain_only_prealigned"
    if config.startswith("detect"):
        return f"detect_only_stride{config[len('detect'):]}"
    if config.startswith("raw") and config[3:].isdigit():
        return f"raw_system_stride{config[3:]}"
    return config


def sens_rows(txc, lts, batch: int, dev) -> list[dict]:
    """Detection rates at each stride on channel-A streams at `SENS_SNRS`."""
    rows = []
    for snr in SENS_SNRS:
        gen = torch.Generator(device=dev).manual_seed(SENS_SEED)
        x, _, _ = SC.generate_raw_lane_major(gen, batch, *txc, snr_db=snr, dtype=torch.float32,
                                             channel_model="A")
        row = {"snr_db": snr, "detect": {}}
        for dec in STRIDES:
            det = D.detect_streams(x, lts, decimate=dec)["detected"]
            row["detect"][f"s{dec}"] = round(float(det.double().mean()), 4)
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = CM.parser("raw_anatomy", __doc__)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH, help=f"B (default {BATCH})")
    ap.add_argument("iters", nargs="?", type=int, default=ITERS,
                    help=f"the loop length n (default {ITERS})")
    ap.add_argument("--sens-batch", type=int, default=SENS_BATCH,
                    help=f"streams a sensitivity point (default {SENS_BATCH})")
    args = ap.parse_args(argv)
    dev = CM.open_device(args.device, "raw_anatomy", KERNELS)
    if dev is None:
        return 1
    w = Workload(args.batch, dev)
    rows = []
    for config in CONFIGS:
        case = config_case(config, w)
        m = TP.measure(case, args.batch, args.iters, dev)
        extra = {k: case.gates[k] for k in ("timing_err_band", "evm_rms") if k in case.gates}
        rows.append({"config": row_name(config), **extra, "batch": args.batch,
                     "iters": args.iters, "per_s": m["per_s"], "ms_per_step": m["loop_ms"]["host"],
                     "device": TP.device_name(dev), "gates": case.gates, **CM.fences(m)})
        CM.emit({k: v for k, v in rows[-1].items() if k not in ("marginals_s", "single_s")})
    sens = sens_rows(w.txc, w.lts, args.sens_batch, dev)
    for row in sens:
        CM.emit(row)
    by = {r["config"]: r for r in rows}

    def floor(name: str, clock: int = 1):
        return by[name]["loop_ms"][clock]

    floors = {clock: {
        "chain_if_detection_were_free": floor("chain_only_prealigned", k),
        "detection_alone_stride16": floor("detect_only_stride16", k),
        "full_system_stride16": floor("raw_system_stride16", k),
    } for clock, k in (("host", 1), ("event", 0))}
    for f in floors.values():
        f["fusion_saving"] = (None if None in f.values() else
                              f["chain_if_detection_were_free"] + f["detection_alone_stride16"]
                              - f["full_system_stride16"])
    doc = {
        "metric": METRIC, "rows": rows,
        "sensitivity_vs_stride": {
            "workload": f"generate_raw_lane_major, channel A, B={args.sens_batch}/point",
            "rows": sens, "decision": DECISION},
        "floors_ms": floors["host"], "floors_ms_event": floors["event"],
    }
    last = {
        "metric": METRIC, "device": TP.device_name(dev), "batch": args.batch,
        "rows": {r["config"]: [round(r["per_s"]), *TP.rounded(r["loop_ms"], 4),
                               TP.rounded(r["idle_share"], 3)] for r in rows},
        "row_fields": "[per_s, event ms, host ms, idle]",
        "sens": [[r["snr_db"], *r["detect"].values()] for r in sens],
        "floors_ms": TP.rounded(floors["host"], 4),
    }
    return CM.finish(last, doc, args.out)


if __name__ == "__main__":
    sys.exit(main())
