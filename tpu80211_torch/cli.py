"""The command line: ``python -m tpu80211_torch <command>`` (or the
``tpu80211-torch`` console script).

The counterpart of ``tpu80211/cli.py``: the same ten subcommands and, where
each still means something, the same options.  Every command that computes
runs on the CUDA card unless ``--device cpu`` asks for the CPU; asked for
the card where there is none, it exits non-zero and never carries on on the
CPU.  Modules are imported inside each command, so importing this one
loads no matplotlib and builds no kernel.

Commands:
  run        — the seven estimators on the shipped capture (the reference
               programs' workload), printing H_EST per subcarrier
  bench      — a gated frames/s row of ``tpu80211_torch.bench.throughput``
  parity     — the port's estimators against the native 80-bit C++ oracle
  stream     — synthetic frames through the chain, host-fed or made on the card
  sweep      — the (dp, blk) scaling sweep inside a ``torch.distributed`` world
  plot       — the CFR figures (needs matplotlib)
  sync       — CFO/CPE synchronization on frames with a carrier offset
  quality    — NMSE/EVM/BER against SNR
  raw        — raw sample streams through the one-kernel raw receiver
  devices    — the CUDA devices present

Stated differences from the JAX command: ``--device`` on every command that
computes (the JAX command pins the complex-dtype commands to the CPU,
because the TPU runtime cannot lower complex dtypes; here they run on the
card at complex128, or complex64 where the JAX command uses it);
``stream --engine`` takes ``torch`` where the JAX one takes ``jax``; ``raw``
takes any batch (no round-up to 128, a TPU lane rule).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

MODES = ["math", "matlab", "c_parity"]
# the commands that compute, and so take --device
DEVICE_COMMANDS = ("run", "bench", "parity", "stream", "sweep", "plot", "sync", "quality", "raw")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu80211-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run estimators on the shipped capture")
    run.add_argument("--estimators", default="all",
                     help="comma list of lt_ls,ps_linear,ps_cubic,ps_sinc,"
                          "ps_spline,ps_wiener,ps_mmse (default all)")
    run.add_argument("--mode", default="math", choices=MODES)
    run.add_argument("--avg-blocks", type=int, default=4)
    run.add_argument("--quiet", action="store_true",
                     help="print timing only, not the 53 CFR values")

    bench = sub.add_parser("bench", help="full-chain frames/s benchmark (one gated row of "
                           "python -m tpu80211_torch.bench.throughput)")
    bench.add_argument("--batch", type=int, default=32768)
    bench.add_argument("--iters", type=int, default=48)
    bench.add_argument("--xla", action="store_true",
                       help="the plain PyTorch chain (sc.rx_chain, complex64) instead of "
                            "the fused CUDA kernel")
    bench.add_argument("--f32", action="store_true",
                       help="f32 storage instead of bf16")
    bench.add_argument("--txconst", action="store_true",
                       help="tx-constant production shape (shared known transmit packet)")
    bench.add_argument("--txserve", action="store_true",
                       help="tx-constant SERVING shape (only h_wiener/h_mmse/eq/sigma2/cfo "
                            "written at batch width)")

    par = sub.add_parser("parity", help="the port's estimators vs the native C++ oracle")
    par.add_argument("--mode", default="math", choices=MODES)

    st = sub.add_parser("stream", help="stream synthetic frames through the chain")
    st.add_argument("--batches", type=int, default=4)
    st.add_argument("--batch", type=int, default=1024)
    st.add_argument("--out-dir", default=None,
                    help="persist per-batch H_EST shards + resume cursor")
    st.add_argument("--snr-db", type=float, default=40.0)
    st.add_argument("--engine", default="native", choices=("native", "torch"),
                    help="host-side frame producer: the multithreaded C++ data engine "
                         "(default) or the torch CPU generator")
    st.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    st.add_argument("--device-gen", action="store_true",
                    help="device-resident stream: synthesize frames ON the card and run "
                         "the tx-constant chain there (persists per-batch summaries + "
                         "sampled estimates instead of full H_EST shards)")
    st.add_argument("--channel-model", default=None, choices=["A", "B", "C", "D", "E"],
                    help="ETSI BRAN power-delay profile for --device-gen")
    st.add_argument("--gen", default="kernel", choices=["kernel", "xla", "raw", "kernel_raw"],
                    help="--device-gen generator: 'kernel' (frames drawn inside the chain "
                         "kernel), 'xla' (torch generation of time-domain frames + the "
                         "tx-const chain kernel), 'raw' (raw sample streams at random "
                         "offsets → the one-kernel detect+align+chain receiver), or "
                         "'kernel_raw' (the whole raw system — synthesis through "
                         "estimation — in ONE kernel)")

    sw = sub.add_parser("sweep", help="mesh-shape scaling sweep")
    sw.add_argument("--batch", type=int, default=4096)
    sw.add_argument("--iters", type=int, default=5)

    pl = sub.add_parser("plot", help="write CFR PNGs (the reference's Real_Part/Imag_Part "
                        "artifact family; needs matplotlib)")
    pl.add_argument("--out-prefix", default="artifacts/cfr")
    pl.add_argument("--mode", default="math", choices=MODES)

    sy = sub.add_parser("sync", help="CFO/CPE synchronization demo: impair synthetic frames "
                        "with a carrier frequency offset, estimate + correct it (ops/cfo.py)")
    sy.add_argument("--batch", type=int, default=64)
    sy.add_argument("--fo-hz", type=float, default=20e3,
                    help="carrier frequency offset (the capture's generation value, "
                         "WiFi_RX.m:9)")
    sy.add_argument("--snr-db", type=float, default=40.0)
    sy.add_argument("--constellation", metavar="PNG",
                    help="write a before/after equalized-constellation scatter to this "
                         "path (needs matplotlib)")

    qu = sub.add_parser("quality", help="estimator accuracy benchmark: NMSE/EVM/BER vs SNR "
                        "(the quantitative successor of the reference's plot-PNG accuracy "
                        "record)")
    qu.add_argument("--snrs", default="0,5,10,15,20,25,30,35,40",
                    help="comma-separated SNR points in dB")
    qu.add_argument("--batch", type=int, default=512)
    qu.add_argument("--png", default=None,
                    help="also write NMSE/BER-vs-SNR curves to this PNG (needs matplotlib)")
    qu.add_argument("--fused-dtype", default=None, choices=["bf16", "f32"],
                    help="also sweep the fused whole-chain CUDA kernel at this storage "
                         "dtype (the bench configuration) and overlay it in the PNG")
    qu.add_argument("--channel-model", default=None, choices=["A", "B", "C", "D", "E"],
                    help="ETSI BRAN power-delay profile (the reference's WiFi_RX.m:6 "
                         "parameter; default: the legacy rms-100ns profile)")
    qu.add_argument("--modulation", default="qpsk", choices=["qpsk", "qam16", "qam64"],
                    help="data-subcarrier constellation (Gray-coded BER; the reference "
                         "is QPSK-only)")

    raw = sub.add_parser("raw", help="raw-sample-stream receiver demo: synthesize streams "
                         "with the capture embedded at random offsets, run the one-kernel "
                         "detect+align+chain receiver (kernels/raw_chain.py)")
    raw.add_argument("--batch", type=int, default=512, help="number of streams")
    raw.add_argument("--ns", type=int, default=2048,
                     help="samples per stream (multiple of 64)")
    raw.add_argument("--noise-amp", type=float, default=1e-4,
                     help="AWGN amplitude under the embedded capture")
    raw.add_argument("--threshold", type=float, default=None,
                     help="detection threshold on the normalized metric "
                          "(default: ops/detect.py's 0.5)")
    raw.add_argument("--decimate", type=int, default=16, choices=[16, 32, 64],
                     help="coarse Schmidl&Cox stride: 16 = the sensitivity-record "
                          "default; 32 = high-SNR serving; 64 = max throughput (PERF.md "
                          "gives the card's times)")
    raw.add_argument("--seed", type=int, default=0)

    sub.add_parser("devices", help="show the CUDA devices")

    for name in DEVICE_COMMANDS:
        sub.choices[name].add_argument(
            "--device", default="cuda",
            help="cuda (default: the card; exits non-zero without one) or cpu")
    return p


def _capture_tensors(dev):
    """The capture's preamble spectra and blocks as complex128 tensors on
    ``dev``: (tx_pre, rx_pre, tx_blocks, rx_blocks), and the capture."""
    import torch

    from tpu80211_torch.datasets.loader import load_capture

    cap = load_capture()
    t = [torch.tensor(x, dtype=torch.complex128, device=dev)
         for x in (cap.tx_preamble_fft, cap.rx_preamble_fft, cap.tx_symb, cap.rx_symb)]
    return (*t, cap)


def run_estimators(names, mode: str = "math", avg_blocks: int = 4, device="cuda") -> dict:
    """``run``'s work: each named estimator on the capture at complex128 on
    ``device``; returns {name: (ms, (53,) complex128 numpy array)}, the
    time taken to the estimate on the host.  Raises KeyError on an unknown
    name."""
    import torch

    from tpu80211_torch.config import EstimatorMode
    from tpu80211_torch.models import PS_ESTIMATORS, lt_ls, ps_mmse

    mode = EstimatorMode(mode)
    tx_pre, rx_pre, txb, rxb, cap = _capture_tensors(torch.device(device))
    h_lt = lt_ls(tx_pre, rx_pre, mode=mode)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        if name == "lt_ls":
            h = h_lt
        elif name == "ps_mmse":
            h = ps_mmse(txb, rxb, cap.ow2, h_lt, mode=mode, avg_blocks=avg_blocks)
        elif name in PS_ESTIMATORS:
            h = PS_ESTIMATORS[name](txb, rxb, mode=mode, avg_blocks=avg_blocks)
        else:
            raise KeyError(name)
        h = h.cpu().numpy()
        out[name] = ((time.perf_counter() - t0) * 1e3, h)
    return out


def _cmd_run(args) -> int:
    from tpu80211_torch.config import ESTIMATOR_NAMES

    names = ESTIMATOR_NAMES if args.estimators == "all" else tuple(args.estimators.split(","))
    try:
        res = run_estimators(names, args.mode, args.avg_blocks, args.device)
    except KeyError as e:
        print(f"unknown estimator {e.args[0]!r}", file=sys.stderr)
        return 2
    for name, (ms, h) in res.items():
        print(f"# {name} ({args.mode}): {ms:.2f} ms")
        if not args.quiet:
            for i, v in enumerate(h):
                print(f"H_EST[{i}] = {v.real:+.10e} {v.imag:+.10e}i")
    return 0


def _cmd_bench(args) -> int:
    from tpu80211_torch.bench import throughput

    # bench.py's single-path mode (bench.py:542-552): the path flag, B and n
    path = ("plain" if args.xla else "txserve" if args.txserve
            else "txconst" if args.txconst else "fused")
    argv = [f"--{path}", str(args.batch), str(args.iters), "--device", args.device]
    if args.f32:
        argv.append("--f32")
    return throughput.main(argv)


def _rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cmd_parity(args) -> int:
    import torch

    from tpu80211_torch.config import EstimatorMode
    from tpu80211_torch.models import lt_ls, ps_interp, ps_mmse
    from tpu80211_torch.parity import oracle_native as nat

    mode = EstimatorMode(args.mode)
    dev = torch.device(args.device)
    tx_pre, rx_pre, txb, rxb, cap = _capture_tensors(dev)
    report = {}
    h_lt_nat = nat.lt_ls(cap.tx_preamble_fft, cap.rx_preamble_fft, mode)
    report["lt_ls"] = _rel(lt_ls(tx_pre, rx_pre, mode=mode).cpu(), h_lt_nat)
    for kind in ("linear", "cubic", "sinc", "spline"):
        got = ps_interp(txb, rxb, kind, mode=mode).cpu()
        report[f"ps_{kind}"] = _rel(got, nat.ps_interp(cap.tx_symb, cap.rx_symb, kind, mode))
    h_lt = torch.tensor(h_lt_nat, dtype=torch.complex128, device=dev)
    got = ps_mmse(txb, rxb, cap.ow2, h_lt, mode=mode).cpu()
    report["ps_mmse"] = _rel(got, nat.ps_mmse(cap.tx_symb, cap.rx_symb, cap.ow2, h_lt_nat, mode))

    ok = all(v < 1e-6 for v in report.values())
    print(json.dumps({"mode": mode.value, "max_rel_err": report, "pass": ok}))
    return 0 if ok else 1


def _cmd_stream(args) -> int:
    from tpu80211_torch.pipeline import stream

    if args.device_gen:
        res = stream.run_stream_device(args.batches, args.batch, snr_db=args.snr_db,
                                       out_dir=args.out_dir, channel_model=args.channel_model,
                                       gen=args.gen, device=args.device)
    else:
        res = stream.run_stream(
            stream.synthetic_batches(args.batches, args.batch, snr_db=args.snr_db,
                                     engine=args.engine),
            out_dir=args.out_dir, device=args.device)
    print(json.dumps(res))
    return 0


def _cmd_sweep(args) -> int:
    from tpu80211_torch.bench.scaling import run_sweep

    rows, rank = run_sweep(batch=args.batch, iters=args.iters, device=args.device)
    if rank == 0:
        for row in rows:
            print(json.dumps(row))
    return 0


def _cmd_plot(args) -> int:
    import pathlib

    import torch

    from tpu80211_torch.config import EstimatorMode
    from tpu80211_torch.models import lt_ls, ps_interp, ps_mmse
    from tpu80211_torch.utils.plots import plot_cfr

    mode = EstimatorMode(args.mode)
    tx_pre, rx_pre, txb, rxb, cap = _capture_tensors(torch.device(args.device))
    h_lt = lt_ls(tx_pre, rx_pre, mode=mode)
    ests = {"LT-LS": h_lt}
    for kind in ("linear", "cubic", "sinc", "spline"):
        ests[f"PS-{kind}"] = ps_interp(txb, rxb, kind, mode=mode)
    ests["PS-MMSE"] = ps_mmse(txb, rxb, cap.ow2, h_lt, mode=mode)

    pathlib.Path(args.out_prefix).parent.mkdir(parents=True, exist_ok=True)
    paths = plot_cfr(ests, args.out_prefix, title=f"CFR estimates ({mode.value} mode)")
    # the LTS-only pair mirrors Real_Part_LTS.png / Imag_Part_LTS.png
    paths += plot_cfr({"LT-LS": ests["LT-LS"]}, args.out_prefix + "_lts",
                      title=f"LT-LS CFR ({mode.value} mode)")
    for pth in paths:
        print(pth)
    return 0


def _cmd_sync(args) -> int:
    import torch

    from tpu80211_torch import constants as C
    from tpu80211_torch.datasets import synthetic
    from tpu80211_torch.ops import cfo
    from tpu80211_torch.pipeline import sc

    dev = torch.device(args.device)
    eps_true = args.fo_hz / 20e6
    fb = synthetic.generate(torch.Generator(device=dev).manual_seed(11), args.batch,
                            snr_db=args.snr_db)
    tx_pkt = synthetic.synthesize_time(fb.tx_symb)
    rx_pkt = synthetic.apply_time_cfo(synthetic.synthesize_time(fb.rx_symb), eps_true,
                                      start=C.PREAMBLE_SAMPLES)
    tx_lp = synthetic.synthesize_preamble_time(fb.tx_preamble_fft)
    rx_lp = synthetic.apply_time_cfo(synthetic.synthesize_preamble_time(fb.rx_preamble_fft),
                                     eps_true)

    eps_hat = float(cfo.estimate_cfo(rx_lp).double().mean())
    tx = fb.tx_symb.cpu().numpy()
    mask = C.DATA_MASK

    def run(sync):
        eq = sc.rx_chain(tx_pkt, rx_pkt, tx_lp, rx_lp, equalize_with="h_mmse",
                         sync=sync).eq.cpu().numpy()
        return eq, float(np.median(np.abs(eq - tx)[..., mask]))

    eq_raw, err_raw = run(False)
    eq_sync, err_sync = run(True)
    result = {
        "fo_hz_true": args.fo_hz,
        "fo_hz_estimated": eps_hat * 20e6,
        "median_symbol_err_uncorrected": round(err_raw, 5),
        "median_symbol_err_sync": round(err_sync, 5),
    }
    if args.constellation:
        from tpu80211_torch.utils.plots import plot_constellation

        qpsk = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2.0)
        result["constellation_png"] = plot_constellation(
            {f"uncorrected ({args.fo_hz / 1e3:g} kHz CFO)": eq_raw[..., mask],
             "after CFO derotation + pilot CPE": eq_sync[..., mask]},
            args.constellation, ref_points=qpsk)
    print(json.dumps(result))
    return 0


def _cmd_quality(args) -> int:
    import torch

    from tpu80211_torch.bench import quality

    snrs = [float(s) for s in args.snrs.split(",") if s.strip()]
    rows = quality.quality_sweep(snrs, batch=args.batch, channel_model=args.channel_model,
                                 modulation=args.modulation, device=args.device)
    for row in rows:
        print(json.dumps(row))
    fused_rows = None
    if args.fused_dtype:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[args.fused_dtype]
        fused_rows = quality.quality_sweep_fused(snrs, batch=min(args.batch, 256), dtype=dt,
                                                 device=args.device)
        for row in fused_rows:
            print(json.dumps(row))
    if args.png:
        import pathlib

        pathlib.Path(args.png).parent.mkdir(parents=True, exist_ok=True)
        print(quality.plot_quality(rows, args.png, fused_rows=fused_rows))
    return 0


def _cmd_raw(args) -> int:
    """Raw-stream receiver demo: streams in, detection + estimates out."""
    import torch

    from tpu80211_torch.cplx import Cplx
    from tpu80211_torch.datasets.loader import load_capture
    from tpu80211_torch.kernels.fused_chain import tx_spectra
    from tpu80211_torch.kernels.raw_chain import raw_rx_txconst_fused
    from tpu80211_torch.ops.detect import lts_time_symbol

    b, ns = args.batch, args.ns
    # offsets are drawn from [40, ns-1400) and the 1360-sample frame is
    # embedded at offset+1360 <= ns; 1472 (= 23*64) is the smallest
    # multiple of 64 leaving that draw range non-empty
    if ns % 64 or ns < 1472:
        print(f"--ns {ns}: need a multiple of 64 of at least 1472 samples (40-sample min "
              "offset + 1360-sample frame + draw margin)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    cap = load_capture()
    rng = np.random.default_rng(args.seed)
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    x = (rng.standard_normal((b, ns)) + 1j * rng.standard_normal((b, ns))) * args.noise_amp
    offs = rng.integers(40, ns - 1400, b)
    for i, o in enumerate(offs):
        x[i, o:o + 1360] += frame

    def planes(a) -> Cplx:
        a = np.asarray(a)
        return Cplx(*(torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=dev)
                      for v in (a.real, a.imag)))

    xc = planes(x.T)
    del x
    lts = planes(lts_time_symbol(cap.tx_lptot).numpy())
    txs, tpre = tx_spectra(planes(cap.tx_packet), planes(cap.tx_lptot))
    t0 = time.perf_counter()
    out = raw_rx_txconst_fused(xc, lts, txs, tpre, threshold=args.threshold,
                               decimate=args.decimate)
    start = out["start"].cpu().numpy()
    dt = time.perf_counter() - t0
    err = start - offs
    det = out["detected"].cpu().numpy().astype(bool)
    print(json.dumps({
        "streams": b, "ns": ns,
        "detected": int(det.sum()),
        "timing_err_min": int(err[det].min()) if det.any() else None,
        "timing_err_max": int(err[det].max()) if det.any() else None,
        "metric_mean": round(float(out["metric"].double().mean()), 4),
        "h_mmse_mean_abs": round(float(out["h_mmse"].re.double().abs().mean()), 6),
        "wall_s": round(dt, 3),
        "note": "wall_s includes the kernel build on first use; see "
                "python -m tpu80211_torch.bench.throughput --raw for gated throughput",
    }))
    return 0


def _cmd_devices(_args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("devices: no CUDA device", file=sys.stderr)
        return 1
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"cuda:{i} {p.name} compute capability {p.major}.{p.minor}, "
              f"{p.total_memory / 2 ** 30:.1f} GiB")
    return 0


COMMANDS = {
    "run": _cmd_run,
    "bench": _cmd_bench,
    "parity": _cmd_parity,
    "stream": _cmd_stream,
    "sweep": _cmd_sweep,
    "plot": _cmd_plot,
    "sync": _cmd_sync,
    "quality": _cmd_quality,
    "raw": _cmd_raw,
    "devices": _cmd_devices,
}


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if getattr(args, "cpu", False):
        args.device = "cpu"
    if args.cmd in DEVICE_COMMANDS:
        import torch

        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            print(f"{args.cmd}: no CUDA device (pass --device cpu to run on the CPU)",
                  file=sys.stderr)
            return 1
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
