"""Streams: the receive chain over an unbounded frame stream.

The counterpart of ``tpu80211/pipeline/stream.py``, in two halves.

**The host stream** (`run_stream`, `synthetic_batches`,
`native_time_batches`): batches made on the host (the native C++ engine
or a ``torch.Generator``) go through a receive function on the device in
fixed-size batches.  Batch i+1 is uploaded from pinned host memory without
blocking while batch i runs; batch i's estimates are copied back into
pinned memory behind its work, and written (``h_est_{i:06d}.npz``, with a
``cursor.json`` for resume) once batch i+1 is dispatched.

**The device-resident stream** (``make_device_stream_step``,
``run_stream_device``): frames made and received on the card.  A streamed step is
tx-constant (every frame carries the shipped capture's packet) and draws a
fresh channel and noise per frame on the device; only per-batch summaries
and a sampled record leave it.  Four generators:

* ``"kernel"`` (the default): ``kernels.gen_chain.fused_gen_chain`` draws
  the frames inside the chain kernel, in its stream configuration (error
  sums per estimator; no h planes at batch width);
* ``"xla"``: ``datasets.synthetic_sc.generate_rx_lane_major`` (torch
  draws, the time-domain frame) into the tx-constant chain kernel;
* ``"raw"``: ``generate_raw_lane_major`` (the frame at a random offset in a
  raw stream, placed by the placement kernel) into the one-kernel raw
  receiver; the summary reports detection, timing and EVM;
* ``"kernel_raw"``: ``kernels.raw_gen_chain.gen_raw_system``, synthesis,
  detection and the chain in one kernel.

The carried state is a 0-d int32 device tensor derived from the batch's
checksums; the kernel generators fold it into their seed on the device
(int32 wrap-around, as the JAX step), so a step never reads the host.  The
``xla`` and ``raw`` generators draw from a ``torch.Generator`` seeded on
the host by (seed, batch index): folding the device state into it would
need a host read each step, so their draws do not depend on it.  Resume is
bit-deterministic: the state after every batch is persisted in
``cursor.json``.

Where the JAX package clamps the detected count to 1, a batch with no
detection here reports ``evm_rms`` NaN, not a perfect 0.

**On a mesh** (``parallel/``, one process per device): the ``kernel`` and
``kernel_raw`` steps run batch / dp frames on each rank and pool their
summaries with one all-reduce over dp; ``kernel_raw`` pools the EVM over
the detected streams of every rank, where the JAX mesh step divides the
sum over all streams by the batch.  ``run_stream`` runs each rank's dp
slice of every host batch and writes that rank's rows to shards and a
cursor of its own (``.rank{r}`` before the suffix): a multi-process JAX job
cannot gather its sharded outputs into one file either.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx, tree_map
from tpu80211_torch.datasets import native_engine, synthetic, synthetic_sc
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels import gen_chain as G
from tpu80211_torch.kernels import raw_chain as R
from tpu80211_torch.kernels import raw_gen_chain as RG
from tpu80211_torch.ops.detect import lts_time_symbol
from tpu80211_torch.parallel import mesh as M
from tpu80211_torch.pipeline import sc

_STREAM_ESTS = F.OUT_NAMES
GENERATORS = ("kernel", "xla", "raw", "kernel_raw")
MESH_GENERATORS = ("kernel", "kernel_raw")
_SEED_MIX = 2654435761 % 2 ** 31   # the JAX step's state multiplier
_BATCH_MIX = 65537                 # and its batch-index multiplier
_RANK_MIX = 97003                  # and its dp-rank multiplier


class _Sink:
    """Per-batch records under ``out_dir`` and the resume cursor: the
    batches done, and the carried state after each of them.  ``tag`` goes
    before each file's suffix (one rank's files of a mesh run)."""

    def __init__(self, out_dir, resume, tag: str = ""):
        self.dir = pathlib.Path(out_dir) if out_dir else None
        self.tag = tag
        self.cursor = set()
        self.states: dict[str, int] = {}
        if self.dir:
            self.dir.mkdir(parents=True, exist_ok=True)
            cur = self.dir / f"cursor{tag}.json"
            if resume and cur.exists():
                rec = json.loads(cur.read_text())
                self.cursor = set(rec["done"])
                self.states = rec.get("states", {})

    def done(self, i: int) -> bool:
        return i in self.cursor

    def state_after(self, i: int):
        """The persisted carried state after batch ``i`` (None if the cursor
        has none)."""
        return self.states.get(str(i))

    def _write_cursor(self) -> None:
        (self.dir / f"cursor{self.tag}.json").write_text(
            json.dumps({"done": sorted(self.cursor), "states": self.states}))

    def write(self, i: int, arrs: dict) -> None:
        """Batch ``i``'s estimates (numpy arrays by name) as a shard, then
        the cursor."""
        if not self.dir:
            return
        np.savez_compressed(self.dir / f"h_est_{i:06d}{self.tag}.npz", **arrs)
        self.cursor.add(i)
        self._write_cursor()

    def path_str(self):
        return str(self.dir) if self.dir else None


# -- the host stream --------------------------------------------------------------------------


def _upload(host_args, dev: torch.device):
    """The batch's arguments on ``dev``: on a card, each tensor is copied
    into pinned host memory and uploaded without blocking the host."""
    if dev.type == "cuda":
        return tree_map(lambda t: t.pin_memory().to(dev, non_blocking=True), host_args)
    return tree_map(lambda t: t.to(dev), host_args)


def _stage(out, dev: torch.device, keep: bool):
    """Start copying a batch's estimates to the host behind its work: (the
    host tensors by name, or None without ``keep``; the frame count; an
    event recorded after the copies on a card, else None)."""
    h = out.h_mmse
    lead = (h.re if isinstance(h, Cplx) else h).shape[:-1]
    host = None
    if keep:
        host = {}
        for name in _STREAM_ESTS:
            v = getattr(out, name)
            v = v.to_complex() if isinstance(v, Cplx) else v
            if dev.type == "cuda":
                pinned = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[name] = pinned.copy_(v, non_blocking=True)
            else:
                host[name] = v
    event = None
    if dev.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return host, int(np.prod(lead)) if lead else 1, event


def _finish(pending, sink: _Sink) -> int:
    """Fence batch ``i`` (its event), write its shard; returns its frames."""
    i, (host, frames, event) = pending
    if event is not None:
        event.synchronize()
    if host is not None:
        sink.write(i, {k: v.numpy() for k, v in host.items()})
    return frames


def run_stream(batches: Iterable, fn: Callable | None = None, mesh=None,
               out_dir: str | None = None, resume: bool = True, device="cuda") -> dict:
    """Drive ``fn`` (default: ``sc.rx_chain_freq``) over an iterator of
    argument tuples on ``device``; returns the frames and batches run.

    Each element of ``batches`` is the argument tuple of ``fn``: host
    tensors, numpy arrays or `Cplx` planes, batch first.  ``fn`` returns a
    named tuple with the seven estimates (``h_lt`` … ``h_mmse``, complex
    tensors or `Cplx`).  With ``out_dir``, writes ``h_est_{i:06d}.npz``
    (complex64, one array per estimate) and ``cursor.json``; with
    ``resume``, skips the batches the cursor holds.

    Order per batch i: upload (pinned, non-blocking), dispatch ``fn``,
    start the estimates' copy to pinned host memory, then fence and write
    batch i − 1; the iterator makes batch i + 1 while batch i runs.

    ``mesh``: a ('dp', …) `parallel.make_mesh` mesh; every rank of its
    world iterates the same batches and runs its dp rows of each
    (``parallel.shard_batch``), writing ``h_est_{i:06d}.rank{r}.npz`` and
    ``cursor.rank{r}.json``; the counts returned are this rank's."""
    fn = sc.rx_chain_freq if fn is None else fn
    dev = torch.device(device)
    sink = _Sink(out_dir, resume, "" if mesh is None else f".rank{dist.get_rank()}")
    n_frames = n_batches = 0
    pending = None
    for i, host_args in enumerate(batches):
        if sink.done(i):
            continue
        if mesh is not None:
            host_args = M.shard_batch(mesh, host_args, "cpu")
        out = fn(*_upload(host_args, dev))
        staged = _stage(out, dev, sink.dir is not None)
        if pending is not None:
            n_frames += _finish(pending, sink)
            n_batches += 1
        pending = (i, staged)
    if pending is not None:
        n_frames += _finish(pending, sink)
        n_batches += 1
    return {"frames": n_frames, "batches": n_batches, "out_dir": sink.path_str()}


ENGINES = ("native", "torch")


def synthetic_batches(n_batches: int, batch: int, seed: int = 0, snr_db: float = 40.0,
                      engine: str = "torch"):
    """Generator of frequency-domain argument tuples for ``sc.rx_chain_freq``:
    (tx_pre (B, 53), rx_pre, tx_blocks (B, 15, 53), rx_blocks, ow2 (B,)),
    CPU tensors, complex64 and float32.

    ``engine="native"``: the multithreaded C++ data engine
    (``datasets/native_engine.py``), frames seed-and-index deterministic;
    ``"torch"``: ``datasets/synthetic.py`` on a CPU ``torch.Generator``
    seeded with ``seed + i`` for batch i."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    for i in range(n_batches):
        if engine == "native":
            fb = native_engine.generate(batch, seed=seed, frame0=i * batch, snr_db=snr_db)
        else:
            fb = synthetic.generate(torch.Generator().manual_seed(seed + i), batch,
                                    snr_db=snr_db)
        yield fb.tx_preamble_fft, fb.rx_preamble_fft, fb.tx_symb, fb.rx_symb, fb.ow2


def native_time_batches(n_batches: int, batch: int, seed: int = 0, snr_db: float = 40.0,
                        threads: int = 0):
    """Generator of time-domain argument tuples for the batch-major fused
    chain (``kernels.fused_chain.fused_rx_chain``): (tx_pkt (B, 1200), rx_pkt,
    tx_lp (B, 160), rx_lp) float32 `Cplx` CPU planes, made by the native
    engine alone (no host-side Python math)."""
    for i in range(n_batches):
        _, tb = native_engine.generate(batch, seed=seed, frame0=i * batch, snr_db=snr_db,
                                       threads=threads, time_domain=True)
        yield tb.tx_pkt, tb.rx_pkt, tb.tx_lp, tb.rx_lp


# -- the device-resident stream ---------------------------------------------------------------


def kernel_seed(seed: int, i: int, state: torch.Tensor, rank: int = 0) -> torch.Tensor:
    """int32(seed + 65537·i) + state·(2654435761 mod 2³¹) + rank·97003,
    wrapped to int32 on ``state``'s device: the kernel generators' seed for
    batch ``i`` on dp rank ``rank`` (0 without a mesh)."""
    base = G.wrap_i32(seed + i * _BATCH_MIX)
    return G.wrap_i32(base + state.to(torch.int64) * _SEED_MIX
                      + rank * _RANK_MIX).to(torch.int32)


def next_state(checksum: torch.Tensor) -> torch.Tensor:
    """The carried state after a batch: int32(mod(|Σ checksum|·1e3, 65536)),
    in float32 on the device."""
    return _state_of(checksum.sum())


def _state_of(total: torch.Tensor) -> torch.Tensor:
    """`next_state` from the checksum's sum (a 0-d float32 tensor)."""
    return torch.remainder(total.abs() * 1e3, 65536.0).to(torch.int32)


def _stream_generator(seed: int, i: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed + i * _BATCH_MIX) % 2 ** 64)


def _raw_pack(out: dict, offsets: torch.Tensor) -> torch.Tensor:
    """A raw batch's counts and sums, (3,) float32: [detected streams,
    streams timed within [−4, −2], Σ evm_sums over the detected streams].
    Packs of several batches add up to the pack of their union."""
    det = out["detected"]
    err = out["start"] - offsets
    in_band = (err >= -4) & (err <= -2)
    return torch.stack([det.to(torch.float32).sum(), in_band.to(torch.float32).sum(),
                        torch.where(det, out["evm_sums"], 0.0).sum()])


def _raw_rates(packed: torch.Tensor, n: int, evm_den: float) -> dict:
    """Detection and timing rates of ``n`` streams from their `_raw_pack`,
    and the EVM over the detected streams (NaN when none is)."""
    return {
        "detect_rate": packed[0] / n,
        "timing_in_band_rate": packed[1] / n,
        "evm_rms": torch.sqrt(packed[2] / (packed[0] * evm_den)),
    }


def _raw_summary(out: dict, offsets: torch.Tensor, h: Cplx, evm_den: float) -> dict:
    """Detection and timing rates, the EVM over detected streams (NaN when
    none is detected), and the magnitude NMSE of h_mmse (invariant to the
    early-extraction phase ramp, which only rotates each bin)."""
    summary = _raw_rates(_raw_pack(out, offsets), out["detected"].numel(), evm_den)
    hm = out["h_mmse"]
    mag_e = torch.sqrt(hm.re * hm.re + hm.im * hm.im)
    mag_t = torch.sqrt(h.re * h.re + h.im * h.im)
    summary["h_mmse_mag_nmse"] = ((mag_e - mag_t) ** 2).sum() / (mag_t * mag_t).sum()
    return summary


def make_device_stream_step(batch: int, seed: int = 0, snr_db: float = 20.0, dtype=None,
                            sample: int = 128, sync: bool = False, gen: str = "kernel",
                            channel_model: str | None = None, mesh=None, device="cuda"):
    """Build the device-resident streamed step on ``device``.

    Returns ``(step, state0)``: ``step(i, state) -> (summary, sample_h,
    state)``.  ``summary`` maps names to 0-d device tensors: for ``kernel``
    and ``xla`` each estimator's CFR NMSE against the true channel
    (``h_lt_nmse`` …); for ``raw`` and ``kernel_raw`` ``detect_rate``,
    ``timing_in_band_rate``, ``evm_rms`` and ``h_mmse_mag_nmse``.
    ``sample_h``: the MMSE estimates of ``sample`` frames (the first of
    the batch; with ``kernel``, of the last 128 frames).  ``dtype`` (bf16 by
    default) is the sample storage and, with ``kernel``, eq's type.
    ``sync`` runs the chain's CFO/CPE stages (``xla`` only).

    ``mesh``: a ('dp', …) `parallel.make_mesh` mesh, to run the stream on
    every rank of its world (generators ``kernel`` and ``kernel_raw``):
    each dp rank draws and receives batch / dp frames with its own seed
    (`kernel_seed` with its rank), and one all-reduce over dp carries the
    summaries' sums and the checksum's, so every rank gets the same
    summary and the same next state.  ``kernel_raw``'s summary is then
    ``detect_rate``, ``timing_in_band_rate`` and ``evm_rms``, the EVM pooled
    over the detected streams of every rank.  ``sample_h`` holds this
    rank's own frames (no gather).  At dp = 1 the step equals the step
    without a mesh, bit for bit."""
    if gen not in GENERATORS:
        raise ValueError(f"gen must be one of {GENERATORS}, got {gen!r}")
    if mesh is not None and gen not in MESH_GENERATORS:
        raise ValueError(f"a mesh stream needs an in-kernel generator {MESH_GENERATORS}, "
                         f"got {gen!r}")
    dtype = torch.bfloat16 if dtype is None else dtype
    if batch % G.LANES or batch < G.LANES:
        raise ValueError(f"batch must be a positive multiple of {G.LANES}, got {batch}")
    dev = torch.device(device)
    cap = load_capture()

    def planes(x) -> Cplx:
        x = np.asarray(x)
        return Cplx(*(torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=dev)
                      for v in (x.real, x.imag)))

    txs, tpre = F.tx_spectra(planes(cap.tx_packet), planes(cap.tx_lptot))
    lts = evm_den = None
    if gen in ("raw", "kernel_raw"):
        lts = planes(lts_time_symbol(cap.tx_lptot).numpy())
        # EVM denominator Σ|tx|² over the blocks' bins: a problem constant
        evm_den = float((txs.re[:, :C.N_BLOCKS].double() ** 2
                         + txs.im[:, :C.N_BLOCKS].double() ** 2).sum())
    state0 = torch.zeros((), dtype=torch.int32, device=dev)
    if mesh is not None:
        return _mesh_step(mesh, batch, seed, snr_db, dtype, sample, gen, channel_model,
                          txs, tpre, lts, evm_den), state0

    def step(i: int, state: torch.Tensor):
        if gen == "kernel":
            out = G.fused_gen_chain(kernel_seed(seed, i, state), batch, txs, tpre, snr_db=snr_db,
                                    eq_dtype=dtype, channel_model=channel_model,
                                    stream_sums=True)
            s = out["sums"].sum(-1)
            summary = {name + "_nmse": s[k] / s[-1] for k, name in enumerate(_STREAM_ESTS)}
        elif gen == "kernel_raw":
            out = RG.gen_raw_system(kernel_seed(seed, i, state), batch, txs, tpre, lts,
                                    snr_db=snr_db, channel_model=channel_model)
            summary = _raw_summary(out, out["offsets"], out["h_true"], evm_den)
        elif gen == "raw":
            x, h, offs = synthetic_sc.generate_raw_lane_major(
                _stream_generator(seed, i, dev), batch, txs, tpre, snr_db=snr_db, dtype=dtype,
                channel_model=channel_model)
            out = R.raw_rx_txconst_fused(x, lts, txs, tpre, stream_sums=True)
            summary = _raw_summary(out, offs, h, evm_den)
        else:
            pkt, lp, h = synthetic_sc.generate_rx_lane_major(
                _stream_generator(seed, i, dev), batch, txs, tpre, snr_db=snr_db, dtype=dtype,
                channel_model=channel_model)
            out = F.fused_rx_chain_txconst(txs, tpre, pkt, lp, sync=sync)
            hp2 = (h.re * h.re + h.im * h.im).sum()
            summary = {name + "_nmse": ((out[name].re - h.re) ** 2
                                        + (out[name].im - h.im) ** 2).sum() / hp2
                       for name in _STREAM_ESTS}
        sample_h = out["h_mmse"].map(lambda t: t[:, :sample])
        return summary, sample_h, next_state(out["checksum"])

    return step, state0


def _mesh_step(mesh, batch: int, seed: int, snr_db: float, dtype, sample: int, gen: str,
               channel_model, txs: Cplx, tpre: Cplx, lts: Cplx | None, evm_den: float | None):
    """The mesh stream step of `make_device_stream_step` (the JAX package's
    ``_make_device_stream_step_mesh``): this rank's share of the batch, one
    all-reduce over dp."""
    dp, rank, group = M.axis(mesh, M.DP)
    local = batch // dp
    if local * dp != batch or local % G.LANES:
        raise ValueError(f"batch {batch} over dp {dp}: each rank needs a multiple of {G.LANES}")

    def step(i: int, state: torch.Tensor):
        kseed = kernel_seed(seed, i, state, rank)
        if gen == "kernel":
            out = G.fused_gen_chain(kseed, local, txs, tpre, snr_db=snr_db, eq_dtype=dtype,
                                    channel_model=channel_model, stream_sums=True)
            packed = M.all_reduce(torch.cat([out["sums"].sum(-1), out["checksum"].sum()[None]]),
                                  group)
            s = packed[:-1]
            summary = {name + "_nmse": s[k] / s[-1] for k, name in enumerate(_STREAM_ESTS)}
        else:
            out = RG.gen_raw_system(kseed, local, txs, tpre, lts, snr_db=snr_db,
                                    channel_model=channel_model)
            packed = M.all_reduce(torch.cat([_raw_pack(out, out["offsets"]),
                                             out["checksum"].sum()[None]]), group)
            summary = _raw_rates(packed[:-1], batch, evm_den)
        sample_h = out["h_mmse"].map(lambda t: t[:, :sample])
        return summary, sample_h, _state_of(packed[-1])

    return step


def run_stream_device(n_batches: int, batch: int, seed: int = 0, snr_db: float = 20.0,
                      out_dir: str | None = None, resume: bool = True, sample: int = 128,
                      gen: str = "kernel", channel_model: str | None = None,
                      device="cuda") -> dict:
    """Drive the device-resident stream for ``n_batches`` batches, writing
    each batch's summaries and sampled MMSE estimates to
    ``out_dir/stream_{i:06d}.npz``.

    Steps are dispatched ahead and read back one batch behind, so the
    readback overlaps the next batch's work.  Resume is bit-deterministic:
    the state after each batch is restored from ``cursor.json`` for the
    batches already done."""
    step, state = make_device_stream_step(batch, seed, snr_db, sample=sample, gen=gen,
                                          channel_model=channel_model, device=device)
    sink = _Sink(out_dir, resume)
    t0 = time.perf_counter()
    pending = None
    n_frames = 0
    for i in range(n_batches):
        if sink.done(i):
            saved = sink.state_after(i)
            if saved is not None:
                state = torch.tensor(saved, dtype=torch.int32, device=state.device)
            else:  # a cursor without states: advance by running the step again
                _, _, state = step(i, state)
            continue
        summary, sample_h, state = step(i, state)
        if pending is not None:
            n_frames += _finish_device(pending, sink, batch)
        pending = (i, summary, sample_h, state)
    if pending is not None:
        n_frames += _finish_device(pending, sink, batch)
    dt = time.perf_counter() - t0
    return {"frames": n_frames, "batches": n_batches, "wall_s": dt,
            "frames_per_s": n_frames / dt if dt > 0 else None, "out_dir": sink.path_str()}


def _finish_device(pending, sink: _Sink, batch: int) -> int:
    i, summary, sample_h, state_after = pending
    record = {k: v.cpu().numpy() for k, v in summary.items()}
    record["h_mmse_sample"] = sample_h.to_complex().T.cpu().numpy()   # (sample, 53)
    if sink.dir:
        np.savez_compressed(sink.dir / f"stream_{i:06d}.npz", **record)
        sink.cursor.add(i)
        sink.states[str(i)] = int(state_after)
        sink._write_cursor()
    return batch
