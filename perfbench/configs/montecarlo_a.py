"""montecarlo_a: the upstream's link-level Monte Carlo on one card.

The program's own device stream (``make_device_stream_step`` with the
in-kernel raw generator ``kernel_raw``): each step draws 32,768 streams on
the card (a fresh channel A, a CFO uniform in ±20 kHz, the frame at a drawn
offset, AWGN at the step's SNR), detects, synchronises, estimates and
equalises them in one kernel, and leaves per-step summaries and 128 sampled
h_mmse columns.  The reference draws the same streams from the seed word
each kept step used (`perfbench.reference.draws`), receives them with the
plain detection and chain, and forms the same summaries.  The program
(``tpu80211_torch``) is imported only inside `setup`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.configs import aligned_a40 as A
from perfbench.inputs import frames
from perfbench.reference import chain as ref
from perfbench.reference import detect as ref_det
from perfbench.reference import draws

# the storage of the frame's samples and the receiver's rows; float8 only
# for the reading of the reference one precision below the configuration's
DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
SERVED = ("detect_rate", "timing_in_band_rate", "evm_rms", "h_mmse_mag_nmse",
          "h_mmse_sample")   # what a step leaves the card with
REF_BLOCK = 8192                        # streams a reference block
_BATCH_MIX, _STATE_MIX = 65537, 2654435761 % 2**31

# operations a stream (an f32 or 32-bit integer operation counts 1, a complex
# multiply-add 8, a log, sqrt, sin or cos 1): a Philox call (10 rounds of 2
# mulhi, 2 mullo, 4 xor) per tap, for the offset and CFO, and per row; a
# normal pair (two uniforms, log, sqrt, 2π·u, sin, cos, two products) per tap
# and per row; the CFR; tx·H of 16 symbols and their IDFTs of 64 samples
# from 53 bins; the noise a row (2 products, 2 sums); the CFO's turn a row
# (angle, sin, cos, rotation); then detection, the chain with its sync and
# the EVM sums.  The chain's 16 DFTs count at the tensor cores' rate.
PHILOX_OPS = 80
PAIR_OPS = 12
CFO_OPS = 10
EVM_OPS = 15 * 53 * 4


def detect_ops(cfg: dict) -> int:
    """Detection's operations a stream: the lag-64 products and window sums
    over every sample (16 a sample), and the 64-tap matched filter over the
    fine window, 2·(search + stride) + 68 positions at 8 a tap."""
    d = cfg["detection"]
    fine = 2 * (d["search"] + d["decimate"]) + 68
    return 16 * cfg["deployment"]["stream_samples"] + fine * 64 * 8


def synth_ops(cfg: dict) -> int:
    d = cfg["deployment"]
    ns, taps = d["stream_samples"], d["channel_taps"]
    return ((taps + 1 + ns) * PHILOX_OPS + (taps + ns) * PAIR_OPS + 53 * taps * 8 + 16 * 53 * 6
            + 16 * 64 * 53 * 8 + ns * 4 + ns * CFO_OPS)


OUT_BYTES = (2 * 53 * 2 * 4          # h_wiener, h_mmse
             + 4 * 4 + 4 * 4         # evm_sums, ow2, cfo, checksum; four detection rows
             + 4 + 53 * 2 * 4 + 4)   # offsets, h_true, cfo_true


def work(cfg: dict, batch: int, serve: bool = False) -> dict:
    """The work of one step on ``batch`` streams, whatever implements it:
    its only inputs are a seed and constants, its outputs the per-stream
    rows the summaries reduce."""
    per = synth_ops(cfg) + detect_ops(cfg) + A.CHAIN_OPS + A.SYNC_OPS + EVM_OPS
    return {"ops": batch * per, "tc_ops": batch * A.DFT_OPS, "bytes": batch * OUT_BYTES}


def snr_of(cfg: dict, i: int) -> float:
    """Step ``i``'s SNR: the cycle's entry i mod its length."""
    snrs = cfg["deployment"]["snr_db"]
    return float(snrs[i % len(snrs)])


def seed_word(seed: int, i: int, state: int) -> int:
    """The 32-bit key word of step ``i``: the run's seed plus 65537·i plus
    the carried state (read back from the card) times 2654435761 mod 2³¹,
    wrapped to 32 bits."""
    return (seed + i * _BATCH_MIX + state * _STATE_MIX) & 0xFFFFFFFF


class State:
    """The program's set-up: its device stream, built for a run's seed."""

    def __init__(self, cfg: dict, device):
        from tpu80211_torch.pipeline import stream

        self.stream, self.cfg, self.device = stream, cfg, device

    def make(self, seed: int, batch: int, cfo_khz: float):
        d, e = self.cfg["deployment"], self.cfg["entry"]
        return self.stream.make_device_stream_step(
            batch, seed=seed, snr_db=d["snr_db"], sample=e["sample"], gen=e["gen"],
            channel_model=d["channel_model"], cfo_khz=cfo_khz,
            equalize_with=e["equalize_with"], device=self.device)


def setup(cfg: dict, device) -> State:
    return State(cfg, device)


def call(state: State, seed: int, batch: int):
    """The timed path: the program's device stream step and its first state,
    ``(step, state0)``; the loop drives ``step(i, state)``."""
    return state.make(seed, batch, state.cfg["deployment"]["cfo_khz"])


def control(state: State, seed: int, batch: int):
    """The control: the step without the CFO passed on, as the stream ran it
    before it took ``cfo_khz``: no CFO drawn, none corrected."""
    return state.make(seed, batch, 0.0)


class Reference:
    """The plain Monte Carlo step: the draws, the synthesis, detection, the
    chain and the summaries."""

    def __init__(self, cfg: dict, device):
        d = cfg["deployment"]
        self.cfg, self.device = cfg, torch.device(device)
        self.rms = d["rms_delay_spread_ns"] * 1e-9 * d["sample_rate_hz"]
        self.storage = DTYPES[cfg["storage"]]
        lp, pkt = frames.tx_frame()
        self.tx = ref.tx_spectra(ref.Consts(device, ref.wiener_prior(self.rms, 40.0)), lp, pkt)
        self.lts = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                         for v in (lp[-64:].real, lp[-64:].imag))
        (tr, ti), _ = self.tx
        self.evm_den = float((tr.double() ** 2 + ti.double() ** 2).sum())
        self.consts: dict[float, ref.Consts] = {}

    def block(self, word: int, snr: float, first: int, count: int) -> dict:
        """Streams first..first+count−1 of a step: the plain chain's outputs,
        the detection rows, the truth, and each stream's EVM sum."""
        d, det = self.cfg["deployment"], self.cfg["detection"]
        if snr not in self.consts:
            self.consts[snr] = ref.Consts(self.device, ref.wiener_prior(self.rms, snr))
        consts = self.consts[snr]
        dr = draws.Draws(word, first, count, d["channel_taps"], d["stream_samples"], self.device)
        (xr, xi), h, offs, _ = draws.synthesize(dr, *self.tx, self.rms, snr, d["cfo_khz"],
                                                self.storage)
        found = ref_det.detect(xr, xi, self.lts, det["threshold"], det["search"], det["advance"],
                               det["decimate"])
        pkt, lp = ref_det.extract(xr, xi, found["start"])
        pkt, lp = (tuple(t.to(self.storage) for t in p) for p in (pkt, lp))
        e = self.cfg["entry"]
        out = ref.chain(pkt, lp, self.tx, consts, True, e["equalize_with"])
        out.update(found, offsets=offs, h_true=h,
                   evm_sums=evm_sums(pkt, out, self.tx, consts, e["equalize_with"]))
        return out

    def step(self, word: int, snr: float, batch: int, sample: int) -> dict:
        """One step's summaries as counts and float64 sums, and the MMSE
        estimates of its first ``sample`` streams, (53, sample) complex."""
        acc = dict.fromkeys(("detected", "in_band", "evm", "mag_err", "mag_ref"), 0.0)
        h_sample = []
        for first in range(0, batch, REF_BLOCK):
            o = self.block(word, snr, first, min(REF_BLOCK, batch - first))
            det = o["detected"]
            err = o["start"] - o["offsets"]
            acc["detected"] += int(det.sum())
            acc["in_band"] += int(((err >= -4) & (err <= -2)).sum())
            acc["evm"] += float(o["evm_sums"].double()[det].sum())
            mag_e = torch.hypot(*(t.double() for t in o["h_mmse"]))
            mag_t = torch.hypot(*(t.double() for t in o["h_true"]))
            acc["mag_err"] += float(((mag_e - mag_t) ** 2).sum())
            acc["mag_ref"] += float((mag_t ** 2).sum())
            if first < sample:
                hr, hi = o["h_mmse"]
                h_sample.append(torch.complex(hr.double(), hi.double())[:, :sample - first])
        n_det = acc["detected"]
        return {"detected": n_det, "in_band": acc["in_band"],
                "evm_rms": math.sqrt(acc["evm"] / (n_det * self.evm_den)) if n_det else math.nan,
                "h_mmse_mag_nmse": acc["mag_err"] / acc["mag_ref"],
                "h_sample": torch.cat(h_sample, 1).cpu()}


def evm_sums(pkt, out: dict, tx, consts: ref.Consts, equalize_with: str) -> torch.Tensor:
    """Σ over the 15 blocks and 53 bins of |eq − tx|² a stream, with eq in
    float32 before its cast to the storage type, as the program sums it: the
    blocks as `reference.chain.chain` forms them (derotated by its CFO, the
    DFT on bfloat16 operands), divided by its blend, turned by their
    pilots' common phase."""
    f32 = torch.float32
    dev = pkt[0].device

    def ops(x):
        return x.to(f32).to(torch.bfloat16).to(f32)

    def plane(w):
        return torch.cat([ops(w).T, w.new_zeros(ref.N_FFT - ref.N_SC, ref.N_FFT)])

    wr, wi = plane(consts.wre), plane(consts.wim)
    br, bi = (x.view(ref.N_BLOCKS, ref.SAMP, -1)[:, ref.N_CP:].to(f32) for x in pkt)
    t = (ref.PREAMBLE + ref.N_CP
         + ref.SAMP * torch.arange(ref.N_BLOCKS, dtype=f32, device=dev)[:, None, None]
         + torch.arange(ref.N_FFT, dtype=f32, device=dev)[None, :, None])
    br, bi = ref._derotate(br, bi, out["cfo"], t)
    br, bi = ops(br), ops(bi)
    rbr, rbi = (wr @ br - wi @ bi)[:, :ref.N_SC], (wr @ bi + wi @ br)[:, :ref.N_SC]
    (txr, txi), _ = tx
    tbr, tbi = txr.T[:, :, None], txi.T[:, :, None]
    dc = (torch.arange(ref.N_SC, device=dev) == ref.DC)[:, None]
    (hlr, hli), (hpr, hpi) = out["h_lt"], out[equalize_with]
    w_ps = torch.tensor([(b + 1) / ref.N_BLOCKS for b in range(ref.N_BLOCKS)], dtype=f32,
                        device=dev)[:, None, None]
    w_lt = torch.tensor([(ref.N_BLOCKS - (b + 1)) / ref.N_BLOCKS for b in range(ref.N_BLOCKS)],
                        dtype=f32, device=dev)[:, None, None]
    hur = torch.where(dc, 1.0, w_lt * hlr + w_ps * hpr)
    hui = torch.where(dc, 0.0, w_lt * hli + w_ps * hpi)
    den = hur * hur + hui * hui
    er, ei = (rbr * hur + rbi * hui) / den, (rbi * hur - rbr * hui) / den
    er, ei = torch.where(dc, 0.0, er), torch.where(dc, 0.0, ei)
    gr = gi = 0.0
    for q in ref.PILOTS:
        zr, zi, xr, xi = er[:, q], ei[:, q], tbr[:, q], tbi[:, q]
        gr = gr + (zr * xr + zi * xi)
        gi = gi + (zi * xr - zr * xi)
    mag = torch.sqrt(gr * gr + gi * gi)
    mag = torch.where(mag == 0.0, 1.0, mag)
    rr, ri = (gr / mag)[:, None], (-gi / mag)[:, None]
    er, ei = er * rr - ei * ri, er * ri + ei * rr
    d_r, d_i = er - tbr, ei - tbi
    return (d_r * d_r + d_i * d_i).sum((0, 1))


class Numbers:
    """The numbers compared over the kept steps, each the worst step's:

    * ``detect_miss``, ``timing_miss``: the streams by which a step's count
      of detected streams, or of streams timed within [−4, −2] samples of
      their frame, differs from the reference's;
    * ``evm_rel``, ``nmse_rel``: the relative error of ``evm_rms`` and of
      ``h_mmse_mag_nmse`` (NaN on one side only: NaN);
    * ``h_rel``: over the sampled h_mmse columns of every kept step,
      max |h − h_ref| / max |h_ref|.
    """

    def __init__(self, batch: int):
        self.batch = batch
        self.out = {"detect_miss": 0.0, "timing_miss": 0.0, "evm_rel": 0.0, "nmse_rel": 0.0}
        self.h_err = self.h_ref = 0.0

    def _worst(self, key: str, v: float) -> None:
        if math.isnan(v) or math.isnan(self.out[key]):
            self.out[key] = math.nan
        else:
            self.out[key] = max(self.out[key], v)

    @staticmethod
    def _rel(got: float, want: float) -> float:
        if math.isnan(got) and math.isnan(want):
            return 0.0
        return abs(got - want) / abs(want)

    def add(self, got: dict, want: dict) -> None:
        """One step: ``got`` its record read back from the card (numpy
        values by name, ``h_mmse_sample`` (sample, 53)), ``want`` the
        reference's `Reference.step`."""
        n = self.batch
        self._worst("detect_miss", abs(round(float(got["detect_rate"]) * n) - want["detected"]))
        self._worst("timing_miss",
                    abs(round(float(got["timing_in_band_rate"]) * n) - want["in_band"]))
        self._worst("evm_rel", self._rel(float(got["evm_rms"]), want["evm_rms"]))
        self._worst("nmse_rel", self._rel(float(got["h_mmse_mag_nmse"]), want["h_mmse_mag_nmse"]))
        g = torch.from_numpy(np.asarray(got["h_mmse_sample"])).to(torch.complex128).T
        w = want["h_sample"]
        diff = (g - w).abs()
        self.h_err = math.nan if bool(torch.isnan(diff).any()) else max(self.h_err,
                                                                         float(diff.max()))
        self.h_ref = max(self.h_ref, float(w.abs().max()))

    def result(self) -> dict:
        h = self.h_err / self.h_ref if self.h_ref > 0 else math.nan
        return {**self.out, "h_rel": h}


def compare(numbers: Numbers, got: dict, want: dict) -> None:
    numbers.add(got, want)
