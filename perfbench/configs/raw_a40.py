"""raw_a40: the upstream deployment received as raw streams.

The entry the cells drive, the count of its work, and the reference it is
held to.  The program (``tpu80211_torch``) is imported only inside `setup`.
"""

from __future__ import annotations

import torch

from perfbench.configs import aligned_a40 as A
from perfbench.inputs import frames
from perfbench.reference import chain as ref
from perfbench.reference import detect as ref_det

DTYPES = A.DTYPES
SERVED = A.SERVED + ("detected", "start")


def detect_ops(cfg: dict) -> int:
    """Detection's operations a stream: the lag-64 products and window sums
    over every sample (16 a sample), and the 64-tap matched filter over the
    fine window, 2·(search + stride) + 68 positions at 8 a tap."""
    d, e = cfg["detection"], cfg["entry"]
    return 16 * cfg["deployment"]["stream_samples"] + (2 * (d["search"] + e["decimate"]) + 68) * 64 * 8


def work(cfg: dict, batch: int, serve: bool = False) -> dict:
    """The work of one call on ``batch`` streams: detection, then the chain;
    bytes: the streams in, the chain's outputs and four detection rows out."""
    elem = torch.empty((), dtype=DTYPES[cfg["storage"]]).element_size()
    ns = cfg["deployment"]["stream_samples"]
    return {"ops": batch * (detect_ops(cfg) + A.CHAIN_OPS + A.SYNC_OPS),
            "tc_ops": batch * A.DFT_OPS,
            "bytes": batch * (2 * ns * elem + A.out_bytes(serve) + 4 * 4)}


def make_batch(cfg: dict, gen: torch.Generator, batch: int) -> torch.Tensor:
    """One packed batch of raw streams (2·NS, B) on ``gen``'s device."""
    d = cfg["deployment"]
    x, _ = frames.raw_batch(d, gen, batch, DTYPES[cfg["storage"]], tuple(d["offset_range"]))
    return x


def split(x: torch.Tensor):
    ns = x.shape[0] // 2
    return x[:ns], x[ns:]


class State:
    """The program's set-up: its library loaded, its transmit spectra and the
    LTS it matches against, from the transmit frame."""

    def __init__(self, cfg: dict, device):
        from tpu80211_torch.cplx import Cplx
        from tpu80211_torch.kernels import fused_chain as F
        from tpu80211_torch.kernels import raw_chain as R

        self.F, self.R, self.Cplx = F, R, Cplx
        lp, pkt = frames.tx_frame()

        def planes(z):
            return Cplx(torch.tensor(z.real, dtype=torch.float32, device=device),
                        torch.tensor(z.imag, dtype=torch.float32, device=device))

        self.tx = F.tx_spectra(planes(pkt), planes(lp))
        self.lts = planes(lp[-64:])
        self.kw = dict(cfg["entry"])


def setup(cfg: dict, device) -> State:
    return State(cfg, device)


def call(state: State, x: torch.Tensor, serve: bool = False) -> dict:
    """The timed call: `raw_rx_txconst_fused` on one packed batch, at the
    program's default threshold, search and advance, eq written."""
    return state.R.raw_rx_txconst_fused(state.Cplx(*split(x)), state.lts, *state.tx,
                                        serve=serve, **state.kw)


def control(state: State, x: torch.Tensor, serve: bool = False) -> dict:
    """The control: the same call on the streams as int8 ADC words (the
    program's own `quantize_i8`, one step for the batch)."""
    q, lsb = state.F.quantize_i8(state.Cplx(*split(x)))
    return state.R.raw_rx_txconst_fused(q, state.lts, *state.tx, serve=serve, lsb=float(lsb),
                                        **state.kw)


class Reference(A.Reference):
    """Detection, extraction and the chain, plain."""

    def outputs(self, x: torch.Tensor) -> dict:
        xr, xi = split(x)
        lp, _ = frames.tx_frame()
        dev = x.device
        lts = (torch.tensor(lp[-64:].real, dtype=torch.float32, device=dev),
               torch.tensor(lp[-64:].imag, dtype=torch.float32, device=dev))
        d, e = self.cfg["detection"], self.cfg["entry"]
        det = ref_det.detect(xr, xi, lts, d["threshold"], d["search"], d["advance"],
                             e["decimate"])
        pkt, lpr = ref_det.extract(xr, xi, det["start"])
        out = ref.chain(pkt, lpr, self.tx, self.consts, e["sync"], e["equalize_with"])
        out.update(det)
        return out


def compare(numbers, got: dict, want: dict, serve: bool) -> None:
    """Detection first; the chain's numbers on the streams where it agrees."""
    keep = numbers.add_detection(got, want).to(want["ow2"].device)
    numbers.add(got, want, A.planes(serve), keep)
