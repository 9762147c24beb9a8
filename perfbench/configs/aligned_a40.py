"""aligned_a40: the upstream receiver on aligned frames of its deployment.

The entry the cells drive, the count of its work, and the reference it is
held to.  The program (``tpu80211_torch``) is imported only inside `setup`,
so the rest of this file can be read and tested without it.
"""

from __future__ import annotations

import torch

from perfbench.inputs import frames
from perfbench.reference import chain as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SERVED = ("h_wiener", "h_mmse", "eq", "ow2", "cfo")

# operations a frame, from the shapes (an f32 operation counts 1, a complex
# multiply-add 8, a sin or cos 1): the 16 DFTs of 53 bins from 64 samples,
# bf16 operands on the tensor cores; the rest of the chain (equalizer
# 15·53·19, five interpolators 53·4·24, MMSE 4·53·17 + 53·32, LT-LS); the
# sync branch: Moose's 64 products, the derotation of the preamble and of
# 15 blocks of 64 samples (angle, sin, cos, rotation: 10 a sample), the CPE
# of 15 blocks (4 pilot products, 53 rotations)
DFT_OPS = 16 * 53 * 64 * 8
CHAIN_OPS = 29_000
SYNC_OPS = 64 * 8 + (160 + 15 * 64) * 10 + 15 * (4 * 8 + 53 * 6)


def in_bytes(cfg: dict) -> int:
    """Input bytes a frame: the packet and the preamble, two planes each."""
    return frames.PACKED_ROWS * torch.empty((), dtype=DTYPES[cfg["storage"]]).element_size()


def out_bytes(serve: bool) -> int:
    """Output bytes a frame: the h planes (two with ``serve``, else seven),
    eq (15·53, bf16), σ², cfo and the checksum (float32)."""
    return (2 if serve else 7) * 53 * 2 * 4 + 15 * 53 * 2 * 2 + 3 * 4


def work(cfg: dict, batch: int, serve: bool = False) -> dict:
    """The work of one call on ``batch`` frames, whatever implements it."""
    return {"ops": batch * (CHAIN_OPS + SYNC_OPS), "tc_ops": batch * DFT_OPS,
            "bytes": batch * (in_bytes(cfg) + out_bytes(serve))}


def make_batch(cfg: dict, gen: torch.Generator, batch: int) -> torch.Tensor:
    """One packed input batch (2720, B) on ``gen``'s device."""
    return frames.aligned_batch(cfg["deployment"], gen, batch, DTYPES[cfg["storage"]])


def split(x: torch.Tensor):
    """(packet (re, im), preamble (re, im)): contiguous row views of a
    packed batch."""
    p, q = frames.PACKET, frames.PREAMBLE
    return (x[:p], x[p:2 * p]), (x[2 * p:2 * p + q], x[2 * p + q:])


class State:
    """The program's set-up: its library loaded, its transmit spectra
    derived by its own `tx_spectra`."""

    def __init__(self, cfg: dict, device):
        from tpu80211_torch.cplx import Cplx
        from tpu80211_torch.kernels import fused_chain as F

        self.F, self.Cplx = F, Cplx
        lp, pkt = frames.tx_frame()

        def planes(z):
            return Cplx(torch.tensor(z.real, dtype=torch.float32, device=device),
                        torch.tensor(z.imag, dtype=torch.float32, device=device))

        self.tx = F.tx_spectra(planes(pkt), planes(lp))
        self.kw = dict(cfg["entry"])


def setup(cfg: dict, device) -> State:
    return State(cfg, device)


def call(state: State, x: torch.Tensor, serve: bool = False) -> dict:
    """The timed call: `fused_rx_chain_txconst` on one packed batch."""
    (pr, pi), (lr, li) = split(x)
    C = state.Cplx
    return state.F.fused_rx_chain_txconst(*state.tx, C(pr, pi), C(lr, li), serve=serve,
                                          **state.kw)


def control(state: State, x: torch.Tensor, serve: bool = False) -> dict:
    """The control: the same call on the samples as int8 ADC words (the
    program's own `quantize_i8`, one step for the batch), the precision below
    bfloat16."""
    (pr, pi), (lr, li) = split(x)
    F, C = state.F, state.Cplx
    qp, lsb = F.quantize_i8(C(pr, pi))
    ql, _ = F.quantize_i8(C(lr, li), lsb)
    return F.fused_rx_chain_txconst(*state.tx, qp, ql, serve=serve, lsb=float(lsb), **state.kw)


class Reference:
    """The plain reference's constants for this configuration."""

    def __init__(self, cfg: dict, device):
        d = cfg["deployment"]
        rms = d["rms_delay_spread_ns"] * 1e-9 * d["sample_rate_hz"]
        self.consts = ref.Consts(device, ref.wiener_prior(rms, cfg["entry"]["wiener_snr_db"]))
        self.tx = ref.tx_spectra(self.consts, *frames.tx_frame())
        self.cfg = cfg

    def outputs(self, x: torch.Tensor) -> dict:
        pkt, lp = split(x)
        e = self.cfg["entry"]
        return ref.chain(pkt, lp, self.tx, self.consts, e["sync"], e["equalize_with"])


def planes(serve: bool) -> tuple[str, ...]:
    """The h planes a call returns."""
    return ("h_wiener", "h_mmse") if serve else ref.H_NAMES


def compare(numbers, got: dict, want: dict, serve: bool) -> None:
    """Adds one block to the numbers (`perfbench.reference.compare`)."""
    numbers.add(got, want, planes(serve))
