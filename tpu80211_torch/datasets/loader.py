"""Load the frozen parity capture as a typed record.

The capture lives once in the repository, in the JAX package's data
directory; this loader reads it there by path (``tpu80211`` itself is
never imported).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from tpu80211_torch import constants as C

_DATA = (pathlib.Path(__file__).resolve().parents[2]
         / "tpu80211" / "datasets" / "data" / "wifi_capture.npz")


@dataclasses.dataclass(frozen=True)
class Capture:
    """The shipped 802.11 capture (SNR 40 dB, channel 'A', FO 20 kHz —
    WiFi_RX.m:4-9) in both domains, as complex128 numpy arrays."""

    tx_preamble_fft: np.ndarray  # (53,)
    rx_preamble_fft: np.ndarray  # (53,)
    tx_symb: np.ndarray          # (15, 53)
    rx_symb: np.ndarray          # (15, 53)
    ow2: float                   # measured noise power (inputs.h:18)
    tx_packet: np.ndarray        # (1200,) time-domain
    rx_packet: np.ndarray        # (1200,)
    tx_lptot: np.ndarray         # (160,) long preamble
    rx_lptot: np.ndarray         # (160,)


def load_capture(path: str | pathlib.Path = _DATA) -> Capture:
    with np.load(path) as d:
        return Capture(
            tx_preamble_fft=d["tx_preamble_fft"],
            rx_preamble_fft=d["rx_preamble_fft"],
            tx_symb=d["tx_symb"].reshape(C.N_BLOCKS, C.N_SC),
            rx_symb=d["rx_symb"].reshape(C.N_BLOCKS, C.N_SC),
            ow2=float(d["ow2"]),
            tx_packet=d["tx_packet"],
            rx_packet=d["rx_packet"],
            tx_lptot=d["tx_lptot"],
            rx_lptot=d["rx_lptot"],
        )
