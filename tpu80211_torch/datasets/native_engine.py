"""ctypes bindings to the native C++ data engine (``native/dataengine.cpp``).

The counterpart of ``tpu80211/datasets/native_engine.py``, over the same
library: ``native/build/libdataengine.so``, built with ``make -C native``
at first use.  The engine writes batches of synthetic frames straight into
float32 split planes with ``std::thread`` parallelism; it is the host-side
producer of ``pipeline/stream.py``'s ``run_stream``.

Deterministic in (seed, frame0 + i) whatever the thread count, so a
resumed stream draws the same frames, and this wrapper's arrays are bit
for bit those of the JAX package's wrapper.  The distributions are those
of ``datasets/synthetic.py`` but the generator differs, so the two
engines' frames agree in statistics only.  Results are CPU tensors; the
caller moves them (``run_stream`` pins them and uploads without blocking).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import pathlib
import subprocess
from typing import NamedTuple

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.synthetic import FrameBatch, _lts_spectrum

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_SO = _NATIVE_DIR / "build" / "libdataengine.so"

_F = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    if not _SO.exists():
        # one build at a time: test workers may ask at once
        _SO.parent.mkdir(parents=True, exist_ok=True)
        with open(_SO.parent / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _SO.exists():
                subprocess.run(["make", "-C", str(_NATIVE_DIR), "build/libdataengine.so"],
                               check=True, capture_output=True)
    lib = ctypes.CDLL(str(_SO))
    lib.gen_frames_f32.argtypes = (
        [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
         ctypes.c_double, ctypes.c_double, ctypes.c_int]
        + [_F] * 20)
    lib.gen_frames_f32.restype = None
    return lib


class TimeBatch(NamedTuple):
    """Time-domain view of a generated batch: float32 split planes, batch
    first."""

    tx_pkt: Cplx   # (B, 1200)
    rx_pkt: Cplx   # (B, 1200)
    tx_lp: Cplx    # (B, 160)
    rx_lp: Cplx    # (B, 160)


def _f32(*shape) -> np.ndarray:
    return np.empty(shape, np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


def generate(batch: int, seed: int = 0, frame0: int = 0, snr_db: float = 40.0,
             fo_hz: float = 0.0, sample_rate_hz: float = 20e6, threads: int = 0,
             time_domain: bool = False):
    """Generate ``batch`` frames starting at global frame index ``frame0``.

    Returns a `FrameBatch` of CPU tensors (complex64, ow2 float32), as
    ``synthetic.generate`` does, or ``(FrameBatch, TimeBatch)`` with
    ``time_domain=True``: the TimeBatch planes feed the fused chain with no
    further host-side math.  ``threads=0`` uses every core."""
    b = int(batch)
    lts = np.ascontiguousarray(_lts_spectrum().astype(np.float32))
    tpre = (_f32(b, C.N_SC), _f32(b, C.N_SC))
    rpre = (_f32(b, C.N_SC), _f32(b, C.N_SC))
    tx = (_f32(b, C.N_BLOCKS, C.N_SC), _f32(b, C.N_BLOCKS, C.N_SC))
    rx = (_f32(b, C.N_BLOCKS, C.N_SC), _f32(b, C.N_BLOCKS, C.N_SC))
    ow2 = _f32(b)
    h = (_f32(b, C.N_SC), _f32(b, C.N_SC))
    if time_domain:
        planes = [(_f32(b, n), _f32(b, n)) for n in (C.PACKET_SAMPLES, C.PACKET_SAMPLES,
                                                      C.PREAMBLE_SAMPLES, C.PREAMBLE_SAMPLES)]
        tptrs = [_ptr(x) for pair in planes for x in pair]
    else:
        tptrs = [ctypes.cast(None, _F)] * 8

    cfo_rad = 2.0 * np.pi * fo_hz * C.SAMP_PER_BLOCK / sample_rate_hz
    _lib().gen_frames_f32(
        int(seed), int(frame0), b, float(snr_db), float(cfo_rad), int(threads), _ptr(lts),
        _ptr(tpre[0]), _ptr(tpre[1]), _ptr(rpre[0]), _ptr(rpre[1]),
        _ptr(tx[0]), _ptr(tx[1]), _ptr(rx[0]), _ptr(rx[1]),
        _ptr(ow2), _ptr(h[0]), _ptr(h[1]), *tptrs)

    def cx(pair) -> torch.Tensor:
        return torch.from_numpy((pair[0] + 1j * pair[1]).astype(np.complex64))

    fb = FrameBatch(cx(tpre), cx(rpre), cx(tx), cx(rx), torch.from_numpy(ow2), cx(h))
    if not time_domain:
        return fb
    return fb, TimeBatch(*(Cplx(torch.from_numpy(re), torch.from_numpy(im))
                           for re, im in planes))


def available() -> bool:
    """True if the native library builds and loads on this machine."""
    try:
        _lib()
        return True
    except (subprocess.CalledProcessError, OSError):
        return False
