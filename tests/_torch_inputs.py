"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Frames are made with numpy from a seed and handed to both packages, so the
JAX reference and the PyTorch port see the very same samples.  Samples are
rounded to float32 here, so a later cast to bf16 rounds once, the same way
in both frameworks.  JAX is imported only by `jax_planes`, so the card-only
tests (which run where JAX is not installed) can use the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu80211_torch import constants as C
from tpu80211_torch.cplx import Cplx
from tpu80211_torch.datasets.loader import load_capture
from tpu80211_torch.kernels.fused_chain import OUT_NAMES

# f32: tests/test_fused_chain.py:53-61 (h_mmse carries 1/σ² magnitudes).
# bf16/int8: both sides round the DFT operands to bf16 at the same points
# and multiply exactly in f32, so the h planes agree to f32 summation order
# (1e-4 leaves room); eq is stored in bf16, where a summation-order
# difference can flip one rounding: one bf16 ulp is 2⁻⁸ ≈ 4e-3 relative.
TOL = {
    "f32": {"h": 1e-5, "h_mmse": 1e-3, "eq": 1e-4},
    "bf16": {"h": 1e-4, "h_mmse": 1e-3, "eq": 1e-2},
    "int8": {"h": 1e-4, "h_mmse": 1e-3, "eq": 1e-2},
}

_K = np.arange(C.N_SC) - C.FFT_SHIFT  # bin k sits at FFT index (k − 26) mod 64


def _to_time(x: np.ndarray) -> np.ndarray:
    """(…, 53) spectrum → (…, 64) samples whose block DFT is x."""
    full = np.zeros(x.shape[:-1] + (C.N_FFT,), np.complex128)
    full[..., _K % C.N_FFT] = x
    return np.fft.ifft(full, axis=-1)


def _with_cp(t: np.ndarray) -> np.ndarray:
    return np.concatenate([t[..., -C.N_CP:], t], axis=-1)


def make_frames(seed: int, b: int, snr_db: float = 40.0, tx_const: bool = False):
    """b frames, batch-major complex arrays: tx packet (b, 1200), rx packet,
    tx long preamble (b, 160), rx long preamble.  QPSK data, the capture's
    LTS, an 8-tap exponential channel per frame and AWGN at ``snr_db``;
    ``tx_const`` gives every frame the same transmit packet."""
    rng = np.random.default_rng(seed)
    lts = load_capture().tx_preamble_fft
    amp = np.abs(lts).max() / np.sqrt(2)  # data bins as strong as the LTS bins
    nsym = 1 if tx_const else b
    sym = amp * (rng.choice([-1.0, 1.0], (nsym, C.N_BLOCKS, C.N_SC))
                 + 1j * rng.choice([-1.0, 1.0], (nsym, C.N_BLOCKS, C.N_SC)))
    sym[..., C.DC_IDX] = 0
    sym = np.broadcast_to(sym, (b, C.N_BLOCKS, C.N_SC))
    p = np.exp(-np.arange(8) / 2.0)
    taps = np.sqrt(p / p.sum() / 2) * (rng.standard_normal((b, 8)) + 1j * rng.standard_normal((b, 8)))
    h = taps @ np.exp(-2j * np.pi * np.outer(np.arange(8), _K) / C.N_FFT)  # (b, 53)

    def packet(s):  # (b, 15, 53) → (b, 1200)
        return _with_cp(_to_time(s)).reshape(b, C.PACKET_SAMPLES)

    def preamble(spec):  # (b, 53) → (b, 160): [last 32 | LTS | LTS]
        t = _to_time(spec)
        return np.concatenate([t[:, -32:], t, t], axis=-1)

    tx_pkt, tx_lp = packet(sym), preamble(np.broadcast_to(lts, (b, C.N_SC)))
    rx_pkt, rx_lp = packet(sym * h[:, None, :]), preamble(lts * h)
    sigma = np.sqrt(np.mean(np.abs(rx_pkt) ** 2) / 10 ** (snr_db / 10) / 2)
    rx_pkt = rx_pkt + sigma * (rng.standard_normal(rx_pkt.shape) + 1j * rng.standard_normal(rx_pkt.shape))
    rx_lp = rx_lp + sigma * (rng.standard_normal(rx_lp.shape) + 1j * rng.standard_normal(rx_lp.shape))
    return tuple(x.astype(np.complex64) for x in (tx_pkt, rx_pkt, tx_lp, rx_lp))


def jax_planes(x: np.ndarray, dtype=None):
    """x as tpu80211 split planes, float32 unless ``dtype`` says otherwise."""
    import jax.numpy as jnp

    from tpu80211.cplx import Cplx as JCplx

    dtype = jnp.float32 if dtype is None else dtype
    return JCplx(jnp.asarray(np.ascontiguousarray(x.real), jnp.float32).astype(dtype),
                 jnp.asarray(np.ascontiguousarray(x.imag), jnp.float32).astype(dtype))


def torch_planes(x: np.ndarray, dtype=torch.float32) -> Cplx:
    return Cplx(torch.tensor(np.ascontiguousarray(x.real), dtype=torch.float32).to(dtype),
                torch.tensor(np.ascontiguousarray(x.imag), dtype=torch.float32).to(dtype))


def lane_major(x: np.ndarray, pad_to: int = 1) -> np.ndarray:
    """(b, n) batch-major → (n, b') lane-major, zero-padded to a multiple
    of ``pad_to`` frames (the JAX kernel's 128-lane tiles)."""
    b = x.shape[0]
    bpad = -(-b // pad_to) * pad_to
    return np.ascontiguousarray(np.pad(x, ((0, bpad - b), (0, 0))).T)


def to_np(v) -> np.ndarray:
    """A port or JAX output (Cplx of either, tensor or array) as complex128
    or float64 numpy."""
    if hasattr(v, "re") and hasattr(v, "im"):  # split planes of either package
        return to_np(v.re) + 1j * to_np(v.im)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.complex128 if v.is_complex() else torch.float64).numpy()
    return np.asarray(v, np.float64)


def rel(got, want) -> float:
    """max |got − want| / max |want| (the JAX tests' _rel)."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_matches(got: dict, want: dict, b: int, tol: dict, batch_major: bool = False):
    """Every output of a fused-chain dict against another, over the first b
    frames; ``tol`` is one entry of TOL."""
    for name in (*OUT_NAMES, "eq"):
        if want[name] is None:
            assert got[name] is None, name
            continue
        g, w = to_np(got[name]), to_np(want[name])
        if not batch_major:
            g, w = g[..., :b], w[..., :b]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        lim = tol["eq"] if name == "eq" else tol.get(name, tol["h"])
        assert rel(g, w) < lim, (name, rel(g, w))
    # σ² is a sum of squares: elementwise rtol 1e-4 covers f32 order
    np.testing.assert_allclose(to_np(got["ow2"])[:b], to_np(want["ow2"])[:b], rtol=1e-4)
    # the checksum sums ~2,000 signed terms: 1e-4 of the largest one
    assert rel(to_np(got["checksum"])[:b], to_np(want["checksum"])[:b]) < 1e-4
    np.testing.assert_array_equal(to_np(got["cfo"])[:b], 0.0)
