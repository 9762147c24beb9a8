"""The one-kernel raw-stream receiver: raw streams in, estimates out.

The counterpart of ``tpu80211/kernels/raw_chain.py``.  One hand-written
CUDA kernel (``csrc/raw_chain.cu``) runs, per block of 32 streams, the
detection of ``detect_kernel`` and then the tx-constant chain of
``fused_chain``, reading each stream's preamble and packet straight from
the raw (NS, B) buffer at its detected start: no aligned copy goes through
device memory.  ``raw_chain_plain`` is the same function in plain PyTorch
(plain detection, ``extract_lane_major``, ``fused_chain_plain``); the
wrapper runs it for CPU tensors only, and a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels import _ffi
from tpu80211_torch.kernels import detect_kernel as D
from tpu80211_torch.kernels import fused_chain as F
from tpu80211_torch.kernels._ffi import DOUBLE, FLOAT, INT, INT_PTR, PTR, STORAGE
from tpu80211_torch.utils import spans

_count_call = spans.counter("call.raw_rx_txconst_fused")
_count_launch = spans.counter("launch.raw_chain")
LIB = _ffi.Library("raw_chain", {
    "raw_chain_launch": (PTR, INT, INT, INT, INT, INT, FLOAT, FLOAT, INT, INT, DOUBLE, INT, INT,
                         INT, INT, PTR),
    "raw_chain_attributes": (INT, INT, INT, INT, INT, INT, INT_PTR),
})


def raw_chain_plain(x: Cplx, lts_ref: Cplx, txs: Cplx, tpre: Cplx,
                    threshold: float | None = None, search: int = 192, advance: int = 4,
                    eps=0.0, sync: bool = False, serve: bool = False,
                    wiener_model: str | None = None, wiener_snr_db: float | None = None,
                    lsb=1.0, stream_sums: bool = False, equalize_with: str = "h_linear",
                    decimate=True) -> dict:
    """`raw_rx_txconst_fused` in plain PyTorch, on any device: the plain
    detection, the frame rows cut at each start, then the plain chain with
    the EVM sums taken from eq in float32 (``stream_sums``)."""
    thr = D.DEFAULT_THRESHOLD if threshold is None else threshold
    F.check_equalize_with(equalize_with)
    F.check_tx_spectra(txs, tpre, x.re.device)
    det = D.detect_plain(x, lts_ref, thr, search, advance, decimate)
    lp, pkt = D.extract_lane_major(x, torch.where(det.detected, det.start, 0))
    consts = F.chain_consts(x.re.device, wiener_model, wiener_snr_db)
    out = F.fused_chain_plain(pkt, lp, F.TxConst(txs, tpre), consts, eps=eps, lsb=lsb,
                              serve=serve, equalize_with=equalize_with, sync=sync,
                              evm_sums=stream_sums)
    if stream_sums:
        out["eq"] = None
    out.update(detected=det.detected, coarse=det.coarse, start=det.start, metric=det.metric)
    return out


def raw_rx_txconst_fused(x: Cplx, lts_ref: Cplx, txs: Cplx, tpre: Cplx,
                         threshold: float | None = None, search: int = 192, advance: int = 4,
                         eps=0.0, sync: bool = False, serve: bool = False,
                         wiener_model: str | None = None, wiener_snr_db: float | None = None,
                         lsb=1.0, stream_sums: bool = False, equalize_with: str = "h_linear",
                         decimate=True) -> dict:
    """The raw receiver: lane-major (NS, B) streams (float32, bfloat16, or
    int8 ADC words with ``lsb`` their step) → `fused_chain`'s output dict
    plus ``detected``/``coarse``/``start``/``metric`` rows.  ``lts_ref``: the (64,)
    float32 LTS; ``txs``/``tpre``: the tx-constant spectra.

    ``stream_sums=True`` is the streaming configuration: ``evm_sums`` (B,)
    holds each stream's Σ|eq − tx|² and ``eq`` is None (never written).
    ``decimate`` sets the Schmidl & Cox stride (True → 16; 32, 64; False =
    full resolution); ``serve`` drops the diagnostic planes.  The CUDA
    kernel for CUDA tensors, ``raw_chain_plain`` for CPU tensors."""
    kw = dict(threshold=threshold, search=search, advance=advance, eps=eps, sync=sync,
              serve=serve, wiener_model=wiener_model, wiener_snr_db=wiener_snr_db, lsb=lsb,
              stream_sums=stream_sums, equalize_with=equalize_with, decimate=decimate)
    _count_call()
    with spans.span("entry.raw_rx_txconst_fused"):
        if x.re.device.type == "cpu":
            return raw_chain_plain(x, lts_ref, txs, tpre, **kw)
        return _launch(x, lts_ref, txs, tpre, **kw)


def kernel_attributes(dtype: torch.dtype = torch.bfloat16, sync: bool = False,
                      stream_sums: bool = True, search: int = 192, decimate=True,
                      lib=None) -> dict:
    """`_ffi.attributes` of the kernel that `raw_rx_txconst_fused` launches
    for streams of ``dtype`` with these options (32 streams a block).
    ``lib``: a card probe's build (`Library.at`)."""
    stride, decimated = D.stride_of(decimate)
    return _ffi.attributes((lib or LIB).raw_chain_attributes, STORAGE[dtype], sync,
                           stream_sums, search, stride, decimated)


def _launch(x: Cplx, lts_ref: Cplx, txs: Cplx, tpre: Cplx, threshold, search, advance, eps,
            sync, serve, wiener_model, wiener_snr_db, lsb, stream_sums, equalize_with,
            decimate, lib=None) -> dict:
    """One launch; ``lib``: a card probe's build of the source (`Library.at`)."""
    thr = D.DEFAULT_THRESHOLD if threshold is None else threshold
    spans.phase("check")
    D.check_streams(x, lts_ref, search)
    F.check_equalize_with(equalize_with)
    F.check_tx_spectra(txs, tpre, x.re.device)
    spans.phase()
    stride, decimated = D.stride_of(decimate)
    ns, b = x.re.shape
    dev = x.re.device
    storage = x.re.dtype
    eq_dtype = torch.bfloat16 if storage == torch.int8 else storage
    consts = F.chain_consts(dev, wiener_model, wiener_snr_db)
    spans.phase("outputs")
    out, outs = F.chain_outputs(b, dev, eq_dtype, serve, not stream_sums, stream_sums)
    rows = D.detection_rows(b, dev)
    spans.phase("launch")
    _ffi.launch((lib or LIB).raw_chain_launch, [*x, *lts_ref, *txs, *tpre, *consts, *outs, *rows],
                STORAGE[storage], F.EQUALIZE_WITH.index(equalize_with), b, ns, float(eps),
                float(lsb), sync, stream_sums, float(thr), int(search), int(advance), stride,
                decimated, counter=_count_launch)
    spans.phase()
    det, coarse, start, metric = rows
    _ffi.count_torch()   # det != 0: one elementwise kernel
    out.update(detected=det != 0, coarse=coarse, start=start, metric=metric)
    return out
