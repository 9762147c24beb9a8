"""Carry the JAX chain's constants across to the port.

The JAX fused chain builds its constants as arrays: the block DFT and the
interpolator stack (``tpu80211/kernels/fused_chain.py::_const_specs``)
and the tx-constant spectra (``tx_spectra``).  Given as numpy arrays,
these functions turn them into the port's tensors on a device, so a caller
can feed both packages the very same constants.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu80211_torch.cplx import Cplx
from tpu80211_torch.kernels.fused_chain import ChainConsts, TxConst


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), dtype=torch.float32, device=device)


def chain_consts(wre, wim, win_re, win_im,
                 device: torch.device | str = "cpu") -> ChainConsts:
    """``_const_specs``' (64, 53) block DFT re/im and (5, 53, 4)
    interpolator stack re/im → `ChainConsts` on ``device``."""
    return ChainConsts(*(_f32(a, device) for a in (wre, wim, win_re, win_im)))


def tx_spectra(txs_re, txs_im, tpre_re, tpre_im,
               device: torch.device | str = "cpu") -> TxConst:
    """``tx_spectra``' (53, 16) block spectra and (53, 1) preamble spectrum
    → `TxConst` on ``device``."""
    return TxConst(Cplx(_f32(txs_re, device), _f32(txs_im, device)),
                   Cplx(_f32(tpre_re, device), _f32(tpre_im, device)))
