"""Split complex planes for the kernel boundary.

bf16 and int8 sample storage have no torch complex dtype, so the fused
kernel takes and returns complex data as two real planes.  Everything
away from that boundary computes in ``torch.complex64``/``complex128``.
`tree_map` maps a function over the tensors of planes and tuples of them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Cplx(NamedTuple):
    """Two real tensors of one shape and dtype: real and imaginary part."""

    re: torch.Tensor
    im: torch.Tensor

    @staticmethod
    def from_complex(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> "Cplx":
        return Cplx(x.real.to(dtype), x.imag.to(dtype))

    def to_complex(self, dtype: torch.dtype = torch.complex64) -> torch.Tensor:
        real = torch.float64 if dtype == torch.complex128 else torch.float32
        return torch.complex(self.re.to(real), self.im.to(real)).to(dtype)

    def map(self, fn) -> "Cplx":
        """Apply ``fn`` to both planes."""
        return Cplx(fn(self.re), fn(self.im))


def tree_map(fn, x):
    """``fn`` on every tensor of a tensor, a `Cplx`, or (named) tuples and
    lists of them (numpy arrays become tensors first; other leaves stay)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x
