"""Numeric guards: NaN and Inf surface as errors, not as corrupt estimates.

The counterpart of ``tpu80211/utils/checks.py``.  The JAX package wraps a
pipeline function with ``jax.experimental.checkify``; PyTorch runs
eagerly, so `checked` checks the outputs once the call returns.  Both
read the values on the host: they are debug and test gates, not part of
a timed step.
"""

from __future__ import annotations

import functools

import torch

from tpu80211_torch.cplx import Cplx


def _leaves(tree):
    """The tensors of a tensor, a `Cplx`, or dicts, named tuples, tuples and
    lists of them (None skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Cplx):
        yield from tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def assert_finite(tree, name: str = "output") -> None:
    """Raise FloatingPointError if any tensor of ``tree`` (tensors, `Cplx`
    planes, dicts, named tuples and lists of them) holds a NaN or an Inf."""
    for t in _leaves(tree):
        if not (t.is_floating_point() or t.is_complex()):
            continue
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            raise FloatingPointError(f"{name}: {bad}/{t.numel()} non-finite values "
                                     f"(shape {tuple(t.shape)}, dtype {t.dtype})")


def checked(fn):
    """``fn`` wrapped so that a non-finite value in its outputs raises
    FloatingPointError after the call: ``out = checked(sc.rx_chain)(...)``."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        assert_finite(out, getattr(fn, "__name__", "output"))
        return out

    return wrapper
