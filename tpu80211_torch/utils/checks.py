"""Numeric guards: NaN and Inf surface as errors, not as corrupt estimates.

The counterpart of ``tpu80211/utils/checks.py``.  The JAX package wraps a
pipeline function with ``jax.experimental.checkify``, whose float checks
flag a NaN made by any primitive, even one a later ``where`` drops.
`checked` does the same under a ``TorchFunctionMode``: each torch call
runs, and a float result holding a NaN that none of its inputs held
raises, naming the call; the outputs are then checked for NaN and Inf.
Both read values on the host after every call: they are debug and test
gates, never part of a timed step.
"""

from __future__ import annotations

import functools

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from tpu80211_torch.cplx import Cplx

FLOAT_CHECKS = frozenset({"nan"})   # what `checked` looks for in every call


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


def _has_nan(tensors) -> bool:
    return any(bool(torch.isnan(t).any()) for t in tensors
               if t.is_floating_point() or t.is_complex())


class _NanOrigin(TorchFunctionMode):
    """Raises FloatingPointError at the first torch call whose float result
    holds a NaN that none of its tensor inputs held, naming the checked
    function ``name`` and the call.  (A mode's handler runs with the mode
    off, so the checks here are not checked again.)"""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and _has_nan(outs):
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            if not _has_nan(ins):
                raise FloatingPointError(
                    f"{self.name}: nan generated by {getattr(func, '__name__', func)}")
        return out


def checked(fn, errors=None):
    """``fn`` wrapped so that a NaN made by any torch call inside it raises
    FloatingPointError naming the call, and a NaN or Inf in its outputs
    raises after it returns: ``out = checked(sc.rx_chain)(...)``.

    ``errors``: what every call is checked for, a subset of `FLOAT_CHECKS`
    (the default, as checkify's ``float_checks`` is the JAX wrapper's); an
    empty set checks the outputs only."""
    errors = FLOAT_CHECKS if errors is None else frozenset(errors)
    if not errors <= FLOAT_CHECKS:
        raise ValueError(f"errors must be a subset of {sorted(FLOAT_CHECKS)}, got {sorted(errors)}")

    name = getattr(fn, "__name__", "output")

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if errors:
            with _NanOrigin(name):
                out = fn(*args, **kw)
        else:
            out = fn(*args, **kw)
        assert_finite(out, name)
        return out

    return wrapper
