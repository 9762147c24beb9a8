"""The chain's stages and the numpy builders of its constant matrices.

The package names of ``tpu80211.ops`` resolve here lazily (PEP 562): a
name's module is imported when the name is first read, so importing one
builder pulls in nothing else.
"""

import importlib
import sys
import types

_WHERE = {
    "extract_blocks": "blocks",
    "preamble_fft": "blocks",
    "noise_power_estimate": "blocks",
    "CHANNEL_MODELS": "channel",
    "pdp": "channel",
    "detect_packet": "detect",
    "extract_packet": "detect",
    "interp_matrix": "interp",
    "dft_matrix": "linalg",
    "idft_apply": "linalg",
    "equalize": "equalize",
}

__all__ = list(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))


class _Package(types.ModuleType):
    """``equalize`` names a submodule and its function.  The import system
    sets a submodule on its package when it first loads it; the package
    keeps the name for the function, as ``tpu80211.ops`` does."""

    def __setattr__(self, name, value):
        if name in _WHERE and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
