"""The receive chain in plain PyTorch.

``rx`` and ``sc``, the modules ``tpu80211.pipeline`` names, resolve here
lazily (PEP 562): each is imported when it is first read.
"""

import importlib

__all__ = ["rx", "sc"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
