"""The boundary between the port and its CUDA libraries.

Each source ``csrc/<name>.cu`` builds to a library with a plain C interface
(``csrc/ffi.cuh``): a launch export takes a table of device pointers and its
length first and the CUDA stream last; every export returns a CUDA error
code, which ``ffi_error_string`` names.  The wrapper that owns a library
declares the ctypes signature of each of its exports once, as a `Library`;
it launches through `launch`, reads attributes through `attributes` and
checks the tensors it hands over with `check_planes`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu80211_torch.kernels import _build, require_cuda
from tpu80211_torch.utils import spans

# the exports' argument types: PTR for any pointer (the pointer table, the
# stream, an output buffer), INT_PTR for the attributes exports' int array
PTR = ctypes.c_void_p
INT, FLOAT, DOUBLE, LONG_LONG = ctypes.c_int, ctypes.c_float, ctypes.c_double, ctypes.c_longlong
INT_PTR = ctypes.POINTER(ctypes.c_int)
ATTRIBUTES = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # the sources' STORE_* codes
# a kernel that a wrapper issues through PyTorch (`launch` counts the library's)
count_torch = spans.counter("launch.torch")


class Library:
    """A kernel library: each export of ``signatures`` (name → argument
    types) is an attribute that returns 0 or raises RuntimeError with the
    library's name of the CUDA error.  The package's library,
    ``csrc/<name>.cu``, is built (if needed; callers that load several may
    first build them in parallel with ``_build.build_all``) and loaded at
    the first call of an export, in a set-up span ``setup.load.<name>``:
    nothing loads before a launch has checked its tensors.  A library at
    ``path`` (a probe's build of a variant) loads at once."""

    def __init__(self, name: str, signatures: dict, path=None):
        self.name, self.signatures, self.path = name, signatures, path
        for export in signatures:
            setattr(self, export, functools.partial(self._first_call, export))
        if path is not None:
            self._load()

    def at(self, path, **signatures) -> Library:
        """These exports, and ``signatures`` that a variant adds, from the
        library built at ``path``."""
        return Library(self.name, {**self.signatures, **signatures}, path)

    def _first_call(self, export: str, *args):
        self._load()
        return getattr(self, export)(*args)

    def _load(self) -> None:
        if self.path is None:
            with spans.setup_span(f"load.{self.name}"):
                cdll = ctypes.CDLL(str(_build.build(_build.CSRC / f"{self.name}.cu")))
        else:
            cdll = ctypes.CDLL(str(self.path))
        err_string = cdll.ffi_error_string
        err_string.argtypes, err_string.restype = (INT,), ctypes.c_char_p

        def check(err, fn, _args):
            if err:
                raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} "
                                   f"({err_string(err).decode()})")
            return err

        for export, argtypes in self.signatures.items():
            fn = getattr(cdll, export, None)  # None: a probe's build of an older body lacks it
            if fn is not None:
                fn.argtypes, fn.restype, fn.errcheck = argtypes, INT, check
            setattr(self, export, fn)


def pointer_table(tensors) -> ctypes.Array:
    """A ctypes array of the tensors' device pointers (None → null)."""
    return (PTR * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def launch(fn, tensors: list, *scalars, counter=lambda: 0) -> None:
    """``fn(table, len(table), *scalars, stream)``: a launch export of a
    `Library` called with the pointer table of ``tensors`` on their device's
    current stream, ``tensors[0]``'s device open; then ``counter`` (the
    ``launch.<kernel>`` count) adds one.  Raises "CUDA tensors only" for
    tensors off the card before any library loads."""
    dev = tensors[0].device
    if dev.type != "cuda":
        require_cuda(tensors[0])
    ptrs = pointer_table(tensors)
    with torch.cuda.device(dev):
        fn(ptrs, len(tensors), *scalars, torch.cuda.current_stream(dev).cuda_stream)
    counter()


def attributes(fn, *args, names=ATTRIBUTES) -> dict:
    """An attributes export's reading of its kernel on the current card,
    ``fn(*args, out)``: by default registers and local (spill) bytes a
    thread, shared bytes a block and resident blocks per SM."""
    out = (ctypes.c_int * len(names))()
    fn(*args, out)
    return dict(zip(names, out))


def check_planes(name: str, planes, shape, dtype, device: torch.device) -> None:
    """Raise unless each tensor of ``planes`` has ``shape`` and ``dtype``
    (a dtype, or a collection of the dtypes taken) and lies contiguous on
    ``device``.  A dtype outside a collection raises TypeError; every
    other rejection ValueError."""
    one = isinstance(dtype, torch.dtype)
    for t in planes:
        if not one and t.dtype not in dtype:
            raise TypeError(f"{name}: want one of {tuple(dtype)}, got {t.dtype}")
        if t.shape != shape or one and t.dtype != dtype:
            raise ValueError(f"{name}: want {tuple(shape)} {dtype if one else t.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}, got {t.device}")
