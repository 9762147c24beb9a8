"""The dense MMSE solves: batched 53×53 Hermitian positive definite systems.

The counterpart of ``tpu80211/kernels/mmse_solve.py``.  The reference's
whole parallel effort targets one operation, the regularized 53×53
complex inverse inside PS-MMSE (utils.c:141-170).  The production
estimators never solve it (the rank-1 closed form, ``models/ps_mmse.py``
solver "sm"); these entries keep the reference's computational shape:

* ``fused_rank1_solve(u, rx, ow2)``: z = (σ²I + u·uᴴ)⁻¹·rx, the system
  built in the kernel's registers from u and σ², so it never touches
  device memory (TPU kernel #8, ``_fused_kernel``);
* ``solve_batched(a, rhs)``: the same solve on materialized systems (TPU
  kernel #9, ``_dense_kernel``), the counterpart of
  ``solve_batched_pallas``.

``method`` is "gauss" (LU without pivoting, exact-stable on Hermitian
positive definite systems) or "chol" (LLᴴ).  Both compute in complex64
(f32), as the TPU kernels do, and return the input's dtype.  One
hand-written CUDA kernel (``csrc/mmse_solve.cu``) serves both entries and
both methods: one block of 64 threads per system, the factor in registers
(the design is in the source's header).  Unlike the TPU kernels, the
system is 53×53 (no pad to 64) and any batch size is taken (no 128-lane
tiles).  The kernel reads and writes complex values 8 bytes at a time, so
any complex64 tensor will do, including a slice that starts at an odd
system (8 bytes off a 16-byte boundary, since a system is 22,472 bytes).

``fused_rank1_plain`` and ``solve_batched_plain`` are the same functions in
plain PyTorch: the textbook column loop, batched over systems at f32 (the
JAX package's looped twins, ``_gauss_solve_looped`` and
``_chol_solve_looped``, compute the same).  A wrapper runs them for CPU
tensors only; a CUDA tensor launches the kernel or raises.  They are not
``torch.linalg.solve``: that call is a library yardstick, never the path.
"""

from __future__ import annotations

import torch

from tpu80211_torch import constants as C
from tpu80211_torch.kernels import _ffi
from tpu80211_torch.kernels._ffi import INT, INT_PTR, PTR
from tpu80211_torch.utils import spans

N = C.N_SC
METHODS = ("gauss", "chol")
_count_fused = spans.counter("launch.mmse_solve")
_count_dense = spans.counter("launch.mmse_solve_dense")
LIB = _ffi.Library("mmse_solve", {
    "mmse_solve_launch": (PTR, INT, INT, INT, PTR),
    "mmse_solve_attributes": (INT, INT, INT_PTR),
})


def _recip(p: torch.Tensor) -> torch.Tensor:
    """1/p as conj(p)/|p|², the kernels' form of the pivot inverse."""
    return p.conj() / (p.real.square() + p.imag.square())


def _gauss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Right-looking LU without pivoting, the forward solve riding along,
    then a column-oriented back substitution; a (S, n, n) and b (S, n) are
    overwritten."""
    n = a.shape[-1]
    for j in range(n):
        m = a[:, j + 1:, j] * _recip(a[:, j, j])[:, None]
        a[:, j + 1:, j + 1:] -= m[:, :, None] * a[:, None, j, j + 1:]
        b[:, j + 1:] -= m * b[:, j, None]
    x = torch.empty_like(b)
    for j in reversed(range(n)):
        x[:, j] = b[:, j] * _recip(a[:, j, j])
        b[:, :j] -= a[:, :j, j] * x[:, j, None]
    return x


def _chol(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Right-looking LLᴴ with the forward solve L·y = b riding along, then
    Lᴴ·x = y column by column; a (S, n, n) and b (S, n) are overwritten."""
    n = a.shape[-1]
    dinv = torch.empty(b.shape, dtype=a.real.dtype, device=a.device)
    for j in range(n):
        d = torch.rsqrt(a[:, j, j].real)
        col = a[:, j + 1:, j] * d[:, None]          # L[j+1:, j]
        y = b[:, j] * d
        a[:, j + 1:, j + 1:] -= col[:, :, None] * col.conj()[:, None, :]
        b[:, j + 1:] -= col * y[:, None]
        b[:, j] = y
        a[:, j + 1:, j] = col
        dinv[:, j] = d
    x = torch.empty_like(b)
    for j in reversed(range(n)):
        x[:, j] = b[:, j] * dinv[:, j]
        b[:, :j] -= a[:, j, :j].conj() * x[:, j, None]
    return x


def _solve_plain(a: torch.Tensor, b: torch.Tensor, method: str) -> torch.Tensor:
    """Solve a·x = b per system; overwrites a and b."""
    return (_chol if method == "chol" else _gauss)(a, b)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def _prepare_fused(u: torch.Tensor, rx: torch.Tensor, ow2, method: str):
    """(u, rx) as (S, 53) complex64, σ² as (S,) float32, all contiguous."""
    _check_method(method)
    if not u.is_complex() or u.shape[-1] != N or rx.shape != u.shape or rx.dtype != u.dtype:
        raise ValueError(f"u and rx: want (..., {N}) of one complex dtype, got "
                         f"{tuple(u.shape)} {u.dtype} and {tuple(rx.shape)} {rx.dtype}")
    lead = u.shape[:-1]
    ow2 = torch.broadcast_to(torch.as_tensor(ow2, dtype=torch.float32, device=u.device), lead)
    return (u.reshape(-1, N).to(torch.complex64).contiguous(),
            rx.reshape(-1, N).to(torch.complex64).contiguous(),
            ow2.reshape(-1).contiguous())


def _prepare_dense(a: torch.Tensor, rhs: torch.Tensor, method: str):
    """(a, rhs) as (S, 53, 53) and (S, 53) complex64, contiguous."""
    _check_method(method)
    if (not a.is_complex() or a.shape[-2:] != (N, N) or rhs.shape != (*a.shape[:-1], 1)
            or rhs.dtype != a.dtype):
        raise ValueError(f"a and rhs: want (..., {N}, {N}) and (..., {N}, 1) of one complex "
                         f"dtype, got {tuple(a.shape)} {a.dtype} and {tuple(rhs.shape)} {rhs.dtype}")
    return (a.reshape(-1, N, N).to(torch.complex64).contiguous(),
            rhs.reshape(-1, N).to(torch.complex64).contiguous())


def rank1_systems(u: torch.Tensor, ow2: torch.Tensor) -> torch.Tensor:
    """Ryy = σ²I + u·uᴴ for (…, 53) u and real σ² broadcastable to (…,),
    as (…, 53, 53) in u's dtype."""
    ryy = u[..., :, None] * u[..., None, :].conj()
    ryy.diagonal(dim1=-2, dim2=-1).real.add_(ow2[..., None])
    return ryy


def fused_rank1_plain(u: torch.Tensor, rx: torch.Tensor, ow2,
                      method: str = "gauss") -> torch.Tensor:
    """`fused_rank1_solve` in plain PyTorch, on any device."""
    uf, rf, wf = _prepare_fused(u, rx, ow2, method)
    z = _solve_plain(rank1_systems(uf, wf), rf.clone(), method)
    return z.to(u.dtype).reshape(u.shape)


def solve_batched_plain(a: torch.Tensor, rhs: torch.Tensor,
                        method: str = "gauss") -> torch.Tensor:
    """`solve_batched` in plain PyTorch, on any device."""
    af, rf = _prepare_dense(a, rhs, method)
    z = _solve_plain(af.clone(), rf.clone(), method)
    return z.to(a.dtype).reshape(rhs.shape)


def fused_rank1_solve(u: torch.Tensor, rx: torch.Tensor, ow2,
                      method: str = "gauss") -> torch.Tensor:
    """z = (σ²I + u·uᴴ)⁻¹·rx for a batch of systems.

    ``u``, ``rx``: (…, 53) complex; ``ow2``: real σ², broadcastable to
    (…,).  Returns (…, 53) in u's dtype (computed in complex64).  The CUDA
    kernel for CUDA tensors, ``fused_rank1_plain`` for CPU tensors."""
    if u.device.type == "cpu":
        return fused_rank1_plain(u, rx, ow2, method)
    uf, rf, wf = _prepare_fused(u, rx, ow2, method)
    z = _launch(uf, rf, wf, method)
    return z.to(u.dtype).reshape(u.shape)


def solve_batched(a: torch.Tensor, rhs: torch.Tensor, method: str = "gauss") -> torch.Tensor:
    """`torch.linalg.solve` for (…, 53, 53) complex Hermitian positive
    definite systems with (…, 53, 1) right-hand sides: the counterpart of
    ``solve_batched_pallas`` (``models/ps_mmse.py`` solver
    "dense_pallas").  Computed in complex64, returned in a's dtype.  The
    CUDA kernel for CUDA tensors, ``solve_batched_plain`` for CPU tensors."""
    if a.device.type == "cpu":
        return solve_batched_plain(a, rhs, method)
    af, rf = _prepare_dense(a, rhs, method)
    z = _launch(af, rf, None, method)
    return z.to(a.dtype).reshape(rhs.shape)


def kernel_attributes(entry: str, method: str) -> dict:
    """`_ffi.attributes` of one instantiation ("fused" or "dense" ×
    ``method``): its shared bytes are static, and its blocks per SM are
    systems per SM (one system a block)."""
    _check_method(method)
    if entry not in ("fused", "dense"):
        raise ValueError(f"entry must be 'fused' or 'dense', got {entry!r}")
    return _ffi.attributes(LIB.mmse_solve_attributes, entry == "fused", METHODS.index(method))


def _require_aligned(t: torch.Tensor) -> None:
    """The kernel loads and stores one element at a time (8 bytes of
    complex64, 4 of σ²): raise unless ``t`` starts on a multiple of its
    element size (every tensor that PyTorch allocates or slices does; a
    buffer wrapped from elsewhere may not)."""
    if t.data_ptr() % t.element_size():
        raise ValueError(f"kernel input at address {t.data_ptr():#x}: want "
                         f"{t.element_size()}-byte alignment")


def _launch(mat: torch.Tensor, rhs: torch.Tensor, ow2: torch.Tensor | None,
            method: str) -> torch.Tensor:
    """One launch over every system: ``mat`` is u (S, 53) with ``ow2`` (S,)
    (the fused kernel) or the systems (S, 53, 53) with ``ow2`` None."""
    for t in (mat, rhs, ow2):
        if t is not None:
            if t.device != mat.device:
                raise ValueError(f"inputs on {t.device} and {mat.device}")
            _require_aligned(t)
    z = torch.empty_like(rhs)
    if rhs.shape[0] == 0:
        return z
    if rhs.shape[0] > 2**31 - 1:
        raise ValueError(f"{rhs.shape[0]} systems: at most 2**31 - 1 per launch")
    _ffi.launch(LIB.mmse_solve_launch, [mat, rhs, ow2, z], rhs.shape[0],
                METHODS.index(method), counter=_count_dense if ow2 is None else _count_fused)
    return z
