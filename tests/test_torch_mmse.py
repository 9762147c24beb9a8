"""The port's dense MMSE solves (tpu80211_torch.kernels.mmse_solve) against
tpu80211.kernels.mmse_solve and numpy, on the CPU.

On the CPU both packages run a plain column loop in f32: the port its
``*_plain`` versions, the JAX package its looped twins (the interpret path
of ``_fused_call``/``_dense_call``).  The systems are bench.py's
(``_bench_dense_mmse``): σ² = 0.37, u and rx with standard normal real and
imaginary parts, so Ryy = σ²I + u·uᴴ has a condition number near 300.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.kernels import mmse_solve as jms
from tpu80211_torch.kernels import mmse_solve as M
from tpu80211_torch.kernels import mmse_solve_variants as V
from tpu80211_torch.utils import spans

from _torch_inputs import jax_planes, rel, to_np

SIGMA2 = 0.37  # bench.py:169
# two f32 eliminations in different orders, each within ~3e-6 of the f64
# solution at condition ~300 (measured 2-4e-6): 1e-5 between them, 1e-4
# against numpy's f64 solve
TOL_JAX, TOL_F64 = 1e-5, 1e-4


def _systems(seed: int, b: int):
    """u, rx (b, 53) complex64 numpy, σ² (b,) float32, and the f64 solution."""
    rng = np.random.default_rng(seed)
    u, rx = ((rng.standard_normal((b, 53)) + 1j * rng.standard_normal((b, 53))).astype(np.complex64)
             for _ in range(2))
    ow2 = np.full(b, SIGMA2, np.float32)
    a = SIGMA2 * np.eye(53) + u[:, :, None].astype(np.complex128) * np.conj(u[:, None, :])
    return u, rx, ow2, np.linalg.solve(a, rx.astype(np.complex128)[..., None])[..., 0]


def _dense(u: np.ndarray, ow2: np.ndarray) -> np.ndarray:
    """σ²I + u·uᴴ, complex64."""
    return (ow2[:, None, None] * np.eye(53) + u[:, :, None] * np.conj(u[:, None, :])).astype(np.complex64)


@pytest.mark.parametrize("b", [7, 300])
@pytest.mark.parametrize("method", ["gauss", "chol"])
@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_plain_matches_jax_and_numpy(entry, method, b):
    u, rx, ow2, want = _systems(seed=b, b=b)
    if entry == "fused":
        got = M.fused_rank1_solve(torch.tensor(u), torch.tensor(rx), torch.tensor(ow2), method)
        ref = to_np(jms.fused_rank1_solve(jax_planes(u), jax_planes(rx), jnp.asarray(ow2),
                                          method=method))
    else:
        a = _dense(u, ow2)
        got = M.solve_batched(torch.tensor(a), torch.tensor(rx[..., None]), method)[..., 0]
        ref = np.asarray(jms.solve_batched_pallas(jnp.asarray(a), jnp.asarray(rx[..., None]),
                                                  method=method))[..., 0]
    assert got.dtype == torch.complex64 and tuple(got.shape) == (b, 53)
    assert rel(to_np(got), ref) < TOL_JAX
    assert rel(to_np(got), want) < TOL_F64


@pytest.mark.parametrize("method", ["gauss", "chol"])
def test_complex128_in_complex128_out(method):
    """Like solve_batched_pallas (mmse_solve.py:749-755): complex128 in,
    solved in complex64, complex128 out; likewise the fused entry."""
    u, rx, ow2, want = _systems(seed=3, b=5)
    u128, rx128 = torch.tensor(u, dtype=torch.complex128), torch.tensor(rx, dtype=torch.complex128)
    z = M.fused_rank1_solve(u128, rx128, SIGMA2, method)
    assert z.dtype == torch.complex128
    assert torch.equal(z, M.fused_rank1_solve(torch.tensor(u), torch.tensor(rx), SIGMA2, method)
                       .to(torch.complex128))
    a = torch.tensor(_dense(u, ow2), dtype=torch.complex128)
    zd = M.solve_batched(a, rx128[..., None], method)
    assert zd.dtype == torch.complex128 and tuple(zd.shape) == (5, 53, 1)
    ref = jms.solve_batched_pallas(jnp.asarray(a.numpy()), jnp.asarray(rx128[..., None].numpy()),
                                   method=method)
    assert ref.dtype == jnp.complex128
    assert rel(zd.numpy(), np.asarray(ref)) < TOL_JAX
    assert rel(z.numpy(), want) < TOL_F64


def test_leading_dims_and_sigma_broadcast():
    """(2, 3, 53) systems with a per-frame σ² of shape (2, 1): the same as
    the flat batch with σ² spelled out per system."""
    u, rx, _, _ = _systems(seed=4, b=6)
    ow2 = np.array([[0.2], [0.5]], np.float32)
    got = M.fused_rank1_solve(torch.tensor(u).reshape(2, 3, 53), torch.tensor(rx).reshape(2, 3, 53),
                              torch.tensor(ow2))
    flat = M.fused_rank1_solve(torch.tensor(u), torch.tensor(rx),
                               torch.tensor(np.repeat(ow2[:, 0], 3)))
    assert tuple(got.shape) == (2, 3, 53)
    assert torch.equal(got.reshape(6, 53), flat)


def test_plain_versions_leave_inputs_alone():
    u, rx, ow2, _ = _systems(seed=5, b=4)
    tu, trx, a = torch.tensor(u), torch.tensor(rx), torch.tensor(_dense(u, ow2))
    keep = [t.clone() for t in (tu, trx, a)]
    for method in M.METHODS:
        M.fused_rank1_plain(tu, trx, SIGMA2, method)
        M.solve_batched_plain(a, trx[..., None], method)
    assert all(torch.equal(t, k) for t, k in zip((tu, trx, a), keep))


def _launches() -> tuple[int, int]:
    """The fused and the dense solve's launch counts so far."""
    c = spans.counters.snapshot()
    return c.get("launch.mmse_solve", 0), c.get("launch.mmse_solve_dense", 0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    u, rx, ow2, _ = _systems(seed=6, b=3)
    before = _launches()
    for method in M.METHODS:
        got = M.fused_rank1_solve(torch.tensor(u), torch.tensor(rx), torch.tensor(ow2), method)
        assert torch.equal(got, M.fused_rank1_plain(torch.tensor(u), torch.tensor(rx),
                                                    torch.tensor(ow2), method))
        a, r = torch.tensor(_dense(u, ow2)), torch.tensor(rx[..., None])
        assert torch.equal(M.solve_batched(a, r, method), M.solve_batched_plain(a, r, method))
    assert _launches() == before


def test_launcher_refuses_cpu_tensors():
    """The kernel launcher takes CUDA tensors only: it raises on CPU ones
    before building anything."""
    u, rx, ow2, _ = _systems(seed=7, b=2)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        M._launch(torch.tensor(u), torch.tensor(rx), torch.tensor(ow2), "gauss")


@pytest.mark.parametrize("bad", ["method", "width", "rx_shape", "dtype", "dense_rhs"])
def test_bad_arguments_raise(bad):
    u, rx, ow2, _ = _systems(seed=8, b=2)
    tu, trx = torch.tensor(u), torch.tensor(rx)
    with pytest.raises(ValueError):
        if bad == "method":
            M.fused_rank1_solve(tu, trx, ow2, "gauss_looped")
        elif bad == "width":
            M.fused_rank1_solve(tu[:, :52], trx[:, :52], ow2)
        elif bad == "rx_shape":
            M.fused_rank1_solve(tu, trx[:1], ow2)
        elif bad == "dtype":
            M.fused_rank1_solve(tu.real, trx.real, ow2)
        else:
            M.solve_batched(torch.tensor(_dense(u, ow2)), trx)


@pytest.mark.parametrize("entry", ["fused", "dense"])
def test_prepare_passes_odd_slices_in_place(entry):
    """A slice from system 1 on starts 8 bytes off a 16-byte boundary (a
    system is 22,472 bytes, a row 424; σ² 4 bytes off); `_prepare_*` hands
    it to the kernel in place, with no silent copy, and the kernel reads one
    element at a time."""
    u, rx, ow2, _ = _systems(seed=9, b=5)
    tu, trx, tw = torch.tensor(u), torch.tensor(rx), torch.tensor(ow2)
    if entry == "fused":
        ins = (tu[1:], trx[1:], tw[1:])
        outs = M._prepare_fused(*ins, "gauss")
    else:
        ins = (torch.tensor(_dense(u, ow2))[1:], trx[1:, :, None])
        outs = M._prepare_dense(*ins, "chol")
    for t, o in zip(ins, outs):
        assert o.data_ptr() == t.data_ptr() and o.is_contiguous()
        M._require_aligned(o)
    assert outs[0].data_ptr() % 16 == 8


def test_require_aligned_refuses_a_misaligned_buffer():
    """A complex64 array wrapped from a buffer 4 bytes off: the launcher's
    alignment check raises before any kernel could read it."""
    raw = bytearray(8 * 53 + 4)
    off = torch.from_numpy(np.frombuffer(raw, np.complex64, count=53, offset=4))
    assert off.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="want 8-byte alignment"):
        M._require_aligned(off)
    M._require_aligned(torch.from_numpy(np.frombuffer(raw, np.complex64, count=53)))


@pytest.mark.parametrize("entry, method", [("fused", "lu"), ("batched", "chol")])
def test_kernel_attributes_checks_its_arguments(entry, method):
    """Bad names raise before anything is built (no nvcc here)."""
    with pytest.raises(ValueError):
        M.kernel_attributes(entry, method)


@pytest.mark.parametrize("name", sorted(V.DIAGNOSTICS))
def test_diagnostic_variants_still_apply_to_the_kernel_source(name):
    """Each diagnostic build of mmse_solve_variants edits text that the
    kernel's source still holds (the edit raises otherwise)."""
    assert V.variant_source(V.DIAGNOSTICS[name]) != V.SOURCE.read_text()
