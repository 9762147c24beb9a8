"""Package-level properties of the port: no JAX, the kernel build, the
device gate of the kernel wrappers."""

import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import tpu80211_torch
from tpu80211_torch import kernels
from tpu80211_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(tpu80211_torch.__path__, "tpu80211_torch."))


def test_package_imports_no_jax():
    """Importing the port and every module in it loads no JAX."""
    mods = _modules()
    assert "tpu80211_torch.kernels.fused_chain" in mods and "tpu80211_torch.pipeline.sc" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpu80211.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_package_exports():
    assert tpu80211_torch.__version__ == "0.1.0"
    assert tpu80211_torch.constants.N_SC == 53
    assert tpu80211_torch.EstimatorMode.MATH.value == "math"


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No CUDA compiler: the build raises a clear error, builds nothing and
    never falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(_build.CSRC / "fused_chain.cu", tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    """A library already built from the same sources and flags is used as
    is (no compiler needed); an edited source or header gets another name,
    so it builds anew."""
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    lib = _build.library_path(src, tmp_path)
    lib.write_bytes(b"")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    assert _build.build(src, tmp_path) == lib
    (tmp_path / "k.cuh").write_text("// header\n")
    with_header = _build.library_path(src, tmp_path)
    src.write_text("// v2\n")
    assert len({lib, with_header, _build.library_path(src, tmp_path)}) == 3


def test_nvcc_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert {"-O3", "-shared", "-std=c++17"} <= set(_build.NVCC_FLAGS)


def test_require_cuda_gate():
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        kernels.require_cuda(torch.zeros(1))
    assert kernels.on_cuda() == torch.cuda.is_available()
