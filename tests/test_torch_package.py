"""Package-level properties of the port: no JAX, the kernel build, the
device gate of the kernel wrappers."""

import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import tpu80211_torch
from tpu80211 import ops as jops
from tpu80211_torch import kernels
from tpu80211_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(tpu80211_torch.__path__, "tpu80211_torch."))


def test_package_imports_no_jax():
    """Importing the port and every module in it loads no JAX."""
    mods = _modules()
    assert {"tpu80211_torch.kernels.fused_chain", "tpu80211_torch.pipeline.sc",
            "tpu80211_torch.kernels.gen_chain", "tpu80211_torch.kernels.raw_gen_chain",
            "tpu80211_torch.pipeline.stream", "tpu80211_torch.datasets.synthetic",
            "tpu80211_torch.datasets.synthetic_sc", "tpu80211_torch.kernels.mmse_solve",
            "tpu80211_torch.models", "tpu80211_torch.models.lt_ls",
            "tpu80211_torch.models.ps_interp", "tpu80211_torch.models.ps_mmse",
            "tpu80211_torch.pipeline.rx", "tpu80211_torch.ops.linalg",
            "tpu80211_torch.ops.blocks", "tpu80211_torch.ops.equalize",
            "tpu80211_torch.parallel", "tpu80211_torch.parallel.mesh",
            "tpu80211_torch.parallel.multihost", "tpu80211_torch.parallel.launch",
            "tpu80211_torch.bench.scaling", "tpu80211_torch.entry",
            "tpu80211_torch.cli", "tpu80211_torch.__main__", "tpu80211_torch.parity.oracle_np",
            "tpu80211_torch.parity.oracle_native", "tpu80211_torch.datasets.extract",
            "tpu80211_torch.utils.plots",
            *(f"tpu80211_torch.bench.{m}" for m in (
                "common", "stream", "latency", "raw_stream", "raw_quality", "stages", "detect",
                "mmse_solve", "raw_anatomy"))} <= set(mods)
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
    """The package-level names of ``tpu80211``, ``tpu80211.ops`` and
    ``tpu80211.pipeline`` resolve in the port; ``equalize`` is the function
    even after its submodule was imported on its own."""
    import importlib
    import types

    from tpu80211_torch import Config, ops
    from tpu80211_torch.pipeline import rx, sc

    assert tpu80211_torch.__version__ == "0.1.0"
    assert tpu80211_torch.constants.N_SC == 53
    assert tpu80211_torch.EstimatorMode.MATH.value == "math"
    assert "Config" in tpu80211_torch.__all__ and Config().mode is tpu80211_torch.EstimatorMode.MATH
    assert len(ops.__all__) == 11
    importlib.import_module("tpu80211_torch.ops.equalize")
    for name in ops.__all__:
        obj = getattr(ops, name)
        assert not isinstance(obj, types.ModuleType), name
        assert not callable(obj) or obj.__module__.startswith("tpu80211_torch.ops."), name
    from tpu80211_torch.ops import equalize
    assert callable(equalize) and equalize.__name__ == "equalize"
    assert (rx.__name__, sc.__name__) == ("tpu80211_torch.pipeline.rx", "tpu80211_torch.pipeline.sc")
    with pytest.raises(AttributeError):
        ops.no_such_name  # noqa: B018


def test_parallel_exports_the_names_of_the_reference():
    """``tpu80211_torch.parallel`` exports what ``tpu80211.parallel`` does."""
    from tpu80211 import parallel as jparallel
    from tpu80211_torch import parallel

    assert parallel.__all__ == jparallel.__all__
    assert all(hasattr(parallel, name) for name in parallel.__all__)


@pytest.mark.parametrize("name", jops.__all__)
def test_ops_has_every_name_of_the_reference(name):
    """Each name ``tpu80211.ops`` exports, the port's ``ops`` exports too."""
    from tpu80211_torch import ops

    assert name in ops.__all__
    assert type(getattr(ops, name)) is type(getattr(jops, name))


def test_package_names_load_lazily():
    """Reading one name of ``ops`` loads its own module and no other stage;
    importing ``pipeline`` loads neither ``rx`` nor ``sc``."""
    code = ("import sys\n"
            "import tpu80211_torch.pipeline\n"
            "from tpu80211_torch.ops import dft_matrix\n"
            "mods = set(sys.modules)\n"
            "assert 'tpu80211_torch.ops.linalg' in mods\n"
            "bad = {'tpu80211_torch.ops.equalize', 'tpu80211_torch.ops.detect',\n"
            "       'tpu80211_torch.pipeline.rx', 'tpu80211_torch.pipeline.sc'} & mods\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


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


def test_build_all_compiles_only_what_is_missing(tmp_path, monkeypatch):
    """Libraries already there are used without a compiler; one that is
    missing needs nvcc, and its absence raises before anything is built."""
    srcs = [tmp_path / f"{n}.cu" for n in ("a", "b")]
    for src in srcs:
        src.write_text(f"// {src.stem}\n")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    libs = [_build.library_path(src, tmp_path) for src in srcs]
    libs[0].write_bytes(b"")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(srcs, tmp_path)
    assert not libs[1].exists()
    libs[1].write_bytes(b"")
    assert _build.build_all(srcs, tmp_path) == libs


def test_nvcc_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert {"-O3", "-shared", "-std=c++17"} <= set(_build.NVCC_FLAGS)


def test_require_cuda_gate():
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        kernels.require_cuda(torch.zeros(1))
    assert kernels.on_cuda() == torch.cuda.is_available()


def test_entry_points_default_to_the_card():
    """The entries that take a device run on the card unless the caller
    names another; the others follow their inputs' device."""
    import inspect

    from tpu80211_torch import convert, entry
    from tpu80211_torch.bench import quality, scaling, throughput
    from tpu80211_torch.kernels import gen_chain, raw_gen_chain
    from tpu80211_torch.parallel import launch, mesh, multihost
    from tpu80211_torch.pipeline import stream
    from tpu80211_torch.utils import timing

    for fn in (convert.chain_consts, convert.tx_spectra, convert.lts_ref, convert.mf_taps,
               stream.make_device_stream_step, stream.run_stream_device, gen_chain.gen_draws,
               raw_gen_chain.raw_draws, stream.run_stream, quality.quality_point,
               quality.quality_sweep, quality.quality_point_fused, quality.quality_sweep_fused,
               throughput.run_row, throughput.run, timing.timeit, mesh.make_mesh,
               multihost.init_distributed, multihost.hierarchical_mesh, multihost.rank_device,
               launch.launch, scaling.sweep, entry.entry, entry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
