"""Build the CUDA sources into a shared library and load it with ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` builds them in seconds.  The library is built at first use into
``_build/`` beside this file, under a name that carries a hash of the
sources and the compile command: an edited source builds anew, an
unchanged one loads the library already there.  A missing ``nvcc`` or a
failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda),
    else ``nvcc`` on PATH."""
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of tpu80211_torch are compiled from kernels/csrc at "
            "first use and need the CUDA toolkit")
    return found


def library_path(source: pathlib.Path, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where ``source`` builds to: the name hashes the source, the headers
    beside it and the compile flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in (source, *sorted(source.parent.glob("*.cuh"))):
        digest.update(dep.read_bytes())
    return build_dir / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: pathlib.Path, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile ``source`` for sm_90a unless its library exists; returns the
    library's path."""
    lib = library_path(source, build_dir)
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent process sees
    # either no library or a whole one
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(CSRC / f"{name}.cu")))
