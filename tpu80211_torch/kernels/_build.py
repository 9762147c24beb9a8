"""Build the CUDA sources into shared libraries (``_ffi`` loads them).

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` builds them in seconds.  The library is built at first use into
``_build/`` beside this file, under a name that carries a hash of the
sources and the compile command: an edited source builds anew, an
unchanged one loads the library already there.  A missing ``nvcc`` or a
failed build raises; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

from tpu80211_torch.utils import spans

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
    return build_all([source], build_dir)[0]


def build_all(sources, build_dir: pathlib.Path = BUILD_DIR) -> list[pathlib.Path]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together; returns the libraries' paths.  Raises if any build
    fails (after every started build has ended).  Each compile is a set-up
    span, ``setup.build.<source>``, from its start to its end."""
    libs = [library_path(pathlib.Path(src), build_dir) for src in sources]
    todo = [(pathlib.Path(src), lib) for src, lib in zip(sources, libs) if not lib.exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    # build under temporary names, then rename: a concurrent process sees
    # either no library or a whole one
    running, timing = [], []
    try:
        for src, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            timing.append(spans.setup_span(f"build.{src.stem}", leaf=True))
            timing[-1].__enter__()
            running.append((src, lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, lib, tmp, proc in running:
            out, err = proc.communicate()
            timing.pop(0).__exit__(None, None, None)
            if proc.returncode != 0:
                errors.append(f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                              f"{err}{out}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for span in timing:
            span.__exit__(None, None, None)
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return libs
