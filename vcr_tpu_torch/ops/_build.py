"""Build the native sources of the package at first use.

Each CUDA source ``ops/csrc/<name>.cu`` is compiled by ``nvcc``
(:func:`load`), and each host C++ source, such as the batch loader's
``data/csrc/npy_loader.cpp``, by ``g++`` (:func:`load_host`, which needs no
CUDA toolkit), into a shared library with a plain C interface, loaded with
``ctypes``. Libraries go to ``vcr_tpu_torch/_kernels_build/`` (git-ignored),
named by a hash of their source and of the headers it includes
(``csrc/*.cuh``), so an edited source or header is rebuilt and an unchanged
one is not; each is written under a temporary name and renamed into place.
A failed build raises with the compiler's output. Nothing is built when a
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_kernels_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HOST_CXX = "g++"
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _host_cxx() -> str:
    found = shutil.which(HOST_CXX)
    if found:
        return found
    raise RuntimeError(f"{HOST_CXX} not found: the host C++ sources need a C++ compiler")


def source_digest(source: Path) -> str:
    """Hash of a source and of every header it includes by a quoted name,
    resolved beside the file that includes it, recursively."""
    sha, seen = hashlib.sha256(), set()

    def add(path: Path) -> None:
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        sha.update(path.name.encode() + b"\0" + text + b"\0")
        for name in _QUOTED_INCLUDE.findall(text):
            add((path.parent / name.decode()).resolve())

    add(source.resolve())
    return sha.hexdigest()[:16]


def _build(source: Path, compiler: list) -> ctypes.CDLL:
    """Compile ``source`` with ``compiler`` (the command and its flags)
    unless its library exists, and load it."""
    digest = source_digest(source)
    path = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([*compiler, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler[0]).name} failed for {source.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` with nvcc if needed and load it."""
    return _build(CSRC / f"{name}.cu", [_nvcc(), *NVCC_FLAGS])


@functools.lru_cache(maxsize=None)
def load_host(source: Path) -> ctypes.CDLL:
    """Build the host C++ file ``source`` with g++ if needed and load it."""
    return _build(source, [_host_cxx(), *HOST_FLAGS])
