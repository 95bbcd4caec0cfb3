"""Build the CUDA sources under ``ops/csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``. Libraries go to
``vcr_tpu_torch/_kernels_build/`` (git-ignored), named by a hash of their
source and of the headers it includes (``csrc/*.cuh``), so an edited source
or header is rebuilt and an unchanged one is not. Nothing is built when a
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
_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


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


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    source = CSRC / f"{name}.cu"
    digest = source_digest(source)
    path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))
