"""ctypes bindings of the C++ batch feature loader
(``data/csrc/npy_loader.cpp``): the counterpart of ``vcr_tpu/data/native.py``.

The library is built by ``g++`` at first use (``ops/_build.load_host``) into
the git-ignored ``vcr_tpu_torch/_kernels_build/``. :func:`load_feature_batch`
assembles a padded (B, num_frames, *feat) float32 batch from per-video .npy
files: each file is read once, straight into its row of the batch, on a
``std::thread`` fan-out, with the interpreter lock released for the call.

Nothing here falls back: a build that fails raises with the compiler's
output, and a file that the parser refuses raises ``IOError``. Which layouts
it reads is decided by the caller (``pipeline.BatchIterator`` reads the first
file's header and takes this route only for a layout it parses).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from vcr_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "npy_loader.cpp"
# the .npy layouts the C++ parser reads: (header version, dtype), C order
NATIVE_DESCRS = ("<f4", "<f8")
NATIVE_VERSIONS = ((1, 0), (2, 0))


def get_lib() -> ctypes.CDLL:
    """The loader's library, built if needed, with its C signatures."""
    lib = _build.load_host(SOURCE)
    lib.vcr_load_feature_batch.restype = ctypes.c_int
    lib.vcr_load_feature_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int]
    lib.vcr_probe_npy.restype = ctypes.c_int
    lib.vcr_probe_npy.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    return lib


def probe_npy(path: str) -> Tuple[int, int]:
    """-> (rows, elements per row) of a .npy file, read by the C++ parser."""
    rows, elems = ctypes.c_longlong(), ctypes.c_longlong()
    rc = get_lib().vcr_probe_npy(str(path).encode(), ctypes.byref(rows),
                                 ctypes.byref(elems))
    if rc != 0:
        raise IOError(f"vcr_probe_npy({path}) failed: {rc}")
    return rows.value, elems.value


def load_feature_batch(paths: Sequence[str], num_frames: int,
                       feat_shape: Tuple[int, ...], n_threads: int = 8) -> np.ndarray:
    """-> (len(paths), num_frames, *feat_shape) float32: each file's frames,
    zero-padded or truncated to ``num_frames``, float64 rounded to float32
    as ``astype(np.float32)`` rounds it. Raises ``IOError`` naming the
    batch's files if the parser refuses one or a read fails."""
    b = len(paths)
    row_elems = int(np.prod(feat_shape))
    out = np.zeros((b, num_frames, row_elems), dtype=np.float32)
    encoded = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * b)(*encoded)
    rc = get_lib().vcr_load_feature_batch(
        arr, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_frames, row_elems, max(1, n_threads))
    if rc != 0:
        raise IOError(f"vcr_load_feature_batch failed ({rc}) on a batch of {b} "
                      f"files: {[str(p) for p in paths]}")
    return out.reshape(b, num_frames, *feat_shape)


def native_layout(path: str):
    """The per-frame feature shape of a .npy file whose layout the C++
    parser reads (header v1 or v2, little-endian float32 or float64, C
    order, at least one axis), else None. Read with ``np.lib.format``."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version not in NATIVE_VERSIONS:
            return None
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran_order, dtype = read(f)
    if dtype.str not in NATIVE_DESCRS or fortran_order or len(shape) < 1:
        return None
    return tuple(shape[1:])
