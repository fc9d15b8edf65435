"""The batch loader: ctypes bindings to the port's own ``batch_loader.cpp``.

Counterpart of ``nuwa_tpu/native/loader.py``, with the same names and
signatures. The library is host code (no device kernel): ``g++`` builds it
at first use into ``build/libbatch_loader-<hash>.so`` beside this file,
named by the hash of the source as the CUDA kernels are
(``kernels.build.hashed_library``). ``ctypes`` releases the GIL during a
call.

Two deliberate deviations from the JAX package:

- no silent fallback: a build or load that fails raises ``RuntimeError``
  (with the compiler's output) from every function that needs the
  library; ``library_available()`` says False then, and the numpy versions
  (``*_plain``, kept for the tests and the smoke test) are never used in
  the library's place;
- checked indices: each index is checked on the host before a call, as
  numpy indexes (JAX's numpy path) and not as the C code reads (JAX's
  library path reads out of bounds): a negative index wraps once, one
  outside ``[-N, N)`` raises ``IndexError``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..kernels.build import hashed_library

SOURCE = Path(__file__).parent / "batch_loader.cpp"
BUILD_DIR = Path(__file__).parent / "build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of the current source is, or will be, built."""
    return hashed_library(BUILD_DIR, "batch_loader", [SOURCE])


def build_library(force=False):
    """Compile ``batch_loader.cpp`` with ``g++`` unless its library exists
    (or with ``force``); returns the library's path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    target = library_path()
    if target.exists() and not force:
        return str(target)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"the batch loader's build could not run {cmd}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return str(target)


def _load():
    """The loaded library, built first if needed; raises ``RuntimeError``
    if it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_library()
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise RuntimeError(f"cannot load the batch loader {path}: {exc}") from exc
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            for name, args in (
                    ("gather_normalize_f32", [ptr, ptr, i64, i64, ctypes.c_float, ptr,
                                              ctypes.c_int]),
                    ("rot90_f32", [ptr, i64, i64, i64, ctypes.c_int, ptr]),
                    ("gather_i64", [ptr, ptr, i64, i64, ptr])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, None
            _lib = lib
        return _lib


def library_available():
    """True once the library is built and loaded; False if that fails (the
    functions below then raise the failure)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _rows(src, dtype, what):
    """``src`` as a C-contiguous (N, item) array of ``dtype``, without a
    copy where it already is one (a memmap stays on disk)."""
    if src.dtype != dtype:
        raise TypeError(f"{what} takes a {np.dtype(dtype)} array, not {src.dtype}")
    return np.ascontiguousarray(src).reshape(src.shape[0], -1)


def _indices(indices, n):
    """int64 row indices, checked as numpy indexes an axis of length n."""
    idx = np.asarray(indices, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be one-dimensional, not of shape {idx.shape}")
    bad = (idx < -n) | (idx >= n)
    if bad.any():
        raise IndexError(f"index {idx[bad][0]} is out of bounds for axis 0 with size {n}")
    return np.ascontiguousarray(np.where(idx < 0, idx + n, idx))


def gather_normalize_f32(src_u8, indices, scale=1.0 / 255.0, num_threads=0):
    """src_u8: (N, ...) uint8 array or memmap; indices: (B,) ints. Returns
    (B, ...) float32 ``src[indices] * scale``, over ``num_threads`` threads
    (``<= 0``: ``min(os.cpu_count(), 8)``)."""
    lib = _load()
    src = _rows(src_u8, np.uint8, "gather_normalize_f32")
    idx = _indices(indices, src.shape[0])
    out = np.empty((len(idx), src.shape[1]), np.float32)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 8)
    lib.gather_normalize_f32(src.ctypes.data, idx.ctypes.data, len(idx), src.shape[1],
                             ctypes.c_float(scale), out.ctypes.data, num_threads)
    return out.reshape((len(idx),) + tuple(src_u8.shape[1:]))


def rot90_f32(img_chw, k):
    """(c, h, w) float32 rotated counter-clockwise by k * 90 degrees."""
    lib = _load()
    img = np.ascontiguousarray(img_chw, np.float32)
    c, h, w = img.shape
    k = k % 4
    out = np.empty((c, h, w) if k % 2 == 0 else (c, w, h), np.float32)
    lib.rot90_f32(img.ctypes.data, c, h, w, k, out.ctypes.data)
    return out


def gather_i64(src_i64, indices):
    """(B, ...) int64 rows ``src[indices]`` of an (N, ...) int64 array."""
    lib = _load()
    src = _rows(src_i64, np.int64, "gather_i64")
    idx = _indices(indices, src.shape[0])
    out = np.empty((len(idx), src.shape[1]), np.int64)
    lib.gather_i64(src.ctypes.data, idx.ctypes.data, len(idx), src.shape[1], out.ctypes.data)
    return out.reshape((len(idx),) + tuple(src_i64.shape[1:]))


# The numpy versions (JAX's fallback arithmetic), for the tests and the
# smoke test; no data path calls them.


def gather_normalize_f32_plain(src_u8, indices, scale=1.0 / 255.0):
    """``gather_normalize_f32`` in numpy."""
    idx = np.asarray(indices, np.int64)
    return np.asarray(src_u8[idx]).astype(np.float32) * scale


def rot90_f32_plain(img_chw, k):
    """``rot90_f32`` in numpy."""
    img = np.ascontiguousarray(img_chw, np.float32)
    return np.rot90(img, k % 4, axes=(-2, -1)).copy()


def gather_i64_plain(src_i64, indices):
    """``gather_i64`` in numpy."""
    return np.asarray(src_i64[np.asarray(indices, np.int64)], dtype=np.int64)
