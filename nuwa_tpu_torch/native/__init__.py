"""The port's host-side C++ runtime, loaded with ctypes: the memmap batch
loader (gather and uint8 -> float32 normalisation, rot90, int64 gather),
which ``train.data.MemmappedImageDataset`` reads through. Built with g++
at first use; a failed build raises, with no numpy fallback.

Counterpart of ``nuwa_tpu/native``.
"""
from .loader import (
    build_library,
    gather_i64,
    gather_normalize_f32,
    library_available,
    rot90_f32,
)

__all__ = [
    "build_library",
    "library_available",
    "gather_normalize_f32",
    "gather_i64",
    "rot90_f32",
]
