"""The batch loader's host-side helpers, in numpy.

Counterpart of the numpy paths of ``nuwa_tpu/native/loader.py``. The JAX
package can also run them from a small g++ library (``batch_loader.cpp``),
a host-side speed-up of the same arithmetic, not a TPU kernel; the port
keeps the numpy versions only.
"""
from __future__ import annotations

import numpy as np


def gather_normalize_f32(src_u8, indices, scale=1.0 / 255.0):
    """src_u8: (N, ...) uint8 array or memmap; indices: (B,) ints. Returns
    (B, ...) float32 ``src[indices] * scale``."""
    idx = np.asarray(indices, np.int64)
    return np.asarray(src_u8[idx]).astype(np.float32) * scale


def rot90_f32(img_chw, k):
    """(c, h, w) float32 rotated counter-clockwise by k * 90 degrees."""
    img = np.ascontiguousarray(img_chw, np.float32)
    return np.rot90(img, k % 4, axes=(-2, -1)).copy()


def gather_i64(src_i64, indices):
    """(B, ...) int64 rows ``src[indices]``."""
    return np.asarray(src_i64[np.asarray(indices, np.int64)], dtype=np.int64)
