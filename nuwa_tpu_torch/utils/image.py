"""Image grids and PNG files, in numpy and the standard library, and the
gif helpers.

Counterpart of ``nuwa_tpu/utils/image.py``. The JAX package writes the PNG
with Pillow; the port writes the same image itself (8-bit RGB or grey, one
IDAT chunk, no filter) with ``zlib`` and ``struct``, so the trainers need no
imaging package. The gif helpers (``gif_to_array``, ``array_to_gif`` and
the reference's names for them) need Pillow and import it when called.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def seek_all_images(img, channels=3):
    """The frames of an open PIL image, converted to ``channels`` channels."""
    mode = {1: "L", 3: "RGB", 4: "RGBA"}.get(channels)
    if mode is None:
        raise ValueError("channels must be 1, 3, or 4")
    i = 0
    while True:
        try:
            img.seek(i)
        except EOFError:
            return
        yield img.convert(mode)
        i += 1


def gif_to_array(path, channels=3):
    """An animated gif -> float32 (frames, channels, h, w) in [0, 1]."""
    from PIL import Image

    frames = []
    for frame in seek_all_images(Image.open(path), channels=channels):
        arr = np.asarray(frame, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        frames.append(arr.transpose(2, 0, 1))
    return np.stack(frames)


def array_to_gif(arr, path, duration=120, loop=0, optimize=True):
    """float32 (frames, channels, h, w) in [0, 1] -> an animated gif."""
    from PIL import Image

    frames = (np.clip(np.asarray(arr), 0.0, 1.0) * 255).astype(np.uint8).transpose(0, 2, 3, 1)
    images = [Image.fromarray(f[..., 0] if f.shape[-1] == 1 else f) for f in frames]
    images[0].save(str(path), save_all=True, append_images=images[1:], duration=duration,
                   loop=loop, optimize=optimize)
    return path


# the reference's names
gif_to_tensor = gif_to_array
video_tensor_to_gif = array_to_gif


def make_grid(images, nrow=8, padding=2, pad_value=0.0):
    """images: (n, c, h, w) in [0,1] -> (c, H, W) grid (torchvision-like)."""
    images = np.asarray(images)
    n, c, h, w = images.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    H = nrows * (h + padding) + padding
    W = ncol * (w + padding) + padding
    grid = np.full((c, H, W), pad_value, dtype=images.dtype)
    for idx in range(n):
        r, cc = divmod(idx, ncol)
        y = r * (h + padding) + padding
        x = cc * (w + padding) + padding
        grid[:, y : y + h, x : x + w] = images[idx]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_bytes(arr) -> bytes:
    """An 8-bit PNG of ``arr``: (H, W) uint8 grey or (H, W, 3) uint8 RGB."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        colour = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"need (H, W) or (H, W, 3) pixels, got {arr.shape}")
    height, width = arr.shape[:2]
    rows = arr.reshape(height, -1)
    # each scanline starts with its filter type, 0 (none)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_image_grid(images, path, nrow=8):
    """Save (n, c, h, w) images as one PNG grid."""
    grid = make_grid(np.clip(np.asarray(images), 0.0, 1.0), nrow=nrow)
    arr = (grid * 255).astype(np.uint8).transpose(1, 2, 0)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(_png_bytes(arr))
    return path
