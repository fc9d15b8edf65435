"""Token shift: roll channel slices down the height and width axes of the
video, or one token along the audio sequence.

Counterpart of ``nuwa_tpu/ops/shift.py``: video in its one used mode, the
spatial shift (no caller of the JAX package sets ``shift_time``), and audio.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .utils import padding_to_multiple_of


def _torch_chunk_sizes(dim: int, chunks: int):
    """torch.chunk sizing: ceil(dim/chunks) per chunk, last chunk smaller,
    padded with empty chunks up to ``chunks``."""
    per = -(-dim // chunks)
    sizes = []
    left = dim
    while left > 0:
        take = min(per, left)
        sizes.append(take)
        left -= take
    while len(sizes) < chunks:
        sizes.append(0)
    return sizes


def _shift_axis(x, axis):
    """Shift by +1 along ``axis``: zeros in front, last entry dropped."""
    n = x.shape[axis]
    zeros = torch.zeros_like(x.narrow(axis, 0, 1))
    return torch.cat([zeros, x.narrow(axis, 0, n - 1)], dim=axis)


def shift_video_tokens(x, image_size):
    """Shift 1/4 of the channels down H and 1/4 along W within each frame,
    keeping the leading bos token. x: (b, 1 + video tokens, d)."""
    img_seq_len = image_size * image_size
    x_bos, x_video = x[:, :1], x[:, 1:]
    b, n, d = x_video.shape
    padding = padding_to_multiple_of(n, img_seq_len)
    if padding > 0:
        x_video = F.pad(x_video, (0, 0, 0, padding))
    f = x_video.shape[1] // img_seq_len
    x_video = x_video.reshape(b, f, image_size, image_size, d)

    parts = list(x_video.split(_torch_chunk_sizes(d, 4), dim=-1))
    parts[0] = _shift_axis(parts[0], 2)  # down the height axis
    parts[1] = _shift_axis(parts[1], 3)  # along the width axis
    x_video = torch.cat(parts, dim=-1).reshape(b, f * img_seq_len, d)[:, :n]
    return torch.cat([x_bos, x_video], dim=1)


def shift_audio_tokens(x):
    """Shift the first half of the channels (``torch.chunk`` sizing) one
    token along the sequence, bos included: x (b, n, d). The JAX function
    takes the tokens per timestep, pads the sequence to whole timesteps and
    crops it back after the shift; a shift towards the end cropped to n
    tokens never reads the padding, so the timestep size does not change
    the result and is not taken here."""
    half = _torch_chunk_sizes(x.shape[-1], 2)[0]
    return torch.cat([_shift_axis(x[..., :half], 1), x[..., half:]], dim=-1)
