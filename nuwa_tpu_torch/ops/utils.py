"""Generic helpers: device choice, masking and the fp32 softmax.

Counterpart of ``nuwa_tpu/ops/utils.py``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a GPU and without an explicit device this raises — the
    port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def padding_to_multiple_of(n, mult):
    remainder = n % mult
    return 0 if remainder == 0 else mult - remainder


def masked_fill(t, mask, value):
    """Set positions where ``mask`` is True to ``value``."""
    return t.masked_fill(mask, value)


def max_neg_value(dtype):
    return -torch.finfo(dtype).max


def stable_softmax(t, dim=-1):
    """fp32 softmax with max-subtraction, returned in fp32."""
    t = t.float()
    t = t - t.amax(dim=dim, keepdim=True)
    return torch.softmax(t, dim=dim)


def batch_process(t, fn, chunks=10, dim=0):
    """``fn`` over ``t`` in ``chunks`` pieces along ``dim`` (``torch.chunk``
    sizes), concatenated: bounds the memory of a large VAE decode."""
    return torch.cat([fn(piece) for piece in t.chunk(chunks, dim=dim)], dim=dim)
