"""int8 weight-only quantization for serving.

Counterpart of ``nuwa_tpu/utils/quantize.py``, acting on a module in place:
the projection weights of every ``Dense`` (``to_q``, ``to_kv``, ``to_qkv``,
``to_out``, ``w_in``, ``w_out``, ``project_in``, ``project_out``) become
int8 with an fp32 scale per output channel, and so do the bare logits heads
(``to_logits``, ``to_video_logits``, ``to_audio_logits``), which the models
read through ``head_logits``. Norms, biases, embeddings, convolutions and the
frozen VAEs stay in fp32. Weights are selected by the JAX package's path
regexes, matched against each weight's path in the JAX params tree
(``convert.jax_path``, '/'-joined), so the same weights are quantised, to
the same int8 values and scales.

Usage::

    from nuwa_tpu_torch.utils.quantize import quantize_int8_
    quantize_int8_(model)
    video = model.generate(text)

A quantised model holds int8 buffers in place of those parameters: it is
for serving only.
"""
from __future__ import annotations

import re

import torch
from torch import nn

from ..core.layers import Dense
from ..core.tp import column, shard_of

# '/'-joined param paths whose {"w": (din, dout)} leaf gets quantized
_QUANT_W_RE = re.compile(
    r"(to_q|to_kv|to_qkv|to_out|w_in|w_out|project_in|project_out)$"
)
# bare (din, dout) logits-head leaves (read through ``dequant``)
_QUANT_HEAD_RE = re.compile(r"to_logits$|to_video_logits$|to_audio_logits$")


def _quantize_w(w):
    """(din, dout) float tensor -> (int8 w, fp32 scale per output channel):
    the JAX package's ops in its order, so the same values and scales come
    out."""
    w = w.detach().float()
    scale = (w.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
    return torch.round(w / scale).clamp(-127, 127).to(torch.int8), scale


class Int8Weight(nn.Module):
    """A quantised logits head: the int8 weight ``w`` and its fp32 scale per
    output channel ``w_scale``, the JAX tree's ``{"w", "w_scale"}`` dict."""

    def __init__(self, w, w_scale):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("w_scale", w_scale)


def quantize_head_(owner: nn.Module, name: str):
    """Replace the logits head parameter ``owner.<name>`` by its
    ``Int8Weight``."""
    q, scale = _quantize_w(getattr(owner, name))
    delattr(owner, name)
    setattr(owner, name, Int8Weight(q, scale))


def head_logits(x, head):
    """``x @ head``: the logits of a head, parameter or ``Int8Weight``,
    column-parallel when its output (vocabulary) axis is split over the
    model axis (``core.tp``)."""
    w = dequant(head, x.dtype)
    shard = shard_of(head.w if isinstance(head, Int8Weight) else head)
    return x @ w if shard is None else column(x, w, shard)


def dequant(head, dtype=torch.float32):
    """A logits head as a ``dtype`` matrix for a plain product: the
    parameter cast, or a quantised head's int8 weight times its scale."""
    if isinstance(head, Int8Weight):
        return head.w.to(dtype) * head.w_scale.to(dtype)
    return head.to(dtype)


def _jax_path(model, name):
    from ..convert import jax_path

    return jax_path(model, name).replace(".", "/")


@torch.no_grad()
def quantize_int8_(model: nn.Module, *, skip=("vae", "sketch_vae"), include=None,
                   exclude=None) -> nn.Module:
    """Quantise ``model``'s projection weights and logits heads to int8 in
    place and return it; already quantised weights stay as they are.

    ``skip``: top-level submodules left untouched (the frozen VAEs decode
    pixels and tokenize sketches in full precision). ``include`` and
    ``exclude`` (regexes, ``re.search`` on the '/'-joined path) narrow or
    veto the selection: a weight is quantised iff its path matches the
    known names AND (``include`` is None or matches) AND NOT (``exclude``
    matches)."""
    inc = re.compile(include) if isinstance(include, str) else include
    exc = re.compile(exclude) if isinstance(exclude, str) else exclude

    def selected(name, pattern):
        if name.split(".", 1)[0] in skip:
            return False
        path = _jax_path(model, name)
        return bool(pattern.search(path)
                    and (inc is None or inc.search(path))
                    and (exc is None or not exc.search(path)))

    for name, mod in list(model.named_modules()):
        if (isinstance(mod, Dense) and not mod.quantized and mod.w.ndim == 2
                and selected(name, _QUANT_W_RE)):
            mod.quantize_()
    for name, param in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        if param.ndim == 2 and selected(name, _QUANT_HEAD_RE):
            quantize_head_(model.get_submodule(owner_name), leaf)
    return model
