"""Sparse3DNA — 3D nearby attention over a (frames, height, width) grid —,
SparseCausal2DNA, its audio counterpart over (timesteps, tokens per
timestep), and SparseCross2DNA, the video decoder's cross-attention to
sketch frames.

Counterpart of ``Sparse3DNA`` in ``nuwa_tpu/nda.py`` in both of its modes:
causal (the video decoder) and centered (the sketch encoder's
``sketch_enc_use_sparse_3dna``). The attention itself is
``kernels.nda.sparse_3dna``, differentiable: the Hopper kernels (forward,
query-side and key-side backward) on CUDA tensors, their plain gather
versions on CPU tensors. Both modules take the JAX modules' ``dropout``
(the attention dropout rate) and draw its mask in the kernels from the seed
that ``forward(x, seed=...)`` gives (no seed: no dropout, inference). The
mask is the JAX gather path's coordinate-keyed one (``_coord_keep_mask``):
for Sparse3DNA the JAX module's own CPU path with dropout, for
SparseCausal2DNA its ``_nda_attend`` with ``drop_ids`` (its gather path
draws ``jax.random`` bits instead, which torch cannot draw).

``SparseCausal2DNA`` is the counterpart of the JAX module of that name
without its ``use_pallas`` and ``backend`` options and the gates that pick
between them: its attention is ``kernels.nda.sparse_3dna`` in the audio
geometry for every height (the forward kernel on CUDA tensors, the plain
gather version on CPU tensors).

``SparseCross2DNA`` is the counterpart of the JAX module of that name
without its ``backend`` and ``use_pallas`` options: its video queries go
through ``kernels.cross.sparse_cross_2dna``, differentiable (the Hopper
kernels on CUDA tensors, their plain gather versions on CPU tensors); the
bos query's attention to the whole context stays plain PyTorch, as it is
XLA outside the kernel in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from .core.layers import Dense, kaiming_uniform_, kernel_seed, normal_
from .core.tp import whole
from .kernels.cross import sparse_cross_2dna
from .kernels.nda import sparse_3dna
from .ops.attention import merge_heads, split_heads
from .ops.embeddings import AxialPositionalEmbedding
from .ops.utils import max_neg_value, stable_softmax


def _cast_tuple(val, size):
    return tuple(val) if isinstance(val, (tuple, list)) else (val,) * size


# ---------------------------------------------------------------------------
# static neighbourhood index tables (copied from nuwa_tpu/nda.py:65-121)
# ---------------------------------------------------------------------------


def _axis_neighbors(size: int, k: int, dilation: int, mode: str):
    """Per-axis neighbour coordinates (size, k) and their validity; mode
    "full" gives every position of the axis (k is then the size)."""
    q = np.arange(size)[:, None]
    if mode == "full":
        nb = np.broadcast_to(np.arange(size)[None, :], (size, size)).copy()
        return nb, np.ones_like(nb, dtype=bool)
    if mode == "causal":
        offs = (np.arange(k) - (k - 1)) * dilation
    elif mode == "centered":
        offs = (np.arange(k) - (k - 1) // 2) * dilation
    else:
        raise ValueError(mode)
    nb = q + offs[None, :]
    valid = (nb >= 0) & (nb < size)
    return np.clip(nb, 0, size - 1), valid


def build_nda_indices(
    shape: Tuple[int, ...],
    kernel: Tuple[int, ...],
    dilation: Tuple[int, ...],
    modes: Tuple[str, ...],
):
    """(T, Kn) flat neighbour indices and validity for a token grid; the Kn
    window positions are enumerated row-major over the axes (torch unfold's
    patch order, which the rel-pos bias table follows)."""
    per_axis = [
        _axis_neighbors(s, k, d, m)
        for s, k, d, m in zip(shape, kernel, dilation, modes)
    ]
    strides = np.cumprod((1,) + tuple(reversed(shape)))[::-1][1:]
    idx = np.zeros((1, 1), dtype=np.int64)
    valid = np.ones((1, 1), dtype=bool)
    for axis, (nb, v) in enumerate(per_axis):
        s_axis, k_axis = nb.shape
        Q, K = idx.shape
        idx = (
            idx[:, None, :, None] + (nb * strides[axis])[None, :, None, :]
        ).reshape(Q * s_axis, K * k_axis)
        valid = (valid[:, None, :, None] & v[None, :, None, :]).reshape(
            Q * s_axis, K * k_axis
        )
    return idx.astype(np.int32), valid


class Sparse3DNA(nn.Module):
    """3D nearby attention with bos out of band: every video query attends
    its causal (``causal=True``) or centered dilated window and the bos
    key/value, and bos adopts its own value. Token 0 of the input is the
    bos, whatever it holds (in the sketch encoder, the first sketch token).
    Keys at or past the sequence end, which centered windows reach in a
    ragged last frame, are masked. A token mask is not taken: every token is
    attended, as in the JAX module. ``dropout`` is the attention dropout
    rate, applied with a seed."""

    def __init__(self, dim, video_shape, kernel_size=3, dilation=1, heads=8,
                 dim_head=64, causal=False, rel_pos_bias=False, dropout=0.0):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.causal = causal
        self.dropout = dropout
        self.video_shape = tuple(video_shape)
        self.kernel = _cast_tuple(kernel_size, 3)
        if not all(n % 2 == 1 for n in self.kernel):
            raise ValueError("kernel size must be odd")
        self.dilations = _cast_tuple(dilation, 3)
        inner = heads * dim_head
        self.inner_dim = inner
        self.to_q = Dense(dim, inner)
        self.to_kv = Dense(dim, inner * 2)
        self.to_out = Dense(inner, dim, use_bias=True)
        self.talking_heads = nn.Parameter(torch.empty(heads, heads))
        self.rel_pos_bias = (
            AxialPositionalEmbedding(heads, shape=self.kernel) if rel_pos_bias else None
        )

    def reset_parameters(self, generator):
        kaiming_uniform_(self.talking_heads, generator, self.heads)

    def rel_bias(self):
        """(heads, Kn) bias over window positions, or None."""
        return None if self.rel_pos_bias is None else self.rel_pos_bias().T

    def forward(self, x, *, seed=None, **_):
        b, n, _ = x.shape
        h = self.heads
        t = n - 1  # video tokens after bos
        k, v = self.to_kv(x).chunk(2, dim=-1)
        if t == 0:  # bos only: it adopts its own value
            return self.to_out(v)

        q = split_heads(self.to_q(x), h) * self.dim_head**-0.5
        k, v = split_heads(k, h), split_heads(v, h)
        q, bos_v_out = q[:, :, 1:], v[:, :, :1]
        k_bos, k = k[:, :, :1], k[:, :, 1:]
        v_bos, v = v[:, :, :1], v[:, :, 1:]

        out = sparse_3dna(
            q, k, v, k_bos, v_bos, self.talking_heads, self.rel_bias(),
            fmap=self.video_shape[1:], kernel=self.kernel, dilation=self.dilations,
            mode="causal" if self.causal else "centered", dropout=(self.dropout, kernel_seed(seed)),
        )
        out = torch.cat([bos_v_out, out], dim=2)
        return self.to_out(merge_heads(out))


class SparseCausal2DNA(nn.Module):
    """Causal nearby attention for audio tokens laid out (time, height):
    each query attends every token of the ``kernel_size`` dilated past
    timesteps (its own included, the later tokens of its own timestep too,
    as the JAX module's forward does) and the bos key/value, with talking
    heads and an optional (kernel_size, height) axial bias. One fused qkv
    projection; bos adopts its own value. A ragged last timestep's missing
    tokens are masked: the JAX module pads the sequence to whole timesteps
    and masks the padding, the kernels mask every token at or past t.
    ``dropout`` is the attention dropout rate, applied with a seed."""

    def __init__(self, dim, height=1, heads=8, dim_head=64, kernel_size=5, dilation=1,
                 rel_pos_bias=False, dropout=0.0):
        super().__init__()
        self.dim, self.height, self.heads, self.dim_head = dim, height, heads, dim_head
        self.dropout = dropout
        self.kernel_size, self.dilation = kernel_size, dilation
        inner = heads * dim_head
        self.inner_dim = inner
        self.to_qkv = Dense(dim, inner * 3)
        self.to_out = Dense(inner, dim)
        self.talking_heads = nn.Parameter(torch.empty(heads, heads))
        self.rel_pos_bias = (
            AxialPositionalEmbedding(heads, shape=(kernel_size, height))
            if rel_pos_bias else None
        )

    def reset_parameters(self, generator):
        kaiming_uniform_(self.talking_heads, generator, self.heads)

    def rel_bias(self):
        """(heads, kernel_size * height) bias over window slots, or None."""
        return None if self.rel_pos_bias is None else self.rel_pos_bias().T

    def forward(self, x, *, seed=None, **_):
        b, n, _ = x.shape
        h = self.heads
        t = n - 1  # audio tokens after bos
        if t == 0:  # bos only: it adopts its own value
            return self.to_out(self.to_qkv(x).chunk(3, dim=-1)[2])
        q, k, v = (split_heads(u, h) for u in self.to_qkv(x).chunk(3, dim=-1))
        q = q[:, :, 1:] * self.dim_head**-0.5
        bos_v_out = v[:, :, :1]
        k_bos, k = k[:, :, :1], k[:, :, 1:]
        v_bos, v = v[:, :, :1], v[:, :, 1:]

        # the audio geometry: a (timesteps, 1, H) grid, windows of whole timesteps
        H = self.height
        out = sparse_3dna(q, k, v, k_bos, v_bos, self.talking_heads, self.rel_bias(),
                          fmap=(1, H), kernel=(self.kernel_size, 1, H),
                          dilation=(self.dilation, 1, 1), mode="audio",
                          dropout=(self.dropout, kernel_seed(seed)))
        out = torch.cat([bos_v_out, out], dim=2)
        return self.to_out(merge_heads(out))


class SparseCross2DNA(nn.Module):
    """Cross-attention from video queries to a 2D spatial neighbourhood of
    the context (sketch) tokens, plus null k/v: a query at spatial (y, x) of
    any frame attends the centered ``kernel_size`` window around (y, x) in
    every context frame, with talking heads; bos attends the whole context
    (no talking heads). ``context_mask`` (b, Lc) bool leaves context tokens
    out: padded sketch frames, and the unconditional half of a CFG batch.
    ``dropout`` is the attention dropout rate of the video queries, applied
    with a seed; the bos query's attention is not dropped, as in the JAX
    module."""

    def __init__(self, dim, image_size, heads=8, dim_head=64, kernel_size=3, dilation=1,
                 dropout=0.0):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel size must be odd")
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.dropout = dropout
        self.image_size, self.kernel_size, self.dilation = image_size, kernel_size, dilation
        inner = heads * dim_head
        self.inner_dim = inner
        self.to_q = Dense(dim, inner)
        self.to_kv = Dense(dim, inner * 2)
        self.to_out = Dense(inner, dim)
        self.null_k = nn.Parameter(torch.empty(heads, 1, dim_head))
        self.null_v = nn.Parameter(torch.empty(heads, 1, dim_head))
        self.talking_heads = nn.Parameter(torch.empty(heads, heads))

    def reset_parameters(self, generator):
        normal_(self.null_k, generator)
        normal_(self.null_v, generator)
        kaiming_uniform_(self.talking_heads, generator, self.heads)

    def forward(self, x, *, context, context_mask=None, seed=None, **_):
        b = x.shape[0]
        h, dh = self.heads, self.dim_head
        if context_mask is None:
            context_mask = torch.ones(context.shape[:2], dtype=torch.bool, device=x.device)
        q = split_heads(self.to_q(x), h) * dh**-0.5
        k, v = (split_heads(t, h) for t in self.to_kv(context).chunk(2, dim=-1))
        null_k = whole(self.null_k).to(k.dtype).expand(b, h, 1, dh)
        null_v = whole(self.null_v).to(v.dtype).expand(b, h, 1, dh)

        # bos: full attention over [null, context]
        k_full, v_full = torch.cat([null_k, k], dim=2), torch.cat([null_v, v], dim=2)
        sim_bos = torch.einsum("bhd,bhjd->bhj", q[:, :, 0], k_full)
        bos_mask = nn.functional.pad(context_mask, (1, 0), value=True)
        sim_bos = sim_bos.masked_fill(~bos_mask[:, None], max_neg_value(sim_bos.dtype))
        attn_bos = stable_softmax(sim_bos).to(v_full.dtype)
        out = torch.einsum("bhj,bhjd->bhd", attn_bos, v_full)[:, :, None]

        if x.shape[1] > 1:
            out_nb = sparse_cross_2dna(
                q[:, :, 1:], k, v, null_k, null_v, self.talking_heads, context_mask,
                fmap=self.image_size, kernel_size=self.kernel_size, dilation=self.dilation,
                dropout=(self.dropout, kernel_seed(seed)),
            )
            out = torch.cat([out, out_nb.to(out.dtype)], dim=2)
        return self.to_out(merge_heads(out))
