"""Chunk-aligned cross-modality (video <-> audio) cross attention.

Counterpart of ``CrossModalityCrossAttention`` in
``nuwa_tpu/ops/crossmodality.py``, the RETRO-style chunked cross attention:
sequence chunk i (one video frame's tokens) attends context chunk i, which
the left padding of ``context_chunk_size - 1`` makes the *preceding*
frame's tokens of the other modality (the first chunk sees only the
context's start token). Dense within a chunk, plain PyTorch: no TPU kernel
stands behind it.

Attention dropout comes *before* the talking-heads mix here, as the JAX
module has it (``Attention`` drops after its mix); its mask is keyed by
(seed, batch row, head, query, key), the query's id its position in the
chunked sequence, a key's its position in the left-padded context, the null
column's -1.

The JAX module's documented deviation from the reference is kept: the
context's zero padding positions are always masked (the null key/value
leaves every row a valid target). Its options that no caller sets are not
taken: a context width other than ``dim``, sequences without a start token
and the input norms.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.layers import Dense, dropout, kaiming_uniform_, normal_
from .attention import NULL_KEY
from .utils import masked_fill, max_neg_value, padding_to_multiple_of, stable_softmax


class CrossModalityCrossAttention(nn.Module):
    def __init__(self, dim, chunk_size, context_chunk_size, heads=8, dim_head=64,
                 dropout=0.0):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.dropout = dropout
        self.chunk_size, self.context_chunk_size = chunk_size, context_chunk_size
        inner = heads * dim_head
        self.inner_dim = inner
        self.to_q = Dense(dim, inner)
        self.to_kv = Dense(dim, inner * 2)
        self.to_out = Dense(inner, dim)
        self.null_k = nn.Parameter(torch.empty(heads, dim_head))
        self.null_v = nn.Parameter(torch.empty(heads, dim_head))
        self.talking_heads = nn.Parameter(torch.empty(heads, heads))
        # the reference's talking heads are a Conv3d with its default bias
        self.talking_heads_b = nn.Parameter(torch.empty(heads))

    @torch.no_grad()
    def reset_parameters(self, generator):
        normal_(self.null_k, generator)
        normal_(self.null_v, generator)
        kaiming_uniform_(self.talking_heads, generator, self.heads)
        self.talking_heads_b.zero_()

    def forward(self, seq, context, *, mask=None, context_mask=None, seed=None, **_):
        """seq (b, 1 + n, dim) and context (b, 1 + nc, dim), each with its
        start token first; masks (b, 1 + n) and (b, 1 + nc) bool."""
        b, seq_total, _ = seq.shape
        cs, ccs = self.chunk_size, self.context_chunk_size
        h, dh = self.heads, self.dim_head
        seq_len, context_len = seq_total - 1, context.shape[1] - 1

        # alignment padding: the context moves right by ccs - 1 tokens
        x = F.pad(seq[:, 1:], (0, 0, 0, padding_to_multiple_of(seq_len, cs)))
        left, right = ccs - 1, padding_to_multiple_of(context_len, ccs)
        ctx = F.pad(context, (0, 0, left, right))
        ctx_valid = torch.ones(context.shape[:2], dtype=torch.bool, device=seq.device)
        if context_mask is not None:
            ctx_valid = ctx_valid & context_mask
        ctx_valid = F.pad(ctx_valid, (left, right), value=False)

        n_chunks, n_ctx_chunks = x.shape[1] // cs, ctx.shape[1] // ccs
        x = x.reshape(b, n_chunks, cs, -1)
        ctx = ctx.reshape(b, n_ctx_chunks, ccs, -1)
        ctx_valid = ctx_valid.reshape(b, n_ctx_chunks, ccs)
        # chunks past the context's get a zero output
        used = min(n_chunks, n_ctx_chunks)
        x, ctx, ctx_valid = x[:, :used], ctx[:, :used], ctx_valid[:, :used]
        if used == 0:
            return torch.zeros_like(seq)

        def heads_of(t):  # (b, n, c, h * dh) -> (b, h, n, c, dh)
            return t.reshape(*t.shape[:3], h, dh).permute(0, 3, 1, 2, 4)

        q = heads_of(self.to_q(x)) * dh**-0.5
        k, v = (heads_of(t) for t in self.to_kv(ctx).chunk(2, dim=-1))
        null = (b, h, used, 1, dh)
        k = torch.cat([self.null_k.to(k.dtype)[None, :, None, None].expand(null), k], dim=-2)
        v = torch.cat([self.null_v.to(v.dtype)[None, :, None, None].expand(null), v], dim=-2)

        sim = torch.einsum("bhncd,bhnjd->bhncj", q, k)
        cvalid = F.pad(ctx_valid, (1, 0), value=True)
        sim = masked_fill(sim, ~cvalid[:, None, :, None, :], max_neg_value(sim.dtype))
        attn = self._dropout(stable_softmax(sim), seed)
        attn = torch.einsum("bhncj,gh->bgncj", attn, self.talking_heads.to(attn.dtype))
        attn = attn + self.talking_heads_b.to(attn.dtype)[None, :, None, None, None]

        out = torch.einsum("bhncj,bhnjd->bhncd", attn.to(v.dtype), v)
        out = self.to_out(out.permute(0, 2, 3, 1, 4).reshape(b, used * cs, self.inner_dim))
        # back to the sequence's layout: the start token's row first, zeros
        # for chunks without context, cropped or padded to the input length
        out = F.pad(out, (0, 0, 1, 0))[:, :seq_total]
        out = F.pad(out, (0, 0, 0, seq_total - out.shape[1]))
        if mask is not None:
            out = out.masked_fill(~mask[:, :, None], 0.0)
        return out

    def _dropout(self, attn, seed):
        """Dropout of the (b, h, chunks, cs, 1 + ccs) probabilities: query
        chunk*cs + i, key NULL_KEY, then chunk*ccs + j."""
        if seed is None or self.dropout <= 0:
            return attn
        b, h, n, cs, slots = attn.shape
        dev = attn.device
        ctx_ids = torch.arange(n * (slots - 1), device=dev).view(n, 1, slots - 1)
        k_ids = torch.cat([torch.full((n, 1, 1), NULL_KEY, device=dev), ctx_ids], dim=-1)
        k_ids = k_ids.expand(n, cs, slots).reshape(n * cs, slots)
        flat = attn.reshape(b, h, n * cs, slots)
        out = dropout(flat, self.dropout, seed, ids=(torch.arange(n * cs, device=dev), k_ids))
        return out.view(attn.shape)
