"""Dense multi-head attention with null key/value, talking heads, fp32
softmax, key masking and rotary embeddings: the text encoder's
self-attention and the video decoder's cross-attention.

Counterpart of ``nuwa_tpu/ops/attention.py`` without the causal mode (no
dense causal self-attention is on the ported path); heads are
``(b, h, n, d)``. Attention dropout comes after the talking-heads mix, as
there; its mask is keyed by (seed, batch row, head, query, key), the null
column's key id being -1 (``NULL_KEY``), the keys' their positions.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.layers import Dense, dropout, kaiming_uniform_, normal_
from .embeddings import apply_rotary_pos_emb
from .utils import masked_fill, max_neg_value, stable_softmax

NULL_KEY = -1  # the null key/value column's key id in the dropout mask


def split_heads(t, heads):
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def merge_heads(t):
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def talking_heads(attn, w):
    """Mix the normalised attention across heads (attn: b h i j)."""
    return torch.einsum("bhij,gh->bgij", attn, w.to(attn.dtype))


def key_ids(n, device):
    """(1, 1 + n) dropout key ids of [null, keys 0..n-1]."""
    return torch.arange(NULL_KEY, n, device=device)[None]


class Attention(nn.Module):
    def __init__(self, dim, heads=8, dim_head=64, dropout=0.0):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.dropout = dropout
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

    def _qkv(self, x, context=None, rotary_pos_emb=None):
        kv_input = context if context is not None else x
        q = self.to_q(x)
        k, v = self.to_kv(kv_input).chunk(2, dim=-1)
        q, k, v = (split_heads(t, self.heads) for t in (q, k, v))
        if context is None and rotary_pos_emb is not None:
            q = apply_rotary_pos_emb(rotary_pos_emb, q)
            k = apply_rotary_pos_emb(rotary_pos_emb, k)
            # the reference rotates v as well (rotary_values=True in the JAX
            # package, the only value any caller uses)
            v = apply_rotary_pos_emb(rotary_pos_emb, v)
        return q, k, v

    def forward(self, x, *, mask=None, context=None, context_mask=None,
                rotary_pos_emb=None, seed=None):
        b = x.shape[0]
        q, k, v = self._qkv(x, context, rotary_pos_emb)

        shape = (b, self.heads, 1, self.dim_head)
        k = torch.cat([self.null_k.to(k.dtype).expand(shape), k], dim=2)
        v = torch.cat([self.null_v.to(v.dtype).expand(shape), v], dim=2)

        sim = torch.einsum("bhid,bhjd->bhij", q * self.dim_head**-0.5, k)

        neg = max_neg_value(sim.dtype)
        key_mask = context_mask if context is not None else mask
        if key_mask is not None:
            key_mask = nn.functional.pad(key_mask, (1, 0), value=True)
            sim = masked_fill(sim, ~key_mask[:, None, None, :], neg)

        attn = talking_heads(stable_softmax(sim), self.talking_heads)
        n, m = sim.shape[-2], sim.shape[-1] - 1
        attn = dropout(attn, self.dropout, seed,
                       ids=(torch.arange(n, device=x.device), key_ids(m, x.device)))
        out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)
        return self.to_out(merge_heads(out))
