"""GEGLU feed-forward with optional sequence chunking. Counterpart of
``nuwa_tpu/ops/feedforward.py``: dropout after the GEGLU, before ``w_out``,
its mask keyed by (seed, flat element index). With ``chunk_size`` a
(b, n, dim) input runs ``chunk_size`` positions at a time, which bounds the
(b, chunk, inner) activations, and each chunk's mask is keyed by its
elements' indices in the whole (b, n, inner) tensor, so chunked and
unchunked training drop the same elements (the JAX package's per-chunk
keys draw other bits; see ``core.layers.dropout``), at the global rows of
a ``core.layers.RowSeed``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.layers import Dense, dropout, seed_parts


def geglu(x):
    x, gate = x.chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, dropout=0.0, chunk_size=None):
        super().__init__()
        inner = (dim * 4 * 2) // 3  # mult 4: no JAX caller sets another
        self.inner_dim = inner
        self.dropout = dropout
        self.chunk_size = chunk_size
        self.w_in = Dense(dim, inner * 2)
        self.w_out = Dense(inner, dim)

    def net(self, x, *, seed=None, index=None):
        """The unchunked feed-forward; ``index``: the flat indices of the
        GEGLU output's elements in the whole tensor, for the dropout mask."""
        return self.w_out(dropout(geglu(self.w_in(x)), self.dropout, seed, index=index))

    def forward(self, x, *, seed=None):
        c = self.chunk_size
        if c is None or x.ndim != 3 or x.shape[1] <= c:
            return self.net(x, seed=seed)
        b, n, _ = x.shape
        inner = self.inner_dim
        outs = []
        for start in range(0, n, c):
            xc = x[:, start:start + c]
            index = None
            if seed is not None and self.dropout > 0:
                row0 = seed_parts(seed)[1]
                rows = torch.arange(row0, row0 + b, device=x.device)[:, None, None] * (n * inner)
                cols = torch.arange(start, start + xc.shape[1], device=x.device)
                index = rows + cols[None, :, None] * inner + torch.arange(
                    inner, device=x.device)
            outs.append(self.net(xc, seed=seed, index=index))
        return torch.cat(outs, dim=1)
