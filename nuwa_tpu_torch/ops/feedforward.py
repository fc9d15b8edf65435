"""GEGLU feed-forward. Counterpart of ``nuwa_tpu/ops/feedforward.py``:
dropout after the GEGLU, before ``w_out``, its mask keyed by (seed, flat
element index); no sequence chunking (``chunk_size``: no caller on the
ported paths sets it)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..core.layers import Dense, dropout


def geglu(x):
    x, gate = x.chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, dropout=0.0):
        super().__init__()
        inner = (dim * 4 * 2) // 3  # mult 4: no JAX caller sets another
        self.dropout = dropout
        self.w_in = Dense(dim, inner * 2)
        self.w_out = Dense(inner, dim)

    def forward(self, x, *, seed=None):
        return self.w_out(dropout(geglu(self.w_in(x)), self.dropout, seed))
