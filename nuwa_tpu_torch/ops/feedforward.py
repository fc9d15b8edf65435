"""GEGLU feed-forward. Counterpart of ``nuwa_tpu/ops/feedforward.py``
(no dropout and no sequence chunking: no caller on the ported paths sets them)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..core.layers import Dense


def geglu(x):
    x, gate = x.chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        inner = (dim * 4 * 2) // 3  # mult 4: no JAX caller sets another
        self.w_in = Dense(dim, inner * 2)
        self.w_out = Dense(inner, dim)

    def forward(self, x):
        return self.w_out(geglu(self.w_in(x)))
