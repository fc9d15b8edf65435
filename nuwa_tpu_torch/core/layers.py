"""Leaf layers: Dense, Embedding, LayerNorm, StableLayerNorm.

Counterpart of ``nuwa_tpu/core/layers.py``. Parameters keep the JAX
package's names and layouts (``Dense.w`` is ``(din, dout)``), so
``nuwa_tpu_torch.convert`` loads a JAX params pytree by path. Parameters are
fp32; matmuls run in the activations' dtype, norms in fp32 — as in the JAX
package.

Every module that owns parameters has ``reset_parameters(generator)``;
``init_weights_`` runs them all from one seeded CPU generator, so a model
gets the same weights on every device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def normal_(param, generator, std=1.0):
    param.copy_(torch.empty(param.shape).normal_(0.0, std, generator=generator))


@torch.no_grad()
def uniform_(param, generator, bound):
    param.copy_(torch.empty(param.shape).uniform_(-bound, bound, generator=generator))


def kaiming_uniform_(param, generator, fan_in):
    """torch-style kaiming uniform (a=sqrt(5)), as nn.Linear uses."""
    uniform_(param, generator, math.sqrt(1.0 / fan_in) * math.sqrt(3.0))


def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights for every parameter of ``model`` from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


class Dense(nn.Module):
    def __init__(self, din, dout, use_bias=False):
        super().__init__()
        self.din = din
        self.w = nn.Parameter(torch.empty(din, dout))
        self.b = nn.Parameter(torch.empty(dout)) if use_bias else None

    def reset_parameters(self, generator):
        kaiming_uniform_(self.w, generator, self.din)
        if self.b is not None:
            uniform_(self.b, generator, 1.0 / math.sqrt(self.din))

    def forward(self, x):
        out = x @ self.w.to(x.dtype)
        if self.b is not None:
            out = out + self.b.to(x.dtype)
        return out


class Embedding(nn.Module):
    """Token embedding. Under ``train=True`` only ``frac_gradient`` of the
    gradient reaches the table (the CogView stability trick); the value is
    unchanged. Scaling after the gather gives the table the same gradient as
    the JAX package's scaling of the whole table, without a copy of it."""

    def __init__(self, num_embeddings, dim, frac_gradient=1.0):
        super().__init__()
        self.frac_gradient = frac_gradient
        self.table = nn.Parameter(torch.empty(num_embeddings, dim))

    def reset_parameters(self, generator):
        normal_(self.table, generator)

    def forward(self, ids, *, train=False):
        out = self.table[ids]
        if train and self.frac_gradient < 1.0:
            f = self.frac_gradient
            out = out * f + out.detach() * (1.0 - f)
        return out


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.g = nn.Parameter(torch.empty(dim))
        self.b = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x):
        out = F.layer_norm(x.float(), x.shape[-1:], self.g, self.b, 1e-5)
        return out.to(x.dtype)


class StableLayerNorm(nn.Module):
    """Divide by the row's amax, held constant for the gradient, before the
    LayerNorm (CogView)."""

    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(dim)

    def forward(self, x):
        amax = x.detach().abs().amax(dim=-1, keepdim=True)
        return self.norm(x / amax.clamp_min(1e-6))
