"""Optimizer: AdamW with weight decay only on parameters of ndim >= 2, Adam
when wd == 0, and global-norm clipping as the JAX package's optax chain
does it.

Counterpart of ``nuwa_tpu/train/optimizer.py``. ``torch.optim`` applies the
update (the JAX package leaves it to XLA; no kernel of its own is involved).
The JAX package's frozen-subtree mask is ``requires_grad`` here:
``get_optimizer`` leaves out the parameters that do not require grad, such
as NUWASketch's frozen VAEs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.tp import shard_of


def weight_decay_mask(params):
    """True for the parameters that receive weight decay (ndim >= 2)."""
    return [p.ndim >= 2 for p in params]


def get_optimizer(params, lr=3e-4, wd=1e-1):
    """AdamW over ``params`` with decay masked by ``weight_decay_mask``, or
    Adam when ``wd == 0``. torch's AdamW decays ``p`` by ``lr * wd * p`` beside
    the Adam step, the same update as optax's ``adamw``."""
    params = [p for p in params if p.requires_grad]
    if wd == 0:
        return torch.optim.Adam(params, lr=lr)
    mask = weight_decay_mask(params)
    groups = [
        {"params": [p for p, m in zip(params, mask) if m], "weight_decay": wd},
        {"params": [p for p, m in zip(params, mask) if not m], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW([g for g in groups if g["params"]], lr=lr)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm):
    """Scale the gradients in place so that their global norm is at most
    ``max_norm``, as ``optax.clip_by_global_norm``: unchanged when the norm is
    below it, else ``g / norm * max_norm``. (``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead.) Returns the norm before clipping. Gradients of
    parameters split over the model axis (``parallel.shard_params``) are
    parts: their sum of squares is all-reduced over the axis, and each
    replicated gradient counts once, so the norm is the whole model's."""
    grads = [p.grad for p in params if p.grad is not None]
    split = [p for p in params if p.grad is not None and shard_of(p) is not None]
    if not split:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    else:
        def squares(gs):
            return torch.stack([torch.linalg.vector_norm(g) for g in gs]).square().sum()

        total = squares([p.grad for p in split])
        dist.all_reduce(total, group=shard_of(split[0]).group)
        whole = [p.grad for p in params if p.grad is not None and shard_of(p) is None]
        norm = (total + squares(whole) if whole else total).sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
