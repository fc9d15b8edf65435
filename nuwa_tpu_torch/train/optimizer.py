"""Optimizer: AdamW with weight decay only on parameters of ndim >= 2, Adam
when wd == 0, and global-norm clipping as the JAX package's optax chain
does it.

Counterpart of ``nuwa_tpu/train/optimizer.py``. ``torch.optim`` applies the
update (the JAX package leaves it to XLA; no kernel of its own is involved).
The JAX package's frozen-subtree mask is ``requires_grad`` here:
``get_optimizer`` leaves out the parameters that do not require grad, such
as NUWASketch's frozen VAEs. ``trainable_mask`` gives the JAX mask's
answer by name.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.tp import shard_of


def weight_decay_mask(params):
    """True for the parameters that receive weight decay (ndim >= 2)."""
    return [p.ndim >= 2 for p in params]


def trainable_mask(module, frozen_keys=("vae", "sketch_vae")):
    """{name: bool} over ``module.named_parameters()``: False under a
    submodule named in ``frozen_keys`` (the embedded frozen VAE copies), as
    the JAX mask marks every key of its params tree under such a key."""
    return {name: not any(part in frozen_keys for part in name.split(".")[:-1])
            for name, _ in module.named_parameters()}


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
def clip_by_global_norm_(params, max_norm, stage_group=None, staged=()):
    """Scale the gradients in place so that their global norm is at most
    ``max_norm``, as ``optax.clip_by_global_norm``: unchanged when the norm is
    below it, else ``g / norm * max_norm``. (``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead.) Returns the norm before clipping. Gradients of
    parameters split over the model axis (``parallel.shard_params``) are
    parts: their sum of squares is all-reduced over the axis. With
    ``stage_group``, the parameters in ``staged`` are this rank's pipeline
    stage's (``parallel.pipeline.StageLayout``), each held by one rank of
    the group: their sum of squares is all-reduced over it. Each replicated
    gradient counts once, so the norm is the whole model's on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    staged = {id(p) for p in staged} if stage_group is not None else set()
    split = [p for p in params if p.grad is not None and shard_of(p) is not None
             and id(p) not in staged]
    if not split and not staged:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    else:
        def squares(gs):
            if not gs:
                return torch.zeros((), device=grads[0].device)
            return torch.stack([torch.linalg.vector_norm(g) for g in gs]).square().sum()

        total = squares([p.grad for p in split])
        if split:
            dist.all_reduce(total, group=shard_of(split[0]).group)
        if staged:
            stage = squares([p.grad for p in params if p.grad is not None and id(p) in staged])
            dist.all_reduce(stage, group=stage_group)
            total = total + stage
        whole = [p.grad for p in params if p.grad is not None and shard_of(p) is None
                 and id(p) not in staged]
        norm = (total + squares(whole)).sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
