"""Exponential moving average of parameters.

Counterpart of ``nuwa_tpu/train/ema.py``: a warmup gate
(``update_after_step``) and an update stride (``update_every``) on the
1-based step counted after the optimizer update, and the blend
``old * beta + (1 - beta) * new``. The averages are a dict of tensors
``{name: tensor}``; ``ema_update`` blends them in place.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def ema_init(params):
    """Copies (not aliases) of ``params``, a dict of tensors."""
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def ema_update(ema_params, params, step, *, beta=0.995, update_after_step=2000,
               update_every=10):
    """Blend ``params`` into ``ema_params`` in place when
    ``step > update_after_step and step % update_every == 0``; ``step`` is
    the 1-based step counter after the current optimizer update. Returns
    ``ema_params``."""
    if step > update_after_step and step % update_every == 0:
        for name, old in ema_params.items():
            old.copy_(old * beta + (1.0 - beta) * params[name].detach())
    return ema_params
