"""Sampling numerics. Counterpart of ``nuwa_tpu/ops/sampling.py``: a
``torch.Generator`` or injected noise takes the place of the JAX key."""
from __future__ import annotations

import torch


def gumbel_noise(shape, generator=None, device=None):
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    inner = -torch.log(u.clamp_min(1e-20))
    return -torch.log(inner.clamp_min(1e-20))


def gumbel_sample(logits, temperature=1.0, *, generator=None, noise=None):
    """Gumbel-max sampling over the last axis. ``noise`` (same shape as
    ``logits``) replaces the draw from ``generator`` when given."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    noised = logits.float() / max(float(temperature), 1e-10) + noise
    return noised.argmax(dim=-1)


def top_k_filter(logits, thres=0.5):
    """Keep the top ``k = max(int((1 - thres) * vocab), 1)`` logits (a static
    k, as in the JAX package) and set the rest to -inf."""
    k = max(int((1.0 - thres) * logits.shape[-1]), 1)
    kth = logits.topk(k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def prob_mask_like(shape, prob, *, generator=None, device=None):
    """Bernoulli(prob) boolean mask, drawn from ``generator``: the per-sample
    condition dropout of classifier-free guidance training."""
    return torch.rand(shape, generator=generator, device=device) < prob
