"""Load a ``nuwa_tpu`` params pytree into the port's modules.

The port's parameter names mirror the JAX tree's paths (dict keys and list
indices joined with dots), the reversible layout included (a
``ReversibleTransformer``'s ``layers.<i>.f`` and ``layers.<i>.g`` are the JAX
couples' ``{"f", "g"}``), with one exception: ``ShiftVideo`` wraps its inner
block as a module, while the JAX tree puts the inner block's params in its
place. The pytree is passed as numpy arrays (or anything
``np.asarray`` takes); every leaf must be used exactly once and every
parameter of the module set exactly once.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .transformer import ShiftVideo


def flatten_params(tree, prefix=""):
    """{dotted path: leaf} of a nested dict / list pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for key, sub in items:
        out.update(flatten_params(sub, f"{prefix}{key}."))
    return out


def jax_path(module: nn.Module, name: str) -> str:
    """The JAX params path of the module parameter ``name``."""
    for prefix, sub in module.named_modules():
        if isinstance(sub, ShiftVideo) and name.startswith(prefix + ".inner."):
            return prefix + "." + name[len(prefix) + len(".inner.") :]
    return name


@torch.no_grad()
def load_jax_params(module: nn.Module, params) -> nn.Module:
    leaves = flatten_params(params)
    names = {jax_path(module, n): p for n, p in module.named_parameters()}
    missing = sorted(set(names) - set(leaves))
    unused = sorted(set(leaves) - set(names))
    if missing or unused:
        raise ValueError(f"params do not match: missing {missing}, unused {unused}")
    for path, param in names.items():
        value = torch.tensor(np.asarray(leaves[path], dtype=np.float32))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(param.shape)}")
        param.copy_(value)
    return module
