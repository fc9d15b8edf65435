"""Load a ``nuwa_tpu`` params pytree into the port's modules.

The port's parameter names mirror the JAX tree's paths (dict keys and list
indices joined with dots), the reversible layout included (a
``ReversibleTransformer``'s ``layers.<i>.f`` and ``layers.<i>.g`` are the JAX
couples' ``{"f", "g"}``), with these exceptions:

* ``ShiftVideo`` and ``ShiftAudio`` wrap their inner block as a module,
  while the JAX tree puts the inner block's params in its place;
* a ``VQGanVAE``'s tree is ``{"params": ..., "state": ...}``, the form a
  ``NUWA`` tree holds under ``"vae"`` and a ``NUWASketch`` tree under
  ``"vae"`` and ``"sketch_vae"``: its parameters come from ``params`` and
  its quantizer's buffers (``vq.embed`` ...) from ``state["vq"]`` (a
  ``NUWAVideoAudio`` tree holds it under ``"vae"`` too);
* ``Conv2d.w`` is OIHW in the port and HWIO in the JAX package, so it is
  transposed on the way in.

The pytree is passed as numpy arrays (or anything ``np.asarray`` takes);
every leaf must be used exactly once and every parameter and buffer of the
module set exactly once.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .core.layers import Conv2d
from .transformer import ShiftAudio, ShiftVideo
from .vqgan_vae import VQGanVAE


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


def jax_path(module: nn.Module, name: str, buffer: bool = False) -> str:
    """The JAX params path of the module parameter (or buffer) ``name``."""
    for prefix, sub in module.named_modules():
        head = prefix + "." if prefix else ""
        if not name.startswith(head):
            continue
        rest = name[len(head):]
        if isinstance(sub, VQGanVAE):
            return head + ("state." if buffer else "params.") + rest
        if isinstance(sub, (ShiftVideo, ShiftAudio)) and rest.startswith("inner."):
            return head + rest[len("inner."):]
    return name


def _tensors(module: nn.Module):
    """{JAX path: (tensor, its module, its name there)} of every parameter
    and buffer."""
    out = {}
    for buffer, named in ((False, module.named_parameters()), (True, module.named_buffers())):
        for name, tensor in named:
            owner, _, leaf = name.rpartition(".")
            out[jax_path(module, name, buffer)] = (tensor, module.get_submodule(owner), leaf)
    return out


@torch.no_grad()
def load_jax_params(module: nn.Module, params) -> nn.Module:
    leaves = flatten_params(params)
    names = _tensors(module)
    missing = sorted(set(names) - set(leaves))
    unused = sorted(set(leaves) - set(names))
    if missing or unused:
        raise ValueError(f"params do not match: missing {missing}, unused {unused}")
    for path, (tensor, owner, leaf) in names.items():
        value = torch.tensor(np.asarray(leaves[path], dtype=np.float32))
        if isinstance(owner, Conv2d) and leaf == "w":
            value = value.permute(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(tensor.shape)}")
        tensor.copy_(value)
    return module


def load_vqgan_vae(vae: VQGanVAE, params, state) -> VQGanVAE:
    """Load a JAX ``VQGanVAE``'s params and state into the port's: the
    discriminator and perceptual net are left out (``eval_params``), and the
    state may be wrapped (``{"vq": ...}``) or bare."""
    params = {k: v for k, v in params.items() if k not in ("discr", "vgg")}
    state = state if "vq" in state else {"vq": state}
    return load_jax_params(vae, {"params": params, "state": state})


def load_nuwa_vae(nuwa, params):
    """Load only the codec of a JAX ``NUWA`` (or ``NUWAVideoAudio``) params
    tree, its ``"vae"`` subtree (``{"params": eval params, "state": codebook
    state}``), into ``nuwa.vae``; the rest of the model keeps its weights."""
    if getattr(nuwa, "vae", None) is None or "vae" not in params:
        raise ValueError("both the model and the params tree need a VAE")
    return load_vqgan_vae(nuwa.vae, params["vae"]["params"], params["vae"]["state"])


def load_nuwa_video_audio(model, params):
    """Load a JAX ``NUWAVideoAudio`` params tree into the port's, its
    ``"vae"`` subtree as for NUWA. The tree is float (an int8 tree from
    ``nuwa_tpu.utils.quantize`` is not taken); every leaf is used once."""
    return load_jax_params(model, params)
