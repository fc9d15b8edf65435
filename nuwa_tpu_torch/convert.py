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

A tree from ``nuwa_tpu.utils.quantize.quantize_params_int8`` loads too: a
``Dense`` whose ``w`` comes with a ``w_scale`` is quantised first
(``Dense.quantize_``), and a bare logits head that comes as ``{"w",
"w_scale"}`` becomes an ``utils.quantize.Int8Weight``; then the int8
values and the scales are copied in. Optional leaves of a NUWA tree, such
as ``text_abs_pos_emb`` (``text_rotary_pos_emb=False``), load like any
other, the model having the module.

The pytree is passed as numpy arrays, torch tensors (a bfloat16 one from
``train.checkpoint`` among them) or anything ``np.asarray`` takes; every
leaf must be used exactly once and every parameter and buffer of the module
set exactly once.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .core.layers import Conv2d, Dense
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


def _quantize_like(module: nn.Module, leaves):
    """Quantise the Dense layers and logits heads of ``module`` that come
    int8 in ``leaves`` (a ``w_scale`` beside the weight)."""
    from .utils.quantize import quantize_head_

    names = _tensors(module)
    for path in leaves:
        if not path.endswith(".w_scale"):
            continue
        base = path[: -len(".w_scale")]
        if base + ".w" in names and isinstance(names[base + ".w"][1], Dense):
            names[base + ".w"][1].quantize_()
        elif base in names and isinstance(names[base][0], nn.Parameter):
            quantize_head_(*names[base][1:])


def _as_tensor(leaf, dtype):
    """A params leaf as a CPU tensor of ``dtype``: floats through fp32, as
    the JAX package's leaves are fp32 (or bf16, which fp32 holds exactly)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().to(dtype)
    arr = np.asarray(leaf)
    if dtype.is_floating_point:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.require(arr, requirements=("C", "W"))).to(dtype)


def jax_layout(owner, leaf, tensor):
    """A tensor of ``owner.<leaf>`` in the JAX package's layout: a
    ``Conv2d`` weight OIHW -> HWIO, anything else as it is."""
    return tensor.permute(2, 3, 1, 0) if isinstance(owner, Conv2d) and leaf == "w" else tensor


def port_layout(owner, leaf, value):
    """The inverse of ``jax_layout``: a JAX-layout value for ``owner.<leaf>``."""
    return value.permute(3, 2, 0, 1) if isinstance(owner, Conv2d) and leaf == "w" else value


@torch.no_grad()
def load_jax_params(module: nn.Module, params) -> nn.Module:
    leaves = flatten_params(params)
    _quantize_like(module, leaves)
    names = _tensors(module)
    missing = sorted(set(names) - set(leaves))
    unused = sorted(set(leaves) - set(names))
    if missing or unused:
        raise ValueError(f"params do not match: missing {missing}, unused {unused}")
    for path, (tensor, owner, leaf) in names.items():
        value = port_layout(owner, leaf, _as_tensor(leaves[path], tensor.dtype))
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(tensor.shape)}")
        tensor.copy_(value)
    return module


def export_jax_params(module: nn.Module) -> dict:
    """{dotted JAX path: tensor} of every parameter and buffer of
    ``module`` in the JAX package's layout (``Conv2d.w`` as HWIO): the
    leaves ``load_jax_params`` takes back. The tensors are detached views."""
    return {path: jax_layout(owner, leaf, tensor.detach())
            for path, (tensor, owner, leaf) in _tensors(module).items()}


def load_vqgan_vae(vae: VQGanVAE, params, state) -> VQGanVAE:
    """Load a JAX ``VQGanVAE``'s params and state into the port's: the
    discriminator and perceptual net are left out (``eval_params``), and the
    state may be wrapped (``{"vq": ...}``) or bare."""
    params = {k: v for k, v in params.items() if k not in ("discr", "vgg")}
    state = state if "vq" in state else {"vq": state}
    return load_jax_params(vae, {"params": params, "state": state})


def load_vqgan_vae_train(vae: VQGanVAE, gan, params, state):
    """Load a JAX training ``VQGanVAE`` (params with their ``discr`` and,
    for a VGG perceptual loss, ``vgg`` subtrees) into the port's codec and
    its ``GanParts`` (``vae.gan_parts()``, None for a codec without the
    GAN), plus the codebook state; every leaf is used once. Returns (vae,
    gan)."""
    load_vqgan_vae(vae, params, state)
    load_jax_params(gan if gan is not None else nn.Module(),
                    {k: v for k, v in params.items() if k in ("discr", "vgg")})
    return vae, gan


def load_nuwa_vae(nuwa, params):
    """Load only the codec of a JAX ``NUWA`` (or ``NUWAVideoAudio``) params
    tree, its ``"vae"`` subtree (``{"params": eval params, "state": codebook
    state}``), into ``nuwa.vae``; the rest of the model keeps its weights."""
    if getattr(nuwa, "vae", None) is None or "vae" not in params:
        raise ValueError("both the model and the params tree need a VAE")
    return load_vqgan_vae(nuwa.vae, params["vae"]["params"], params["vae"]["state"])


def load_nuwa_video_audio(model, params):
    """Load a JAX ``NUWAVideoAudio`` params tree into the port's, its
    ``"vae"`` subtree as for NUWA, float or int8 (``quantize_params_int8``);
    every leaf is used once."""
    return load_jax_params(model, params)
