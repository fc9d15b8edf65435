"""VGG16 perceptual features.

Counterpart of ``nuwa_tpu/perceptual.py``: ``VGG16Features`` (torchvision's
VGG16 conv plan, the adaptive pool to 7 x 7 and the first two classifier
layers), its ``features_multiscale`` (the post-ReLU activations of some conv
layers), the LPIPS-style ``random_perceptual_loss`` over them, and
``load_torch_vgg16_state_dict``. The weights are random from a seed unless a
torchvision ``vgg16`` state dict is loaded; the repo holds none.

The pool to 7 x 7 is ``jax.image.resize(..., "linear")``, as in the JAX
package: a triangle filter with half-pixel centres, widened by the scale
when it shrinks (anti-aliased, 8 x 8 at 256 px) and not when it grows (2 x 2
at 64 px). ``_resize_weights`` builds its (in, out) matrix in numpy, the
same formula as JAX's ``scale_and_translate``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .core.layers import Conv2d, Dense

# torchvision vgg16 conv plan: (out_channels per conv, 'M' = maxpool)
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")
POOL = 7


def _resize_weights(size_in, size_out):
    """(size_in, size_out) weights of a linear resize along one axis, as
    ``jax.image.resize(method="linear", antialias=True)`` computes them."""
    scale = size_out / size_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(size_out) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(size_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_linear(x, size):
    """NCHW ``x`` resized to ``size`` x ``size``, as ``jax.image.resize``'s
    linear method."""
    wh = torch.from_numpy(_resize_weights(x.shape[2], size)).to(x.device, x.dtype)
    ww = torch.from_numpy(_resize_weights(x.shape[3], size)).to(x.device, x.dtype)
    return torch.einsum("bchw,hi,wj->bcij", x, wh, ww)


class VGG16Features(nn.Module):
    """x (b, 3, h, w) in [0, 1]-ish -> (b, 4096) features."""

    def __init__(self, channels=3, feature_dim=4096):
        super().__init__()
        convs, cin = [], channels
        for spec in _VGG16_PLAN:
            if spec != "M":
                convs.append(Conv2d(cin, spec, (3, 3)))
                cin = spec
        self.convs = nn.ModuleList(convs)
        self.fc1 = Dense(512 * POOL * POOL, feature_dim, use_bias=True)
        self.fc2 = Dense(feature_dim, feature_dim, use_bias=True)

    def _layers(self, x):
        """(conv index, post-ReLU activation) of each conv, in order."""
        convs = iter(enumerate(self.convs))
        for spec in _VGG16_PLAN:
            if spec == "M":
                x = F.max_pool2d(x, 2)
                continue
            i, conv = next(convs)
            x = F.relu(conv(x))
            yield i, x
        yield None, x

    def forward(self, x):
        for _, x in self._layers(x):  # the last is the output of the fifth pool
            pass
        if x.shape[2:] != (POOL, POOL):
            x = resize_linear(x, POOL)
        # NCHW flattens in torch's CHW order, as the JAX package's transpose does
        x = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return F.relu(self.fc2(x))

    def features_multiscale(self, x, layers=(1, 3, 6, 9, 12)):
        """The post-ReLU activations of the conv layers ``layers``."""
        feats = []
        for i, x in self._layers(x):
            if i in layers:
                feats.append(x)
                if i >= max(layers):
                    break
        return feats


def random_perceptual_loss(vgg, img, recon, layers=(1, 3, 6, 9, 12)):
    """LPIPS-style distance over ``vgg.features_multiscale``: features
    l2-normalised over the channels at each position, the squared
    difference summed over channels and averaged over positions, the layers
    weighted equally (the JAX package's no-download perceptual mode)."""
    fa = vgg.features_multiscale(img, layers)
    fb = vgg.features_multiscale(recon, layers)

    def unit(f):
        return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)

    loss = 0.0
    for a, b in zip(fa, fb):
        loss = loss + ((unit(a) - unit(b)) ** 2).sum(dim=1).mean()
    return loss / len(fa)


def load_torch_vgg16_state_dict(state_dict):
    """A torchvision ``vgg16`` state dict as a ``VGG16Features`` state dict
    (``vgg.load_state_dict(...)``): torchvision's conv kernels are OIHW, as
    the port's, so only the names change; its linears store (out, in), the
    port's ``Dense`` (in, out)."""
    out, i = {}, 0
    for k in range(41):
        if f"features.{k}.weight" in state_dict:
            out[f"convs.{i}.w"] = state_dict[f"features.{k}.weight"]
            out[f"convs.{i}.b"] = state_dict[f"features.{k}.bias"]
            i += 1
    for j, k in ((1, 0), (2, 3)):
        out[f"fc{j}.w"] = torch.as_tensor(state_dict[f"classifier.{k}.weight"]).T
        out[f"fc{j}.b"] = state_dict[f"classifier.{k}.bias"]
    return {name: torch.as_tensor(t) for name, t in out.items()}
