"""Leaf layers: Dense (with its int8 weight-only form), Embedding,
LayerNorm, StableLayerNorm, dropout and the seeds of a stack's layers, and
the codec's convolution layers (Conv2d, GroupNorm, LayerNormChan,
leaky_relu, the bilinear upsample).

Counterpart of ``nuwa_tpu/core/layers.py``. Parameters keep the JAX
package's names and layouts (``Dense.w`` is ``(din, dout)``), so
``nuwa_tpu_torch.convert`` loads a JAX params pytree by path, with one
exception: the JAX package's convolutions are NHWC with HWIO kernels, while
the port computes in NCHW and keeps ``Conv2d.w`` as OIHW (``convert``
transposes it). Parameters are fp32; matmuls and convolutions run in the
activations' dtype, norms in fp32 — as in the JAX package.

Every module that owns parameters has ``reset_parameters(generator)``;
``init_weights_`` runs them all from one seeded CPU generator, so a model
gets the same weights on every device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.nda import _avalanche, keep_mask, keep_params
from .tp import column, gathered_features, row, shard_of

_U32 = 0xFFFFFFFF
# the masks hash seed * 0x9E3779B9 + row (mod 2**32); the constant is odd, so
# it has an inverse and a row offset can be folded into the seed
_INV_GOLDEN = pow(0x9E3779B9, -1, 2**32)


@torch.no_grad()
def normal_(param, generator, std=1.0):
    param.copy_(torch.empty(param.shape).normal_(0.0, std, generator=generator))


@torch.no_grad()
def uniform_(param, generator, bound):
    param.copy_(torch.empty(param.shape).uniform_(-bound, bound, generator=generator))


def kaiming_uniform_(param, generator, fan_in):
    """torch-style kaiming uniform (a=sqrt(5)), as nn.Linear uses."""
    uniform_(param, generator, math.sqrt(1.0 / fan_in) * math.sqrt(3.0))


def init_weights_(model: nn.Module, seed: int, skip=()) -> nn.Module:
    """Random weights for every parameter of ``model`` from ``seed``, except
    in the submodules ``skip`` (which keep the weights they have)."""
    gen = torch.Generator().manual_seed(seed)
    kept = {id(m) for sub in skip for m in sub.modules()}
    for m in model.modules():
        if id(m) not in kept and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model


def dropout(x, rate, seed, ids=None, index=None):
    """Inverted dropout: the counterpart of ``dropout`` in
    ``nuwa_tpu/core/layers.py``. No seed, or a rate of 0, is the identity
    (inference), as a key of None is there. The mask is not drawn from a
    generator (JAX's ``jax.random.bernoulli`` bits cannot be drawn in torch,
    and ``torch.utils.checkpoint`` does not replay an explicit generator) but
    from the Sparse3DNA kernels' counter hash, ``kernels.nda.keep_mask``, so
    it is the same on every device and any recompute replays it. ``ids``:
    (q_ids (n,), k_ids (n, K) or (1, K)) for an x of (b, h, n, K), keying
    each element by (seed, batch row, head, query id, key id); None keys each
    element of an x of any shape by its flat index (the query id of batch row
    0 and head 0, key id 0), or by ``index``, an integer tensor of x's shape,
    where x is a slice of a larger tensor whose flat indices these are. The
    kept values are scaled by fp32 1 / keep. With a ``RowSeed`` batch row j
    is keyed as global row ``row0 + j``: through the seed with ``ids``,
    through the flat index of x's whole rows (x's leading axis being the
    batch's) without (``index`` is then the caller's to offset)."""
    if seed is None or rate <= 0:
        return x
    if ids is None:
        base, row0 = seed_parts(seed)
        if index is None:
            start = row0 * (x[0].numel() if x.ndim else 0)
            index = torch.arange(start, start + x.numel(), device=x.device)
        keep = keep_mask(base, rate, 1, 1, index.reshape(-1)).view(x.shape)
    else:
        keep = keep_mask(kernel_seed(seed), rate, x.shape[0], x.shape[1], *ids)
    return torch.where(keep, x * keep_params(rate)[1], 0.0)


@dataclass(frozen=True)
class RowSeed:
    """A dropout seed for a batch that is rows [row0, row0 + b) of a global
    batch (a rank's share under data parallelism): every mask keys batch
    row j as global row ``row0 + j``, so the rank drops what one process
    running the global batch drops. A model's forward makes it from its
    ``row0`` argument; ``split_seed`` passes the rows on to each layer."""

    seed: int
    row0: int


def with_row0(seed, row0):
    """``seed`` for a batch whose row 0 is global row ``row0``."""
    return seed if seed is None or not row0 else RowSeed(int(seed), int(row0))


def seed_parts(seed):
    """(the int seed or None, the global row of the batch's row 0)."""
    return (seed.seed, seed.row0) if isinstance(seed, RowSeed) else (seed, 0)


def kernel_seed(seed):
    """The int seed whose batch row j draws the mask that ``seed`` draws for
    global row ``row0 + j`` (the masks keyed by batch row: the Sparse3DNA
    kernels' and ``dropout``'s with ``ids``)."""
    base, row0 = seed_parts(seed)
    if base is None or row0 == 0:
        return base
    return (int(base) + row0 * _INV_GOLDEN) & _U32


def split_seed(seed, n):
    """One dropout seed for each of a stack's ``n`` layers: None each
    without a seed; the sequence itself when one is given (an int or None a
    layer: the tests pass the seeds that JAX's split keys draw); else n ints
    in [0, 2**31 - 1) hashed from the one int and the layer's index."""
    if isinstance(seed, RowSeed):
        return [with_row0(s, seed.row0) for s in split_seed(seed.seed, n)]
    if seed is None:
        return [None] * n
    if isinstance(seed, (list, tuple)):
        if len(seed) != n:
            raise ValueError(f"{len(seed)} seeds for {n} layers")
        return list(seed)
    base = (int(seed) * 0x9E3779B9) & _U32
    return [_avalanche((base + i + 0x85EBCA6B) & _U32) % (2**31 - 1) for i in range(n)]


class Dense(nn.Module):
    """``x @ w (+ b)`` in ``dtype`` (default: the activations' dtype). With
    ``quantize_()`` the weight becomes int8 with an fp32 scale per output
    channel (``w_scale``), both buffers, dequantised on the fly to the
    compute dtype as the JAX ``Dense`` does: a quantised Dense is for serving
    only. A ``w`` split over the model axis (``parallel.shard_params``; a
    quantised one with its ``w_scale``) runs column- or row-parallel
    (``core.tp``) and gives the whole output; the bias is whole on every
    rank and added after."""

    def __init__(self, din, dout, use_bias=False, dtype=None):
        super().__init__()
        self.din = din
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.w = nn.Parameter(torch.empty(din, dout))
        self.register_buffer("w_scale", None)
        self.b = nn.Parameter(torch.empty(dout)) if use_bias else None

    def reset_parameters(self, generator):
        kaiming_uniform_(self.w, generator, self.din)
        if self.b is not None:
            uniform_(self.b, generator, 1.0 / math.sqrt(self.din))

    @property
    def quantized(self):
        return self.w_scale is not None

    @torch.no_grad()
    def quantize_(self):
        """int8 weight-only in place; a quantised Dense stays as it is."""
        if not self.quantized:
            from ..utils.quantize import _quantize_w

            q, scale = _quantize_w(self.w)
            del self.w
            self.register_buffer("w", q)
            self.w_scale = scale
        return self

    def forward(self, x, w=None):
        """``w``: a tensor to read in place of the weight, split as it is
        (context parallelism passes one whose gradient is summed over the
        frame axis)."""
        dtype = self.dtype or x.dtype
        w = (self.w if w is None else w).to(dtype)
        if self.quantized:
            w = w * self.w_scale.to(dtype)
        shard = shard_of(self.w)
        if shard is None:
            out = x.to(dtype) @ w
        else:
            out = (column if shard.dim == 1 else row)(x.to(dtype), w, shard)
        if self.b is not None:
            out = out + self.b.to(dtype)
        return out


class Embedding(nn.Module):
    """Token embedding. Under ``train=True`` only ``frac_gradient`` of the
    gradient reaches the table (the CogView stability trick); the value is
    unchanged. Scaling after the gather gives the table the same gradient as
    the JAX package's scaling of the whole table, without a copy of it. A
    table split along its features over the model axis gathers them."""

    def __init__(self, num_embeddings, dim, frac_gradient=1.0):
        super().__init__()
        self.frac_gradient = frac_gradient
        self.table = nn.Parameter(torch.empty(num_embeddings, dim))

    def reset_parameters(self, generator):
        normal_(self.table, generator)

    def forward(self, ids, *, train=False):
        out = self.table[ids]
        shard = shard_of(self.table)
        if shard is not None:
            out = gathered_features(out, shard)
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


class GroupNorm(nn.Module):
    """GroupNorm over NCHW maps: each channel group over H, W and its
    channels, biased variance, in fp32."""

    def __init__(self, dim, groups=16, eps=1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.g = nn.Parameter(torch.empty(dim))
        self.b = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x):
        out = F.group_norm(x.float(), self.groups, self.g, self.b, self.eps)
        return out.to(x.dtype)


class LayerNormChan(nn.Module):
    """LayerNorm over the channels of an NCHW map only (biased variance)."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.empty(dim))
        self.b = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, unbiased=False, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        out = out * self.g[:, None, None] + self.b[:, None, None]
        return out.to(x.dtype)


def _same_padding(size, k, stride):
    """(low, high) padding of XLA's "SAME" for one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """2D convolution over NCHW inputs with an OIHW kernel. ``padding`` is
    XLA's "SAME" or "VALID" or ((top, bottom), (left, right)), as in the JAX
    package."""

    def __init__(self, cin, cout, kernel_size, stride=(1, 1), padding="SAME",
                 use_bias=True):
        super().__init__()
        self.cin, self.kernel_size, self.stride = cin, tuple(kernel_size), tuple(stride)
        self.padding = padding
        self.w = nn.Parameter(torch.empty(cout, cin, *self.kernel_size))
        self.b = nn.Parameter(torch.empty(cout)) if use_bias else None

    def reset_parameters(self, generator):
        fan_in = self.cin * self.kernel_size[0] * self.kernel_size[1]
        kaiming_uniform_(self.w, generator, fan_in)
        if self.b is not None:
            uniform_(self.b, generator, 1.0 / math.sqrt(fan_in))

    def _pads(self, x):
        if self.padding == "SAME":
            return tuple(_same_padding(n, k, s) for n, k, s in
                         zip(x.shape[2:], self.kernel_size, self.stride))
        if self.padding == "VALID":
            return ((0, 0), (0, 0))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x):
        (top, bottom), (left, right) = self._pads(x)
        padding = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        b = self.b.to(x.dtype) if self.b is not None else None
        return F.conv2d(x, self.w.to(x.dtype), b, self.stride, padding)


def leaky_relu(x, negative_slope=0.1):
    """The JAX package's slope, 0.1 (torch's default is 0.01)."""
    return F.leaky_relu(x, negative_slope)


def upsample_bilinear(x):
    """NCHW bilinear 2x upsample with half-pixel centres, clamped at the
    borders: ``jax.image.resize(method="bilinear")`` when doubling. Each
    output row (then column) blends its input row 0.75 with the clamped
    neighbour on its side 0.25; built from slices, sums and a stack, so its
    backward sums in a fixed order (F.interpolate's backward on CUDA adds
    with atomics, which makes training runs differ from run to run)."""
    for dim in (2, 3):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
        x = torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt], dim + 1).flatten(
            dim, dim + 1)
    return x
