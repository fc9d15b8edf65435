"""VQGAN-VAE, the discrete visual codec: its inference path.

Counterpart of ``VQGanVAE`` in ``nuwa_tpu/vqgan_vae.py``: the conv encoder
and decoder with their res blocks (``ResBlock``, ``GLUResBlock``) and
cosine-sim attention (``VQGanAttention`` with ``ContinuousPositionBias``),
the vector quantizer (``nuwa_tpu_torch.vq``), and the public ``encode``,
``decode``, ``codebook``, ``get_video_indices`` and
``codebook_indices_to_video``. The public API is channels-first, as the JAX
package's; inside, the port computes in NCHW (the JAX package in NHWC).
The discriminator, the GAN, perceptual and gradient-penalty losses and
``forward`` belong to the codec's training.

Parameters mirror the JAX ``params`` tree (``enc``, ``dec``, ``vq``); the
quantizer's codebook state is in buffers (``vq.embed`` ...), the JAX
``state["vq"]``. ``nuwa_tpu_torch.convert.load_vqgan_vae`` loads both.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .core.layers import (
    Conv2d, Dense, GroupNorm, LayerNormChan, init_weights_, leaky_relu,
    upsample_bilinear,
)
from .ops.utils import batch_process, resolve_device, stable_softmax
from .vq import VectorQuantizeEMA, l2norm


class ResBlock(nn.Module):
    """conv3-GN-lrelu twice, then conv1, residual."""

    def __init__(self, chan, groups=16):
        super().__init__()
        self.c1 = Conv2d(chan, chan, (3, 3))
        self.n1 = GroupNorm(chan, groups)
        self.c2 = Conv2d(chan, chan, (3, 3))
        self.n2 = GroupNorm(chan, groups)
        self.c3 = Conv2d(chan, chan, (1, 1))

    def forward(self, x):
        h = leaky_relu(self.n1(self.c1(x)))
        h = leaky_relu(self.n2(self.c2(h)))
        return self.c3(h) + x


class GLUResBlock(nn.Module):
    """conv3-GLU-GN twice, then conv1, residual."""

    def __init__(self, chan, groups=16):
        super().__init__()
        self.c1 = Conv2d(chan, chan * 2, (3, 3))
        self.n1 = GroupNorm(chan, groups)
        self.c2 = Conv2d(chan, chan * 2, (3, 3))
        self.n2 = GroupNorm(chan, groups)
        self.c3 = Conv2d(chan, chan, (1, 1))

    def forward(self, x):
        h = self.n1(F.glu(self.c1(x), dim=1))
        h = self.n2(F.glu(self.c2(h), dim=1))
        return self.c3(h) + x


class ContinuousPositionBias(nn.Module):
    """MLP over signed-log relative coordinates (SwinV2): (heads, i, j)."""

    def __init__(self, dim, heads, layers=2):
        super().__init__()
        self.depth = layers
        self.add_module("in", Dense(2, dim, use_bias=True))
        for i in range(layers - 1):
            self.add_module(f"mid{i}", Dense(dim, dim, use_bias=True))
        self.out = Dense(dim, heads, use_bias=True)

    def forward(self, fmap_size):
        pos = np.arange(fmap_size)
        grid = np.stack(np.meshgrid(pos, pos, indexing="ij"), axis=-1).reshape(-1, 2)
        rel = grid[:, None, :] - grid[None, :, :]
        rel = np.sign(rel) * np.log(np.abs(rel) + 1)
        rel = torch.as_tensor(rel, dtype=torch.float32, device=self.out.w.device)
        h = leaky_relu(getattr(self, "in")(rel))
        for i in range(self.depth - 1):
            h = leaky_relu(getattr(self, f"mid{i}")(h))
        return self.out(h).permute(2, 0, 1)


class VQGanAttention(nn.Module):
    """Cosine-sim attention over a conv map with a learned log-scale
    temperature and the continuous position bias, post-norm, residual."""

    def __init__(self, dim, dim_head=64, heads=8):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.scale = nn.Parameter(torch.empty(heads))
        self.to_qkv = Conv2d(dim, inner * 3, (1, 1), use_bias=False)
        self.to_out = Conv2d(inner, dim, (1, 1))
        self.cpb = ContinuousPositionBias(dim // 4, heads)
        self.post_norm = LayerNormChan(dim)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.scale.fill_(math.log(0.01))

    def forward(self, x):
        b, _, hh, ww = x.shape
        h, dh = self.heads, self.dim_head
        # channel c of q, k and v is head c // dh, feature c % dh
        q, k, v = (t.reshape(b, h, dh, hh * ww).transpose(2, 3)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        q, k = l2norm(q), l2norm(k)
        sim = torch.einsum("bhid,bhjd->bhij", q, k)
        sim = sim * self.scale.exp()[None, :, None, None]
        sim = sim + self.cpb(hh)[None]
        attn = stable_softmax(sim)
        out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)
        out = out.transpose(2, 3).reshape(b, h * dh, hh, ww)
        return self.post_norm(self.to_out(out)) + x


class VQGanVAE(nn.Module):
    """The codec's inference path, configured as the JAX package's
    ``VQGanVAE``. Weights are random from ``seed`` unless loaded; the model
    lives on ``device`` (``cuda`` unless the caller names another)."""

    def __init__(self, *, dim, image_size, channels=3, num_layers=4, layer_mults=None,
                 num_resnet_blocks=1, vq_codebook_dim=256, vq_codebook_size=512,
                 vq_commitment_weight=1.0, vq_kmeans_init=True, vq_use_cosine_sim=True,
                 vq_orthogonal_reg_weight=0.0, use_attn=True, attn_dim_head=64,
                 attn_heads=8, resnet_groups=16, first_conv_kernel_size=5,
                 use_vgg_and_gan=True, compute_dtype=None, device=None, seed=0):
        super().__init__()
        del use_vgg_and_gan  # the discriminator belongs to the codec's training
        device = resolve_device(device)
        self.dim, self.image_size, self.channels = dim, image_size, channels
        self.num_layers = num_layers
        self.dtype = getattr(torch, compute_dtype) if compute_dtype else None
        mults = layer_mults or tuple(2**i for i in range(num_layers))
        if len(mults) != num_layers:
            raise ValueError("layer_mults needs one entry per layer")
        dims = (dim, *(dim * m for m in mults))
        res = num_resnet_blocks
        res = tuple(res) if isinstance(res, (tuple, list)) else (0,) * (num_layers - 1) + (res,)
        attn = use_attn
        attn = tuple(attn) if isinstance(attn, (tuple, list)) else (False,) * (num_layers - 1) + (attn,)
        if len(res) != num_layers or len(attn) != num_layers:
            raise ValueError("per-layer options need one entry per layer")
        self.attn_per_layer = attn
        self.codebook_size = vq_codebook_size
        self.fmap_size = image_size // 2**num_layers

        def attention(d):
            return VQGanAttention(d, dim_head=attn_dim_head, heads=attn_heads)

        with torch.device(device):
            k = first_conv_kernel_size
            enc = {"first": Conv2d(channels, dim, (k, k))}
            dec = {"last": Conv2d(dim, channels, (1, 1))}
            for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
                enc[f"down{i}"] = Conv2d(din, dout, (4, 4), stride=(2, 2),
                                         padding=((1, 1), (1, 1)))
                dec[f"up{i}"] = Conv2d(dout, din, (3, 3))
                enc[f"res{i}"] = nn.ModuleList(
                    [ResBlock(dout, resnet_groups) for _ in range(res[i])])
                dec[f"res{i}"] = nn.ModuleList(
                    [GLUResBlock(dout, resnet_groups) for _ in range(res[i])])
                if attn[i]:
                    enc[f"attn{i}"] = attention(dout)
                    dec[f"attn{i}"] = attention(dout)
            self.enc = nn.ModuleDict(enc)
            self.dec = nn.ModuleDict(dec)
            self.vq = VectorQuantizeEMA(
                dims[-1], vq_codebook_size, codebook_dim=vq_codebook_dim,
                commitment_weight=vq_commitment_weight, kmeans_init=vq_kmeans_init,
                cosine_sim=vq_use_cosine_sim,
                orthogonal_reg_weight=vq_orthogonal_reg_weight,
            )
        init_weights_(self, seed)

    @property
    def device(self):
        return self.vq.embed.device

    def _encode_fmap(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.enc["first"](x)
        for i in range(self.num_layers):
            x = leaky_relu(self.enc[f"down{i}"](x))
            for block in self.enc[f"res{i}"]:
                x = block(x)
            if self.attn_per_layer[i]:
                x = self.enc[f"attn{i}"](x)
        return x

    def _decode_fmap(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in reversed(range(self.num_layers)):
            for block in reversed(self.dec[f"res{i}"]):
                x = block(x)
            if self.attn_per_layer[i]:
                x = self.dec[f"attn{i}"](x)
            x = leaky_relu(self.dec[f"up{i}"](upsample_bilinear(x)))
        return self.dec["last"](x)

    def encode(self, img):
        """img (b, c, h, w) -> (quantized fmap (b, c', h', w'), indices
        (b, h' * w'), commit loss). The quantizer runs in fp32."""
        x = self._encode_fmap(torch.as_tensor(img, device=self.device)).float()
        quant, indices, commit = self.vq(x.permute(0, 2, 3, 1))
        return quant.permute(0, 3, 1, 2), indices.reshape(x.shape[0], -1), commit

    def decode(self, fmap):
        """fmap (b, c', h', w') -> pixels (b, c, h, w) in fp32."""
        return self._decode_fmap(fmap).float()

    def codebook(self):
        return self.vq.codebook()

    def get_video_indices(self, video):
        """video (b, f, c, h, w) -> codebook indices (b, f, h' * w')."""
        b, f = video.shape[:2]
        video = torch.as_tensor(video, device=self.device)
        _, indices, _ = self.encode(video.reshape(b * f, *video.shape[2:]))
        return indices.reshape(b, f, -1)

    def codebook_indices_to_video(self, indices, *, decode_chunks=None):
        """indices (b, n) -> video (b, n // (h' * w'), c, h, w)."""
        b, n = indices.shape
        fs = self.fmap_size
        f = n // (fs * fs)
        codes = self.codebook()[indices.to(self.device)]
        codes = codes.reshape(b * f, fs, fs, -1).permute(0, 3, 1, 2)
        if decode_chunks is None:
            video = self.decode(codes)
        else:
            video = batch_process(codes, self.decode, chunks=decode_chunks)
        return video.reshape(b, f, *video.shape[1:])
