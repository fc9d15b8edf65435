"""VQGAN-VAE, the discrete visual codec, and its training losses.

Counterpart of ``VQGanVAE`` in ``nuwa_tpu/vqgan_vae.py``: the conv encoder
and decoder with their res blocks (``ResBlock``, ``GLUResBlock``) and
cosine-sim attention (``VQGanAttention`` with ``ContinuousPositionBias``),
the vector quantizer (``nuwa_tpu_torch.vq``), and the public ``encode``,
``decode``, ``codebook``, ``get_video_indices`` and
``codebook_indices_to_video``. The public API is channels-first, as the JAX
package's; inside, the port computes in NCHW (the JAX package in NHWC).

Training: ``forward`` in the JAX package's modes (the reconstruction; the
generator loss with ``return_loss``, which updates the codebook; the
discriminator loss with ``return_discr_loss``, with the gradient penalty on
request), the hinge and BCE GAN losses, ``gradient_penalty``, the PatchGAN
``Discriminator`` and the adaptive weight of the GAN loss. The
discriminator and the perceptual net (``perceptual.VGG16Features``) are
not parameters of the codec: ``gan_parts`` builds them as a ``GanParts``
module (the JAX params' ``discr`` and ``vgg`` subtrees) and ``forward``
takes it as ``gan=``. So a codec holds exactly the JAX package's
``eval_params``, whichever ``use_vgg_and_gan`` says, and the models that
embed one hold no GAN.

Parameters mirror the JAX ``params`` tree (``enc``, ``dec``, ``vq``); the
quantizer's codebook state is in buffers (``vq.embed`` ...), the JAX
``state["vq"]``. ``nuwa_tpu_torch.convert.load_vqgan_vae`` loads both, and
with ``gan=`` the ``discr`` and ``vgg`` subtrees too.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .core.layers import (
    Conv2d, Dense, GroupNorm, LayerNormChan, dropout, init_weights_, leaky_relu,
    upsample_bilinear,
)
from .ops.utils import batch_process, resolve_device, stable_softmax
from .vq import VectorQuantizeEMA, l2norm

PERCEPTUAL = ("vgg", "random_vgg", "none")


def hinge_discr_loss(fake, real):
    return (F.relu(1 + fake) + F.relu(1 - real)).mean()


def hinge_gen_loss(fake):
    return -fake.mean()


def bce_discr_loss(fake, real):
    return (F.softplus(fake) + F.softplus(-real)).mean()


def bce_gen_loss(fake):
    return F.softplus(-fake).mean()


def gradient_penalty(images, discr_fn, weight=10.0):
    """(‖∂D/∂x‖₂ − 1)² averaged over the batch, times ``weight``: the
    gradient of the summed logits with respect to the images, with a graph
    (``create_graph``) so that the penalty itself has a gradient."""
    images = images.detach().requires_grad_(True)
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(discr_fn(images).sum(), images, create_graph=True)
    norms = torch.sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(dim=1) + 1e-12)
    return weight * ((norms - 1.0) ** 2).mean()


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

    def __init__(self, dim, dim_head=64, heads=8, dropout=0.0):
        super().__init__()
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        inner = heads * dim_head
        self.scale = nn.Parameter(torch.empty(heads))
        self.to_qkv = Conv2d(dim, inner * 3, (1, 1), use_bias=False)
        self.to_out = Conv2d(inner, dim, (1, 1))
        self.cpb = ContinuousPositionBias(dim // 4, heads)
        self.post_norm = LayerNormChan(dim)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.scale.fill_(math.log(0.01))

    def forward(self, x, seed=None):
        """``seed``: an int for the dropout mask (``core.layers.dropout``);
        None drops nothing. The codec passes none, as the JAX package's
        passes no key to its attention."""
        b, _, hh, ww = x.shape
        h, dh = self.heads, self.dim_head
        # channel c of q, k and v is head c // dh, feature c % dh
        q, k, v = (t.reshape(b, h, dh, hh * ww).transpose(2, 3)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        q, k = l2norm(q), l2norm(k)
        sim = torch.einsum("bhid,bhjd->bhij", q, k)
        sim = sim * self.scale.exp()[None, :, None, None]
        sim = sim + self.cpb(hh)[None]
        attn = dropout(stable_softmax(sim), self.dropout, seed)
        out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)
        out = out.transpose(2, 3).reshape(b, h * dh, hh, ww)
        return self.post_norm(self.to_out(out)) + x


class Discriminator(nn.Module):
    """PatchGAN-style conv stack: (b, c, h, w) -> logits (b, 1, h', w')."""

    def __init__(self, dims, channels=3, groups=16, init_kernel_size=5):
        super().__init__()
        k = init_kernel_size
        self.first = Conv2d(channels, dims[0], (k, k))
        self.downs = len(dims) - 1
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"down{i}", nn.ModuleDict({
                "conv": Conv2d(din, dout, (4, 4), stride=(2, 2), padding=((1, 1), (1, 1))),
                "norm": GroupNorm(dout, groups),
            }))
        self.head1 = Conv2d(dims[-1], dims[-1], (1, 1))
        self.head2 = Conv2d(dims[-1], 1, (4, 4), padding="VALID")

    def forward(self, x):
        x = leaky_relu(self.first(x))
        for i in range(self.downs):
            down = getattr(self, f"down{i}")
            x = leaky_relu(down["norm"](down["conv"](x)))
        return self.head2(leaky_relu(self.head1(x)))


class GanParts(nn.Module):
    """The parts of a codec that only its training holds: the
    discriminator (``discr``) and, for ``perceptual`` "vgg" or
    "random_vgg", the perceptual net (``vgg``); the JAX params' ``discr``
    and ``vgg`` subtrees. Built by ``VQGanVAE.gan_parts``."""

    def __init__(self, dims, channels, groups, perceptual):
        super().__init__()
        from .perceptual import VGG16Features

        self.discr = Discriminator(dims, channels=channels, groups=groups)
        self.vgg = VGG16Features(channels=3) if perceptual in ("vgg", "random_vgg") else None


class VQGanVAE(nn.Module):
    """The codec, configured as the JAX package's ``VQGanVAE``. Weights are
    random from ``seed`` unless loaded; the model lives on ``device``
    (``cuda`` unless the caller names another). The loss options
    (``l2_recon_loss``, ``use_hinge_loss``, ``use_vgg_and_gan``,
    ``perceptual``, ``adaptive_weight_cap``) are read by ``forward`` and
    ``gan_parts``; they add no parameter to the codec."""

    def __init__(self, *, dim, image_size, channels=3, num_layers=4, layer_mults=None,
                 l2_recon_loss=False, use_hinge_loss=True, num_resnet_blocks=1,
                 vq_codebook_dim=256, vq_codebook_size=512, vq_decay=0.8,
                 vq_commitment_weight=1.0, vq_kmeans_init=True, vq_use_cosine_sim=True,
                 vq_orthogonal_reg_weight=0.0, vq_threshold_ema_dead_code=0.0, use_attn=True,
                 attn_dim_head=64, attn_heads=8, resnet_groups=16, attn_dropout=0.0,
                 first_conv_kernel_size=5, use_vgg_and_gan=True, perceptual="vgg",
                 adaptive_weight_cap=1e4, compute_dtype=None, device=None, seed=0):
        super().__init__()
        if perceptual not in PERCEPTUAL:
            raise ValueError(f"perceptual must be one of {PERCEPTUAL}, got {perceptual!r}")
        device = resolve_device(device)
        self.dim, self.image_size, self.channels = dim, image_size, channels
        self.num_layers = num_layers
        self.l2_recon_loss, self.use_hinge_loss = l2_recon_loss, use_hinge_loss
        self.use_vgg_and_gan, self.perceptual = use_vgg_and_gan, perceptual
        self.adaptive_weight_cap = adaptive_weight_cap
        self.resnet_groups = resnet_groups
        self.dtype = getattr(torch, compute_dtype) if compute_dtype else None
        mults = layer_mults or tuple(2**i for i in range(num_layers))
        if len(mults) != num_layers:
            raise ValueError("layer_mults needs one entry per layer")
        self.dims = dims = (dim, *(dim * m for m in mults))
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
            return VQGanAttention(d, dim_head=attn_dim_head, heads=attn_heads,
                                  dropout=attn_dropout)

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
                dims[-1], vq_codebook_size, codebook_dim=vq_codebook_dim, decay=vq_decay,
                commitment_weight=vq_commitment_weight, kmeans_init=vq_kmeans_init,
                cosine_sim=vq_use_cosine_sim,
                orthogonal_reg_weight=vq_orthogonal_reg_weight,
                threshold_ema_dead_code=vq_threshold_ema_dead_code,
            )
        init_weights_(self, seed)

    @property
    def device(self):
        return self.vq.embed.device

    def gan_parts(self, seed=0):
        """The discriminator and perceptual net this codec trains with
        (``GanParts``) on the codec's device, random from ``seed`` (the VGG of
        "random_vgg" from seed 0 always: a fixed random-feature metric);
        None when ``use_vgg_and_gan`` is off."""
        if not self.use_vgg_and_gan:
            return None
        with torch.device(self.device):
            gan = GanParts(self.dims, self.channels, self.resnet_groups, self.perceptual)
        init_weights_(gan, seed)
        if self.perceptual == "random_vgg":
            init_weights_(gan.vgg, 0)
        return gan

    def eval_params(self):
        """{name: parameter} of the codec: the JAX package's ``eval_params``
        (everything but the discriminator and the perceptual net, which the
        codec never holds here)."""
        return dict(self.named_parameters())

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

    def _decode_trunk(self, x):
        """The decoder up to its last 1 x 1 conv, the head that the adaptive
        weight differentiates."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in reversed(range(self.num_layers)):
            for block in reversed(self.dec[f"res{i}"]):
                x = block(x)
            if self.attn_per_layer[i]:
                x = self.dec[f"attn{i}"](x)
            x = leaky_relu(self.dec[f"up{i}"](upsample_bilinear(x)))
        return x

    def _decode_fmap(self, x):
        return self.dec["last"](self._decode_trunk(x))

    def _quantize(self, img, update, generator):
        """Encode and quantize (fp32) channels-first pixels: (quantized fmap,
        indices (b, h' * w'), commit loss)."""
        x = self._encode_fmap(img).float()
        quant, indices, commit = self.vq(x.permute(0, 2, 3, 1), update=update,
                                         generator=generator)
        return quant.permute(0, 3, 1, 2), indices.reshape(x.shape[0], -1), commit

    def encode(self, img):
        """img (b, c, h, w) -> (quantized fmap (b, c', h', w'), indices
        (b, h' * w'), commit loss). The quantizer runs in fp32."""
        return self._quantize(torch.as_tensor(img, device=self.device), False, None)
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

    # ---- training: losses and forward ------------------------------------

    def _recon_loss(self, recon, img):
        if self.l2_recon_loss:
            return ((recon - img) ** 2).mean()
        return (recon - img).abs().mean()

    def _perceptual_loss(self, gan, img, recon):
        """fp32; None without a perceptual net (the JAX package's constant 0)."""
        if self.perceptual == "none" or gan.vgg is None:
            return None
        from .perceptual import random_perceptual_loss

        if self.channels == 1:  # grayscale: repeated to RGB
            img, recon = img.expand(-1, 3, -1, -1), recon.expand(-1, 3, -1, -1)
        if self.perceptual == "random_vgg":
            return random_perceptual_loss(gan.vgg, img, recon)
        return ((gan.vgg(img) - gan.vgg(recon)) ** 2).mean()

    def _logits(self, gan, x):
        """The discriminator in the compute dtype, its logits in fp32."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        return gan.discr(x).float()

    def _adaptive_weight(self, gan, img, trunk, gen_loss_fn):
        """‖∂perceptual/∂w‖ / (‖∂gen/∂w‖ + 1e-6), capped, where w is the
        decoder's last conv weight (not its bias): both gradients taken
        through that conv alone, re-run on the trunk held constant, as the
        JAX package does. 0 without a perceptual net."""
        w = self.dec["last"].w
        trunk, img = trunk.detach(), img.detach()
        with torch.enable_grad():
            perceptual = self._perceptual_loss(gan, img, self.dec["last"](trunk).float())
            if perceptual is None:
                return torch.zeros((), device=img.device)
            (g_perc,) = torch.autograd.grad(perceptual, w)
            gen = gen_loss_fn(self._logits(gan, self.dec["last"](trunk).float()))
            (g_gen,) = torch.autograd.grad(gen, w)
        weight = g_perc.norm() / (g_gen.norm() + 1e-6)
        return weight.clamp(max=self.adaptive_weight_cap).detach()

    def forward(self, img, *, gan=None, return_loss=False, return_discr_loss=False,
                return_recons=False, apply_grad_penalty=False, update_vq=None,
                generator=None):
        """The JAX package's ``forward`` modes; img (b, c, h, w).

        Returns the reconstruction (fp32); with ``return_loss`` the generator
        loss (reconstruction + commitment, and with ``gan`` the perceptual
        loss and the adaptively weighted GAN loss), having updated the
        codebook (``update_vq`` defaults to ``return_loss``; k-means and
        dead-code draws from ``generator``); with ``return_discr_loss`` the
        discriminator's loss (``gan`` needed; the codec runs without a
        graph), plus the gradient penalty in fp32 with
        ``apply_grad_penalty``. ``return_recons`` adds the reconstruction
        after the loss. The JAX package also returns the new codebook state:
        here it is in the quantizer's buffers."""
        img = torch.as_tensor(img, device=self.device)
        if img.shape[1] != self.channels or img.shape[-2:] != (self.image_size,) * 2:
            raise ValueError(f"expected (b, {self.channels}, {self.image_size}, "
                             f"{self.image_size}) images, got {tuple(img.shape)}")
        if return_loss and return_discr_loss:
            raise ValueError("return_loss and return_discr_loss exclude each other")
        update_vq = return_loss if update_vq is None else update_vq
        with torch.set_grad_enabled(torch.is_grad_enabled() and not return_discr_loss):
            quant, _, commit = self._quantize(img, update_vq, generator)
            if self.dtype is not None:
                quant = quant.to(self.dtype)
            trunk = self._decode_trunk(quant)
            recon = self.dec["last"](trunk).float()
        if not return_loss and not return_discr_loss:
            return recon

        if return_discr_loss:
            if gan is None:
                raise ValueError("the discriminator (gan=) must exist to train it")
            loss_fn = hinge_discr_loss if self.use_hinge_loss else bce_discr_loss
            loss = loss_fn(self._logits(gan, recon), self._logits(gan, img))
            if apply_grad_penalty:  # in fp32, whatever the compute dtype
                loss = loss + gradient_penalty(img, gan.discr)
            return (loss, recon) if return_recons else loss

        loss = self._recon_loss(recon, img)
        if not self.use_vgg_and_gan or gan is None:
            loss = loss + commit
        else:  # the JAX package's order of the sum
            gen_loss_fn = hinge_gen_loss if self.use_hinge_loss else bce_gen_loss
            perceptual = self._perceptual_loss(gan, img, recon)
            if perceptual is not None:
                loss = loss + perceptual
            weight = self._adaptive_weight(gan, img, trunk, gen_loss_fn)
            loss = loss + commit + weight * gen_loss_fn(self._logits(gan, recon))
        return (loss, recon) if return_recons else loss
