"""NUWASketch — sketch frames to video, autoregressive over video tokens.

Counterpart of ``nuwa_tpu/models/nuwa_sketch.py`` for serving and training:
a sketch VAE tokenizes the sketch frames, a transformer encodes them (dense
attention, or with ``sketch_enc_use_sparse_3dna`` centered Sparse3DNA with
the token shift on the sketch grid), and the causal video decoder
(Sparse3DNA self-attention, plain or reversible) attends them through
SparseCross2DNA; the video VAE turns video pixels into tokens for scoring
and sampled tokens into pixels. Frame-level sketch masks
become token masks, and condition dropout acts on the token mask the decoder
sees (the JAX package's fix of the reference). Entry points: ``forward``
(logits, or the loss), ``generate`` and sliding-window ``generate_long``,
with classifier-free guidance, by ``method="cached"`` (per-layer caches,
the default) or ``method="full"`` (the whole decoder re-run for every
token, the JAX package's oracle). ``ff_chunk_size`` runs the decoder's
feed-forwards that many positions at a time. Training is ``forward``
with ``return_loss=True, train=True`` and ``loss.backward()``, through the
kernels' backward on the card, with the AdamW of ``train.get_optimizer``,
as the JAX package trains it (no trainer class); ``attn_dropout`` and
``ff_dropout`` act in every attention and feed-forward of both stacks in
training only. The model lives on one device, ``cuda`` unless the caller
names another.

Not taken: the parallel meshes.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..core.layers import Embedding, init_weights_, normal_
from ..core.tp import whole
from ..decode import TransformerDecoder
from ..ops.embeddings import AxialPositionalEmbedding
from ..ops.sampling import prob_mask_like
from ..ops.utils import resolve_device
from ..transformer import ReversibleTransformer, Transformer
from ..vqgan_vae import VQGanVAE
from ..utils.quantize import head_logits
from .common import (cached_ar_rollout, check_pp, full_ar_rollout, ids_to_output,
                     long_frame_decoder, long_frame_full)
from .nuwa import METHODS, cross_entropy, dropout_seeds


def _dilations(d):
    return tuple(d) if isinstance(d, (list, tuple)) else tuple(range(1, d + 1))


class NUWASketch(nn.Module):
    def __init__(self, *, vae: VQGanVAE, sketch_vae: VQGanVAE, dim, image_size,
                 max_video_frames=5, sketch_max_video_frames=2, sketch_enc_depth=6,
                 sketch_enc_dim_head=64, sketch_enc_heads=8,
                 sketch_enc_use_sparse_3dna=False, enc_reversible=False, dec_depth=6,
                 dec_dim_head=64, dec_heads=8, dec_reversible=False,
                 embed_gradient_frac=0.2, shift_video_tokens=True,
                 cross_2dna_kernel_size=3, cross_2dna_dilation=1,
                 sparse_3dna_kernel_size=3, sparse_3dna_dilation=1,
                 attn_dropout=0.0, ff_dropout=0.0, ff_chunk_size=None, compute_dtype=None,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        fmap = image_size // 2**vae.num_layers
        if image_size // 2**sketch_vae.num_layers != fmap:
            raise ValueError("the VAEs must have the same number of layers (equal fmap sizes)")
        # frozen codecs; one VAE passed twice gets a copy of its own, as the
        # JAX params tree keeps "vae" and "sketch_vae" apart
        if sketch_vae is vae:
            sketch_vae = copy.deepcopy(vae)
        self.vae = vae.to(device).requires_grad_(False)
        self.sketch_vae = sketch_vae.to(device).requires_grad_(False)
        self.dim = dim
        self.image_size = image_size
        self.fmap = fmap
        self.max_video_frames = max_video_frames
        self.sketch_max_video_frames = sketch_max_video_frames
        self.tokens_per_frame = fmap * fmap
        self.max_video_tokens = max_video_frames * self.tokens_per_frame
        self.dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        video_shape = (max_video_frames, fmap, fmap)
        stack = dict(  # both stacks' Sparse3DNA, token shift and dropout
            shift_video_tokens=shift_video_tokens,
            sparse_3dna_kernel_size=sparse_3dna_kernel_size,
            sparse_3dna_dilations=_dilations(sparse_3dna_dilation),
            attn_dropout=attn_dropout, ff_dropout=ff_dropout,
        )

        with torch.device(device):
            self.sketch_embedding = Embedding(sketch_vae.codebook_size, dim, embed_gradient_frac)
            self.sketch_pos_emb = AxialPositionalEmbedding(
                dim, shape=(sketch_max_video_frames, fmap, fmap))
            # non-causal: centered Sparse3DNA over the sketch grid, or dense
            self.sketch_transformer = (ReversibleTransformer if enc_reversible else Transformer)(
                dim=dim, depth=sketch_enc_depth, heads=sketch_enc_heads,
                dim_head=sketch_enc_dim_head, sparse_3dna_attn=sketch_enc_use_sparse_3dna,
                sparse_3dna_video_shape=(sketch_max_video_frames, fmap, fmap), **stack,
            )
            self.video_bos = nn.Parameter(torch.empty(dim))
            self.image_embedding = Embedding(vae.codebook_size, dim, embed_gradient_frac)
            self.video_pos_emb = AxialPositionalEmbedding(dim, shape=video_shape)
            self.video_transformer = (ReversibleTransformer if dec_reversible else Transformer)(
                dim=dim, depth=dec_depth, heads=dec_heads, dim_head=dec_dim_head,
                causal=True, cross_attend=True, cross_2dna_attn=True,
                cross_2dna_image_size=fmap, cross_2dna_kernel_size=cross_2dna_kernel_size,
                cross_2dna_dilations=_dilations(cross_2dna_dilation),
                sparse_3dna_attn=True, sparse_3dna_video_shape=video_shape,
                ff_chunk_size=ff_chunk_size, **stack,
            )
            self.to_logits = nn.Parameter(torch.empty(dim, vae.codebook_size))
        init_weights_(self, seed, skip=(self.vae, self.sketch_vae))

    def reset_parameters(self, generator):
        normal_(self.video_bos, generator)
        normal_(self.to_logits, generator, std=0.02)

    @property
    def device(self):
        return self.video_bos.device

    def _pixels(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ---- sketch encoder ---------------------------------------------------

    def embed_sketch(self, sketch, mask=None, *, train=False, seed=None, cp_mesh=None):
        """sketch (b, f, c, h, w) pixels, or (b, c, h, w) for one frame;
        mask (b, f) bool, False for a padded sketch frame; seed: the sketch
        encoder's dropout seed, or None; cp_mesh: a centered Sparse3DNA
        encoder splits its frames over a mesh axis (context parallelism).
        Returns the encoded sketch tokens (b, f * HW, dim) and their mask
        (b, f * HW)."""
        sketch = self._pixels(sketch)
        if sketch.ndim == 4:
            sketch = sketch[:, None]
        b, frames = sketch.shape[:2]
        if sketch.shape[-1] != self.image_size:
            raise ValueError(f"sketch frames must be {self.image_size} pixels wide")
        if frames > self.sketch_max_video_frames:
            raise ValueError(f"{frames} sketch frames > {self.sketch_max_video_frames}")
        with torch.no_grad():
            indices = self.sketch_vae.get_video_indices(sketch).reshape(b, -1)
        tokens = self.sketch_embedding(indices, train=train)
        n = tokens.shape[1]
        tokens = tokens + self.sketch_pos_emb()[:n][None]
        if self.dtype is not None:
            tokens = tokens.to(self.dtype)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
            token_mask = mask.repeat_interleave(n // frames, dim=1)
        else:
            token_mask = torch.ones(b, n, dtype=torch.bool, device=self.device)
        embeds = self.sketch_transformer(tokens, mask=token_mask, seed=seed, cp_mesh=cp_mesh)
        return embeds, token_mask

    def _sketch_context(self, sketch, sketch_mask, use_cfg):
        """The decoder's context and its mask; under classifier-free guidance
        a 2x batch whose second half sees no sketch."""
        embeds, mask = self.embed_sketch(sketch, sketch_mask)
        if not use_cfg:
            return embeds, mask
        return torch.cat([embeds, embeds], dim=0), torch.cat([mask, torch.zeros_like(mask)])

    # ---- decoder core -----------------------------------------------------

    def _decode_logits(self, frame_indices_input, sketch_embeds, context_mask, *, train=False,
                       seed=None, cp_mesh=None, pp_mesh=None, pp_microbatches=1,
                       pp_data_axis=None):
        """frame_indices_input: (b, n) video tokens, already shifted for
        teacher forcing; seed: the decoder's dropout seed, or None. Returns
        (b, n + 1, vocab) logits."""
        b, n = frame_indices_input.shape
        emb = self.image_embedding(frame_indices_input, train=train)
        emb = emb + self.video_pos_emb()[:n][None]
        emb = torch.cat([self.video_bos.expand(b, 1, self.dim), emb], dim=1)
        if self.dtype is not None:
            emb = emb.to(self.dtype)
        if pp_mesh is not None:  # lazy: parallel and train import each other
            from ..parallel.pipeline import pipelined_transformer

            out = pipelined_transformer(
                self.video_transformer, emb, pp_mesh, num_microbatches=pp_microbatches,
                data_axis=pp_data_axis, context=sketch_embeds, context_mask=context_mask,
                seed=seed)
        else:
            out = self.video_transformer(emb, context=sketch_embeds, context_mask=context_mask,
                                         seed=seed, cp_mesh=cp_mesh)
        return head_logits(out, self.to_logits)

    def forward(self, sketch, video, *, sketch_mask=None, return_loss=False,
                cond_dropout_prob=0.2, train=False, generator=None, uncond=None, cp_mesh=None,
                pp_mesh=None, pp_microbatches=1, pp_data_axis=None):
        """Teacher-forced logits (b, F * HW + 1, vocab) of the tokens of
        ``video`` (b, F, c, h, w) pixels, F = max_video_frames, given the
        sketch; or with ``return_loss`` the mean cross-entropy of predicting
        each token from the ones before it. ``train`` scales the embeddings'
        gradients and applies condition dropout to the sketch tokens' mask:
        each sample's sketch is masked out with ``cond_dropout_prob``, drawn
        from ``generator``, or where ``uncond`` (b,) bool says so. With an
        ``attn_dropout`` or ``ff_dropout`` it draws one dropout seed from
        ``generator`` first, and the sketch encoder and the decoder take
        seeds derived from it. ``cp_mesh``: the Sparse3DNA layers of the
        decoder and of a centered encoder split their frames over a mesh
        axis (context parallelism). ``pp_mesh``, ``pp_microbatches``,
        ``pp_data_axis``: the decoder runs as GPipe stages over the mesh's
        'pipe' axis (pipeline parallelism, as ``NUWA.forward``); the sketch
        encoder runs whole on every rank."""
        check_pp(cp_mesh, pp_mesh)
        video = self._pixels(video)
        if video.shape[1] != self.max_video_frames:
            raise ValueError(f"video needs all {self.max_video_frames} frames")
        sketch_seed, dec_seed = dropout_seeds(self, train, generator, 2)
        sketch_embeds, context_mask = self.embed_sketch(sketch, sketch_mask, train=train,
                                                        seed=sketch_seed, cp_mesh=cp_mesh)
        b = video.shape[0]
        with torch.no_grad():
            frame_indices = self.vae.get_video_indices(video).reshape(b, -1)
        inp = frame_indices[:, :-1] if return_loss else frame_indices
        if train and uncond is None and cond_dropout_prob > 0:
            uncond = prob_mask_like((b,), cond_dropout_prob, generator=generator,
                                    device=self.device)
        if train and uncond is not None:
            uncond = torch.as_tensor(uncond, device=self.device)
            context_mask = context_mask & ~uncond[:, None]
        logits = self._decode_logits(inp, sketch_embeds, context_mask, train=train,
                                     seed=dec_seed, cp_mesh=cp_mesh, pp_mesh=pp_mesh,
                                     pp_microbatches=pp_microbatches, pp_data_axis=pp_data_axis)
        if not return_loss:
            return logits
        return cross_entropy(logits, frame_indices)

    # ---- sampling ---------------------------------------------------------

    def _rollout(self, ctx, cmask, b, num_frames, method="cached", **sampling):
        """Sampling of ``num_frames`` frames of token ids (b, n) by
        ``method``."""
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        total = num_frames * self.tokens_per_frame
        if method == "full":
            return full_ar_rollout(
                self, ctx, cmask, torch.zeros(b, total, dtype=torch.long, device=self.device),
                **sampling)
        dec = TransformerDecoder(self.video_transformer, total_in=total)
        caches = dec.init_cache(ctx.shape[0], ctx, cmask, dtype=self.dtype or torch.float32)
        return cached_ar_rollout(
            dec=dec, caches=caches, embed_table=whole(self.image_embedding.table),
            pos_emb=self.video_pos_emb(), bos_vec=self.video_bos,
            to_logits=self.to_logits, batch=b, total=total, dim=self.dim,
            dtype=self.dtype, **sampling,
        )

    @torch.no_grad()
    def generate(self, sketch, *, generator=None, sketch_mask=None, filter_thres=0.9,
                 temperature=1.0, cond_scale=2.0, num_frames=None,
                 decode_max_batchsize=10, decode_video=True, method="cached"):
        """Sample a video for each sketch: ``method="cached"`` with
        per-layer caches, one decoder step per token; ``method="full"``
        re-runs the whole decoder for every token. Returns pixels (b,
        num_frames, c, h, w) or, without ``decode_video``, token ids (b,
        num_frames * HW)."""
        num_frames = num_frames or self.max_video_frames
        if num_frames > self.max_video_frames:
            raise ValueError("num_frames > max_video_frames: use generate_long")
        use_cfg = cond_scale != 1
        ctx, cmask = self._sketch_context(sketch, sketch_mask, use_cfg)
        b = ctx.shape[0] // (2 if use_cfg else 1)
        indices = self._rollout(
            ctx, cmask, b, num_frames, method, generator=generator, filter_thres=filter_thres,
            temperature=temperature, cond_scale=cond_scale,
        )
        return ids_to_output(self.vae, indices, decode_video, decode_max_batchsize)

    @torch.no_grad()
    def generate_long(self, sketch, *, num_frames, generator=None, sketch_mask=None,
                      filter_thres=0.9, temperature=1.0, cond_scale=2.0,
                      decode_max_batchsize=10, decode_video=True, method="cached"):
        """Generate ``num_frames`` > max_video_frames with a sliding frame
        window: each new frame is decoded against the last
        max_video_frames - 1 frames, after one prefill over that window
        (``method="cached"``) or by a full re-forward of the window for each
        of its tokens (``method="full"``)."""
        kw = dict(generator=generator, filter_thres=filter_thres,
                  temperature=temperature, cond_scale=cond_scale)
        if num_frames <= self.max_video_frames:
            return self.generate(sketch, sketch_mask=sketch_mask, num_frames=num_frames,
                                 decode_max_batchsize=decode_max_batchsize,
                                 decode_video=decode_video, method=method, **kw)
        use_cfg = cond_scale != 1
        ctx, cmask = self._sketch_context(sketch, sketch_mask, use_cfg)
        b = ctx.shape[0] // (2 if use_cfg else 1)
        indices = self._rollout(ctx, cmask, b, self.max_video_frames, method, **kw)
        pos_emb = self.video_pos_emb()
        W = (self.max_video_frames - 1) * self.tokens_per_frame
        for _ in range(num_frames - self.max_video_frames):
            if method == "full":
                frame = long_frame_full(self, indices[:, -W:], ctx, cmask, **kw)
            else:
                frame = long_frame_decoder(self, indices[:, -W:], ctx, cmask, pos_emb, **kw)
            indices = torch.cat([indices, frame], dim=1)
        return ids_to_output(self.vae, indices, decode_video, decode_max_batchsize)
