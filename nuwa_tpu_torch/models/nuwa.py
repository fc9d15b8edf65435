"""NUWA — text to video, autoregressive over video tokens.

Counterpart of ``nuwa_tpu/models/nuwa.py``: a text encoder with rotary
positions (or, with ``text_rotary_pos_emb=False``, a learned absolute
position table), axial video positions, learned bos, a causal Sparse3DNA
decoder (plain or reversible) with dense cross-attention to the text, the
teacher-forced cross-entropy loss with condition dropout, and
``generate`` / ``generate_long`` with top-k, Gumbel sampling and
classifier-free guidance: ``method="cached"`` (the default) steps
per-layer caches one token at a time, ``method="full"`` re-runs the whole
decoder for every token (the JAX package's oracle). ``ff_chunk_size`` runs
the decoder's feed-forwards that many positions at a time. After
``utils.quantize.quantize_int8_`` the projections and the logits head are
int8 (serving only). With a ``vae``
(a frozen ``VQGanVAE``) the model takes pixel videos, which the codec turns
into tokens under no grad, and returns sampled videos as pixels; with an
``image_size`` instead it is in raw-fmap mode, and videos are token ids.
``attn_dropout`` and ``ff_dropout`` act in training only (``forward(...,
train=True)``), in the text encoder and the decoder; ``generate`` and
``generate_long`` never drop. The model lives on one device, ``cuda``
unless the caller names another.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.layers import Embedding, init_weights_, normal_, split_seed, with_row0
from ..core.tp import whole
from ..decode import TransformerDecoder
from ..ops.embeddings import AxialPositionalEmbedding, rotary_freqs
from ..ops.sampling import prob_mask_like
from ..ops.utils import resolve_device
from ..transformer import ReversibleTransformer, Transformer
from ..vqgan_vae import VQGanVAE
from ..utils.quantize import head_logits
from .common import (cached_ar_rollout, check_pp, full_ar_rollout, ids_to_output,
                     long_frame_decoder, long_frame_full)

METHODS = ("cached", "full")


def cross_entropy(logits, targets):
    """Mean token cross-entropy, in fp32."""
    return F.cross_entropy(logits.float().flatten(0, -2), targets.reshape(-1).long())


def dropout_seeds(model, train, generator, n, row0=0):
    """The dropout seeds of a training forward's ``n`` stacks: one int drawn
    from ``generator`` (on its device) and ``n`` derived from it, as the JAX
    models split their key; None each when not training or when the model
    drops nothing, so that no draw moves the generator then. With ``row0``
    the batch's row 0 is that row of a global batch (``RowSeed``)."""
    if not train or (model.attn_dropout <= 0 and model.ff_dropout <= 0):
        return [None] * n
    device = generator.device if generator is not None else model.device
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device))
    return [with_row0(s, row0) for s in split_seed(seed, n)]


class NUWA(nn.Module):
    """Give exactly one of ``vae`` (the fmap and the vocabulary are the
    codec's; its parameters get no gradient) and ``image_size`` (the fmap
    side, with ``num_image_tokens``)."""

    def __init__(self, *, dim, vae: VQGanVAE | None = None, image_size=None,
                 num_image_tokens=None, max_video_frames=5,
                 text_num_tokens=49408, text_max_seq_len=256, text_enc_depth=6,
                 text_enc_dim_head=64, text_enc_heads=8, text_rotary_pos_emb=True,
                 enc_reversible=False, dec_depth=6, dec_dim_head=64, dec_heads=8,
                 dec_reversible=False, embed_gradient_frac=0.2, shift_video_tokens=True,
                 sparse_3dna_kernel_size=3, sparse_3dna_dilation=1,
                 sparse_3dna_rel_pos_bias=False, attn_dropout=0.0, ff_dropout=0.0,
                 ff_chunk_size=None, compute_dtype=None, device=None, seed=0):
        super().__init__()
        if (vae is None) == (image_size is None):
            raise ValueError("either VAE or image size must be specified")
        device = resolve_device(device)
        if vae is not None:
            image_size, num_image_tokens = vae.fmap_size, vae.codebook_size
            self.vae = vae.to(device).requires_grad_(False)  # frozen codec
        elif num_image_tokens is None:
            raise ValueError("num_image_tokens is needed without a VAE")
        else:
            self.vae = None
        self.dim = dim
        self.fmap = image_size
        self.max_video_frames = max_video_frames
        self.tokens_per_frame = image_size**2
        self.max_video_tokens = max_video_frames * self.tokens_per_frame
        self.text_max_seq_len = text_max_seq_len
        self.text_enc_dim_head = text_enc_dim_head
        self.text_rotary_pos_emb = text_rotary_pos_emb
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        self.dtype = getattr(torch, compute_dtype) if compute_dtype else None
        d = sparse_3dna_dilation
        dilations = tuple(d) if isinstance(d, (list, tuple)) else tuple(range(1, d + 1))
        video_shape = (max_video_frames, image_size, image_size)

        with torch.device(device):
            self.text_embedding = Embedding(text_num_tokens, dim, embed_gradient_frac)
            self.text_transformer = (ReversibleTransformer if enc_reversible else Transformer)(
                dim=dim, depth=text_enc_depth, heads=text_enc_heads,
                dim_head=text_enc_dim_head, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            )
            if not text_rotary_pos_emb:
                self.text_abs_pos_emb = Embedding(text_max_seq_len, dim)
            self.video_bos = nn.Parameter(torch.empty(dim))
            self.image_embedding = Embedding(num_image_tokens, dim, embed_gradient_frac)
            self.video_pos_emb = AxialPositionalEmbedding(dim, shape=video_shape)
            self.video_transformer = (ReversibleTransformer if dec_reversible else Transformer)(
                dim=dim, depth=dec_depth, heads=dec_heads, dim_head=dec_dim_head,
                causal=True, cross_attend=True,
                shift_video_tokens=shift_video_tokens,
                sparse_3dna_attn=True, sparse_3dna_video_shape=video_shape,
                sparse_3dna_kernel_size=sparse_3dna_kernel_size,
                sparse_3dna_dilations=dilations,
                sparse_3dna_rel_pos_bias=sparse_3dna_rel_pos_bias,
                attn_dropout=attn_dropout, ff_dropout=ff_dropout, ff_chunk_size=ff_chunk_size,
            )
            self.to_logits = nn.Parameter(torch.empty(dim, num_image_tokens))
        init_weights_(self, seed, skip=(self.vae,) if self.vae is not None else ())

    def reset_parameters(self, generator):
        normal_(self.video_bos, generator)
        normal_(self.to_logits, generator, std=0.02)

    @property
    def device(self):
        return self.video_bos.device

    def _ids(self, x):
        return torch.as_tensor(x, dtype=torch.long, device=self.device)

    def _frame_indices(self, video, b):
        """(b, n) token ids of ``video``: ids as they are, or the codec's
        tokens of pixels (b, max_video_frames, c, h, w) in [0, 1]."""
        video = torch.as_tensor(video, device=self.device)
        if not video.is_floating_point():
            return video.long().reshape(b, -1)
        if self.vae is None:
            raise ValueError("pixel videos need a VAE; pass token ids")
        if video.shape[1] != self.max_video_frames:
            raise ValueError(f"video needs all {self.max_video_frames} frames")
        with torch.no_grad():
            return self.vae.get_video_indices(video.float()).reshape(b, -1)

    # ---- text encoder -----------------------------------------------------

    def embed_text(self, text, mask=None, *, train=False, seed=None):
        seq_len = text.shape[1]
        if seq_len > self.text_max_seq_len:
            raise ValueError(f"text of {seq_len} tokens > {self.text_max_seq_len}")
        tokens = self.text_embedding(text, train=train)
        if self.dtype is not None:
            tokens = tokens.to(self.dtype)
        rot = None
        if self.text_rotary_pos_emb:
            rot = rotary_freqs(seq_len, min(32, self.text_enc_dim_head), self.device)
        else:  # added after the cast, as in the JAX package (fp32 + bf16 is fp32)
            tokens = tokens + self.text_abs_pos_emb(torch.arange(seq_len, device=self.device))
        return self.text_transformer(tokens, mask=mask, rotary_pos_emb=rot, seed=seed)

    def _cfg_context(self, text_embeds, text_mask, use_cfg):
        if not use_cfg:
            return text_embeds, text_mask
        return (
            torch.cat([text_embeds, text_embeds], dim=0),
            torch.cat([text_mask, torch.zeros_like(text_mask)], dim=0),
        )

    # ---- decoder core -----------------------------------------------------

    def _decode_logits(self, frame_indices_input, text_embeds, text_mask, *, train=False,
                       seed=None, cp_mesh=None, pp_mesh=None, pp_microbatches=1,
                       pp_data_axis=None):
        """frame_indices_input: (b, n) tokens, already shifted for teacher
        forcing; returns (b, n + 1, vocab) logits. ``pp_mesh``: the decoder
        runs as GPipe stages over its 'pipe' axis (``parallel.pipeline``)."""
        b, n = frame_indices_input.shape
        emb = self.image_embedding(frame_indices_input, train=train)
        emb = emb + self.video_pos_emb()[:n][None]
        bos = self.video_bos.expand(b, 1, self.dim)
        emb = torch.cat([bos, emb], dim=1)
        if self.dtype is not None:
            emb = emb.to(self.dtype)
        if pp_mesh is not None:  # lazy: parallel and train import each other
            from ..parallel.pipeline import pipelined_transformer

            out = pipelined_transformer(
                self.video_transformer, emb, pp_mesh, num_microbatches=pp_microbatches,
                data_axis=pp_data_axis, context=text_embeds, context_mask=text_mask, seed=seed)
        else:
            out = self.video_transformer(emb, context=text_embeds, context_mask=text_mask,
                                         seed=seed, cp_mesh=cp_mesh)
        return head_logits(out, self.to_logits)

    def forward(self, text, video, *, return_loss=False, cond_dropout_prob=0.2,
                train=False, generator=None, uncond=None, row0=0, cp_mesh=None,
                pp_mesh=None, pp_microbatches=1, pp_data_axis=None):
        """Teacher-forced logits of a video given text ids, or with
        ``return_loss`` the mean cross-entropy of predicting each token from
        the ones before it (the input is shifted by one, so the decoder sees
        F * HW - 1 video tokens). ``video`` is token ids (b, ...) or, with a
        VAE, pixels (b, max_video_frames, c, h, w), tokenized by the frozen
        codec.

        ``train`` scales the embeddings' gradients and applies condition
        dropout: each sample's text is masked out with ``cond_dropout_prob``,
        drawn from ``generator``, or where ``uncond`` (b,) bool says so; with
        ``attn_dropout`` or ``ff_dropout`` it draws one dropout seed from
        ``generator`` too, and the text encoder's and the decoder's layers
        take seeds derived from it. ``row0``: the batch is rows [row0, row0 +
        b) of a global batch (a rank's share under data parallelism), and
        the dropout masks key its rows as those global rows. ``cp_mesh``:
        the decoder's Sparse3DNA layers split their frames over a mesh axis
        (context parallelism: ``nda.Sparse3DNA.forward``). ``pp_mesh``: the
        decoder runs as GPipe stages over the mesh's 'pipe' axis in
        ``pp_microbatches`` microbatches, the batch being this rank's rows
        of 'data' when ``pp_data_axis`` names it (pipeline parallelism:
        ``parallel.pipeline``); the text encoder, the embeddings and the
        logits run whole on every rank of 'pipe'.
        """
        check_pp(cp_mesh, pp_mesh)
        text = self._ids(text)
        b = text.shape[0]
        text_mask = text != 0
        text_seed, dec_seed = dropout_seeds(self, train, generator, 2, row0)
        text_embeds = self.embed_text(text, text_mask, train=train, seed=text_seed)
        frame_indices = self._frame_indices(video, b)
        inp = frame_indices[:, :-1] if return_loss else frame_indices
        if train and uncond is None and cond_dropout_prob > 0:
            uncond = prob_mask_like((b,), cond_dropout_prob, generator=generator,
                                    device=self.device)
        if train and uncond is not None:
            text_mask = text_mask & ~torch.as_tensor(uncond, device=self.device)[:, None]
        logits = self._decode_logits(inp, text_embeds, text_mask, train=train, seed=dec_seed,
                                     cp_mesh=cp_mesh, pp_mesh=pp_mesh,
                                     pp_microbatches=pp_microbatches, pp_data_axis=pp_data_axis)
        if not return_loss:
            return logits
        return cross_entropy(logits, frame_indices)

    # ---- sampling ---------------------------------------------------------

    @torch.no_grad()
    def generate(self, text, *, generator=None, filter_thres=0.9, temperature=1.0,
                 cond_scale=2.0, num_frames=None, decode_max_batchsize=10,
                 decode_video=True, method="cached"):
        """Sample a video: ``method="cached"`` with per-layer caches, one
        decoder step per token; ``method="full"`` re-runs the whole decoder
        for every token. Returns pixels (b, num_frames, c, h, w) through the
        VAE or, without one or without ``decode_video``, token ids (b,
        num_frames * tokens_per_frame)."""
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        num_frames = num_frames or self.max_video_frames
        if num_frames > self.max_video_frames:
            raise ValueError("num_frames > max_video_frames: use generate_long")
        total = num_frames * self.tokens_per_frame
        text = self._ids(text)
        b = text.shape[0]
        text_mask = text != 0
        use_cfg = cond_scale != 1
        ctx, cmask = self._cfg_context(self.embed_text(text, text_mask), text_mask, use_cfg)
        sampling = dict(generator=generator, filter_thres=filter_thres,
                        temperature=temperature, cond_scale=cond_scale)
        if method == "full":
            indices = full_ar_rollout(
                self, ctx, cmask, torch.zeros(b, total, dtype=torch.long, device=self.device),
                **sampling)
            return ids_to_output(self.vae, indices, decode_video, decode_max_batchsize)
        dec = TransformerDecoder(self.video_transformer, total_in=total)
        caches = dec.init_cache(
            2 * b if use_cfg else b, ctx, cmask, dtype=self.dtype or torch.float32
        )
        indices = cached_ar_rollout(
            dec=dec, caches=caches, embed_table=whole(self.image_embedding.table),
            pos_emb=self.video_pos_emb(), bos_vec=self.video_bos,
            to_logits=self.to_logits, batch=b, total=total, dim=self.dim, dtype=self.dtype,
            **sampling,
        )
        return ids_to_output(self.vae, indices, decode_video, decode_max_batchsize)

    @torch.no_grad()
    def generate_long(self, text, *, num_frames, generator=None, filter_thres=0.9,
                      temperature=1.0, cond_scale=2.0, decode_max_batchsize=10,
                      decode_video=True, method="cached"):
        """Generate ``num_frames`` > max_video_frames with a sliding frame
        window: each new frame is decoded against the last
        max_video_frames - 1 frames, after one prefill over that window
        (``method="cached"``) or by a full re-forward of the window for
        each of its tokens (``method="full"``). Returns what ``generate``
        does."""
        kw = dict(generator=generator, filter_thres=filter_thres,
                  temperature=temperature, cond_scale=cond_scale)
        if num_frames <= self.max_video_frames:
            return self.generate(text, num_frames=num_frames,
                                 decode_max_batchsize=decode_max_batchsize,
                                 decode_video=decode_video, method=method, **kw)
        indices = self.generate(text, num_frames=self.max_video_frames, decode_video=False,
                                method=method, **kw)
        text = self._ids(text)
        text_mask = text != 0
        ctx, cmask = self._cfg_context(
            self.embed_text(text, text_mask), text_mask, cond_scale != 1
        )
        pos_emb = self.video_pos_emb()
        W = (self.max_video_frames - 1) * self.tokens_per_frame
        for _ in range(num_frames - self.max_video_frames):
            if method == "full":
                frame = long_frame_full(self, indices[:, -W:], ctx, cmask, **kw)
            else:
                frame = long_frame_decoder(self, indices[:, -W:], ctx, cmask, pos_emb, **kw)
            indices = torch.cat([indices, frame], dim=1)
        return ids_to_output(self.vae, indices, decode_video, decode_max_batchsize)
