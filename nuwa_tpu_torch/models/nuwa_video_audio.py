"""NUWAVideoAudio — text to joint video and audio, serving and training.

Counterpart of ``nuwa_tpu/models/nuwa_video_audio.py``: a text encoder
with absolute positions (or rotary ones with ``text_rotary_pos_emb``; plain
or, with ``enc_reversible``, reversible), twin decoder towers (``dual_decoder``: Sparse3DNA
over video, SparseCausal2DNA over audio, dense cross-attention to the text,
chunk-aligned cross-modality attention every few depths), separate video
and audio heads, the loss
``video_loss + audio_loss * audio_loss_weight`` with condition dropout, and
``generate`` and ``generate_long``, which alternate one video frame's
tokens and one frame's worth of audio tokens, by ``method="cached"`` (the
default) or ``method="full"``, which re-runs both towers over the whole
sequence for every token (the JAX package's oracle; at H > 1 its forward
attends the later tokens of a query's own timestep, which the cached step
does not, so the two methods may part there, as in the JAX package). Pixels
go in through the frozen codec under no grad and samples come out through
it. ``ff_chunk_size`` runs the decoder's feed-forwards that many positions
at a time; after ``utils.quantize.quantize_int8_`` the projections and both
heads are int8 (serving only).

``attn_dropout`` and ``ff_dropout`` act in training only (``forward(...,
train=True)``), in the text encoder and both decoder towers; ``generate``
and ``generate_long`` never drop. Left out: context and pipeline
parallelism. The model lives on one device, ``cuda`` unless the caller
names another.

Training is ``forward(..., return_loss=True, train=True)``, its
``backward()``, ``train.clip_by_global_norm_`` and a ``train.get_optimizer``
step, the step the JAX package jits in ``scripts/bench_dual_flagship.py``;
the reversible decoder rebuilds its activations in the backward, and the
plain one keeps them, or with ``dec_remat`` recomputes each block.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.layers import Embedding, init_weights_, normal_
from ..core.tp import whole
from ..decode_dual import DualDecoderCache
from ..dual_decoder import DualModalityDecoder, ReversibleDualModalityDecoder
from ..ops.embeddings import AxialPositionalEmbedding, rotary_freqs
from ..ops.sampling import gumbel_sample, prob_mask_like, top_k_filter
from ..ops.utils import resolve_device
from ..transformer import ReversibleTransformer, Transformer
from ..utils.quantize import head_logits
from ..vqgan_vae import VQGanVAE
from .common import ar_decode_loop, ids_to_output
from .nuwa import METHODS, cross_entropy, dropout_seeds


def _dilations(d):
    return tuple(d) if isinstance(d, (list, tuple)) else tuple(range(1, d + 1))


class NUWAVideoAudio(nn.Module):
    def __init__(self, *, vae: VQGanVAE, dim, image_size, num_audio_tokens,
                 num_audio_tokens_per_video_frame, audio_tokens_per_timestep=1,
                 max_video_frames=5, text_num_tokens=49408, text_max_seq_len=256,
                 text_enc_depth=6, text_enc_dim_head=64, text_enc_heads=8,
                 text_rotary_pos_emb=False, enc_reversible=False, dec_reversible=True,
                 dec_depth=6, dec_dim_head=64, dec_heads=8, embed_gradient_frac=0.2,
                 shift_video_tokens=True, shift_audio_tokens=True,
                 sparse_3dna_kernel_size=3, sparse_3dna_dilation=1,
                 sparse_3dna_rel_pos_bias=True, sparse_2dna_kernel_size=7,
                 sparse_2dna_dilation=1, sparse_2dna_rel_pos_bias=True,
                 audio_loss_weight=1.0, cross_modality_attn_every=3, dec_remat=False,
                 attn_dropout=0.0, ff_dropout=0.0, ff_chunk_size=None, compute_dtype=None,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.vae = vae.to(device).requires_grad_(False)  # frozen codec
        self.dim = dim
        self.fmap = image_size // 2**vae.num_layers
        self.max_video_frames = max_video_frames
        self.tokens_per_frame = self.fmap**2
        self.num_audio_tokens = num_audio_tokens
        self.audio_tokens_per_frame = num_audio_tokens_per_video_frame
        self.text_max_seq_len = text_max_seq_len
        self.text_enc_dim_head = text_enc_dim_head
        self.text_rotary_pos_emb = text_rotary_pos_emb
        self.audio_loss_weight = audio_loss_weight
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        self.dtype = getattr(torch, compute_dtype) if compute_dtype else None
        video_shape = (max_video_frames, self.fmap, self.fmap)
        H = audio_tokens_per_timestep

        with torch.device(device):
            self.text_embedding = Embedding(text_num_tokens, dim, embed_gradient_frac)
            self.text_transformer = (ReversibleTransformer if enc_reversible else Transformer)(
                dim=dim, depth=text_enc_depth, heads=text_enc_heads,
                dim_head=text_enc_dim_head, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            )
            if not text_rotary_pos_emb:
                self.text_abs_pos_emb = Embedding(text_max_seq_len, dim)
            self.video_bos = nn.Parameter(torch.empty(dim))
            self.image_embedding = Embedding(vae.codebook_size, dim, embed_gradient_frac)
            self.video_pos_emb = AxialPositionalEmbedding(dim, shape=video_shape)
            self.audio_bos = nn.Parameter(torch.empty(dim))
            self.audio_embedding = Embedding(num_audio_tokens, dim, embed_gradient_frac)
            self.audio_pos_emb = AxialPositionalEmbedding(
                dim, shape=(num_audio_tokens // H, H))
            decoder = ReversibleDualModalityDecoder if dec_reversible else DualModalityDecoder
            self.video_audio_transformer = decoder(
                dim=dim, depth=dec_depth, heads=dec_heads, dim_head=dec_dim_head,
                num_audio_tokens_per_video_frame=num_audio_tokens_per_video_frame,
                num_video_tokens_per_frame=self.tokens_per_frame,
                sparse_3dna_video_shape=video_shape,
                sparse_3dna_kernel_size=sparse_3dna_kernel_size,
                sparse_3dna_dilations=_dilations(sparse_3dna_dilation),
                sparse_3dna_rel_pos_bias=sparse_3dna_rel_pos_bias,
                sparse_2dna_kernel_size=sparse_2dna_kernel_size,
                sparse_2dna_dilation=_dilations(sparse_2dna_dilation),
                sparse_2dna_rel_pos_bias=sparse_2dna_rel_pos_bias,
                shift_video_tokens=shift_video_tokens, shift_audio_tokens=shift_audio_tokens,
                audio_tokens_per_timestep=H,
                cross_modality_attn_every=cross_modality_attn_every, remat=dec_remat,
                attn_dropout=attn_dropout, ff_dropout=ff_dropout, ff_chunk_size=ff_chunk_size,
            )
            self.to_video_logits = nn.Parameter(torch.empty(dim, vae.codebook_size))
            self.to_audio_logits = nn.Parameter(torch.empty(dim, num_audio_tokens))
        init_weights_(self, seed, skip=(self.vae,))

    def reset_parameters(self, generator):
        normal_(self.video_bos, generator)
        normal_(self.audio_bos, generator)
        normal_(self.to_video_logits, generator, std=0.02)
        normal_(self.to_audio_logits, generator, std=0.02)

    @property
    def device(self):
        return self.video_bos.device

    def _ids(self, x):
        return torch.as_tensor(x, dtype=torch.long, device=self.device)

    def _cast(self, x):
        return x.to(self.dtype) if self.dtype is not None else x

    def _frame_indices(self, video, b):
        """(b, n) token ids of ``video``: ids as they are, or the codec's
        tokens of pixels (b, max_video_frames, c, h, w) in [0, 1]."""
        video = torch.as_tensor(video, device=self.device)
        if not video.is_floating_point():
            return video.long().reshape(b, -1)
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
        rot = None
        if self.text_rotary_pos_emb:
            rot = rotary_freqs(seq_len, min(32, self.text_enc_dim_head), self.device)
        else:
            tokens = tokens + self.text_abs_pos_emb(torch.arange(seq_len, device=self.device))
        return self.text_transformer(self._cast(tokens), mask=mask, rotary_pos_emb=rot,
                                     seed=seed)

    def _text_context(self, text, use_cfg):
        """Text embeddings and mask, doubled for classifier-free guidance
        (the second half with its text masked out)."""
        mask = text != 0
        ctx = self.embed_text(text, mask)
        if not use_cfg:
            return ctx, mask
        return torch.cat([ctx, ctx], dim=0), torch.cat([mask, torch.zeros_like(mask)], dim=0)

    # ---- shared embed + decode --------------------------------------------

    def _embed_video_tokens(self, indices, train=False):
        b, n = indices.shape
        emb = self.image_embedding(indices, train=train) + self.video_pos_emb()[:n][None]
        return self._cast(torch.cat([self.video_bos.expand(b, 1, self.dim), emb], dim=1))

    def _embed_audio_tokens(self, indices, train=False):
        b, n = indices.shape
        emb = self.audio_embedding(indices, train=train) + self.audio_pos_emb()[:n][None]
        return self._cast(torch.cat([self.audio_bos.expand(b, 1, self.dim), emb], dim=1))

    def _decode(self, video_inp, audio_inp, text_embeds, text_mask, *, train=False, seed=None):
        v = self._embed_video_tokens(video_inp, train)
        a = self._embed_audio_tokens(audio_inp, train)
        v, a = self.video_audio_transformer(v, a, context=text_embeds, context_mask=text_mask,
                                            seed=seed)
        return head_logits(v, self.to_video_logits), head_logits(a, self.to_audio_logits)

    def forward(self, text, video, audio, *, return_loss=False, cond_dropout_prob=0.2,
                train=False, generator=None, uncond=None):
        """Teacher-forced (video logits, audio logits) given text ids, or
        with ``return_loss`` the video loss plus ``audio_loss_weight`` times
        the audio loss, each the mean cross-entropy of predicting every
        token from the ones before it. ``video`` is token ids (b, ...) or
        pixels (b, max_video_frames, c, h, w), tokenized by the frozen
        codec; ``audio`` is token ids (b, n). ``train`` scales the
        embeddings' gradients and applies condition dropout, drawn from
        ``generator`` or where ``uncond`` (b,) bool says so, and with
        ``attn_dropout`` or ``ff_dropout`` draws one dropout seed from
        ``generator``, from which the encoder's and the decoder's layers
        take theirs."""
        text = self._ids(text)
        b = text.shape[0]
        text_mask = text != 0
        text_seed, dec_seed = dropout_seeds(self, train, generator, 2)
        text_embeds = self.embed_text(text, text_mask, train=train, seed=text_seed)
        frame_indices = self._frame_indices(video, b)
        audio = self._ids(audio).reshape(b, -1)
        video_inp = frame_indices[:, :-1] if return_loss else frame_indices
        audio_inp = audio[:, :-1] if return_loss else audio
        if train and uncond is None and cond_dropout_prob > 0:
            uncond = prob_mask_like((b,), cond_dropout_prob, generator=generator,
                                    device=self.device)
        if train and uncond is not None:
            text_mask = text_mask & ~torch.as_tensor(uncond, device=self.device)[:, None]
        video_logits, audio_logits = self._decode(video_inp, audio_inp, text_embeds,
                                                  text_mask, train=train, seed=dec_seed)
        if not return_loss:
            return video_logits, audio_logits
        return (cross_entropy(video_logits, frame_indices)
                + cross_entropy(audio_logits, audio) * self.audio_loss_weight)

    # ---- cached sampling --------------------------------------------------

    def _sampler(self, b, use_cfg, generator, filter_thres, temperature, cond_scale):
        """Logits of the (doubled under CFG) batch -> (b,) samples."""
        def sample(y, to_logits):
            logits = head_logits(y, to_logits)
            if use_cfg:
                cond, uncond = logits[:b], logits[b:]
                logits = uncond + (cond - uncond) * cond_scale
            return gumbel_sample(top_k_filter(logits, thres=filter_thres), temperature,
                                 generator=generator)
        return sample

    def _step_input(self, x, b, use_cfg):
        """A tower's input (dim,) or (b, dim) for one cached step: cast, and
        doubled under CFG."""
        x = self._cast(x.expand(b, self.dim))
        return torch.cat([x, x], dim=0) if use_cfg else x

    def _dual_frame_rollout(self, dec, caches, y_audio, prev_v, vbuf, abuf, frame_ids, *,
                            b, use_cfg, sample):
        """Per frame, the video tokens and then the audio tokens, one cached
        step each. The audio tower steps one position ahead of audio
        sampling: ``y_audio`` is its output at the next position, whose
        logits give the next audio sample. Shared by ``generate`` (frames
        0..n-1) and ``generate_long`` (one window-relative frame)."""
        vtpf, atpf = self.tokens_per_frame, self.audio_tokens_per_frame
        vpos_emb, apos_emb = self.video_pos_emb(), self.audio_pos_emb()
        vtable, atable = whole(self.image_embedding.table), whole(self.audio_embedding.table)
        for f in frame_ids:
            for i in range(vtpf):
                vp = f * vtpf + i
                x = self.video_bos if vp == 0 else vtable[prev_v] + vpos_emb[vp - 1]
                y = dec.step_video(caches, self._step_input(x, b, use_cfg), vp)
                prev_v = sample(y, self.to_video_logits)
                vbuf[:, vp] = prev_v
            for i in range(atpf):
                ap = f * atpf + i
                tok = sample(y_audio, self.to_audio_logits)
                abuf[:, ap] = tok
                # peek-step the next audio position with the embedding of tok
                x = self._step_input(atable[tok] + apos_emb[ap], b, use_cfg)
                y_audio = dec.step_audio(caches, x, ap + 1)
        return vbuf, abuf

    def _full_frames(self, vbuf, abuf, frames, vstart, astart, ctx, cmask, *, b, use_cfg,
                     **sampling):
        """``method="full"``'s rollout of ``frames`` frames: per frame its
        video tokens and then its audio tokens, each sampled from a full
        re-forward of both towers over the whole buffers (under CFG one call
        on the doubled batch), written at video positions from ``vstart``
        and audio positions from ``astart``."""
        n_v, n_a = vbuf.shape[1] - 1, abuf.shape[1] - 1

        def step_logits(video):
            def logits(_, i):
                v_inp, a_inp = vbuf[:, :n_v], abuf[:, :n_a]
                if use_cfg:
                    v_inp, a_inp = torch.cat([v_inp, v_inp]), torch.cat([a_inp, a_inp])
                row = self._decode(v_inp, a_inp, ctx, cmask)[0 if video else 1][:, i]
                return (row[:b], row[b:]) if use_cfg else (row, None)
            return logits

        vtpf, atpf = self.tokens_per_frame, self.audio_tokens_per_frame
        for f in range(frames):
            for video, buf, tpf, start in ((True, vbuf, vtpf, vstart + f * vtpf),
                                           (False, abuf, atpf, astart + f * atpf)):
                ar_decode_loop(indices=buf, start=start, stop=start + tpf,
                               step_logits_fn=step_logits(video), **sampling)
        return vbuf, abuf

    @torch.no_grad()
    def generate(self, text, *, generator=None, filter_thres=0.9, temperature=1.0,
                 cond_scale=2.0, num_frames=None, decode_max_batchsize=10,
                 decode_video=True, method="cached"):
        """Sample video and audio: ``method="cached"`` with per-layer caches,
        one decoder step per token; ``method="full"`` re-runs the whole dual
        decoder for every token. Returns (video, audio ids (b, num_frames *
        audio tokens a frame)): video as pixels (b, num_frames, c, h, w)
        through the VAE, or with ``decode_video=False`` as ids (b,
        num_frames * tokens a frame)."""
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        num_frames = num_frames or self.max_video_frames
        if num_frames > self.max_video_frames:
            raise ValueError("num_frames > max_video_frames: use generate_long")
        text = self._ids(text)
        b = text.shape[0]
        use_cfg = cond_scale != 1
        total_v = num_frames * self.tokens_per_frame
        total_a = num_frames * self.audio_tokens_per_frame
        ctx, cmask = self._text_context(text, use_cfg)
        if method == "full":
            zeros = torch.zeros(b, dtype=torch.long, device=self.device)
            vbuf, abuf = self._full_frames(
                zeros.new_zeros(b, total_v), zeros.new_zeros(b, total_a), num_frames, 0, 0,
                ctx, cmask, b=b, use_cfg=use_cfg, generator=generator,
                filter_thres=filter_thres, temperature=temperature, cond_scale=cond_scale,
            )
            return ids_to_output(self.vae, vbuf, decode_video, decode_max_batchsize), abuf
        # one more audio slot: the last peek step lands in an unused position
        dec = DualDecoderCache(self.video_audio_transformer, total_v_in=total_v,
                               total_a_in=total_a + 1)
        caches = dec.init_cache(2 * b if use_cfg else b, ctx, cmask,
                                dtype=self.dtype or torch.float32)
        sample = self._sampler(b, use_cfg, generator, filter_thres, temperature, cond_scale)
        # prime the audio tower with its bos
        y_audio = dec.step_audio(caches, self._step_input(self.audio_bos, b, use_cfg), 0)
        zeros = torch.zeros(b, dtype=torch.long, device=self.device)
        vbuf, abuf = self._dual_frame_rollout(
            dec, caches, y_audio, zeros, zeros.new_zeros(b, total_v),
            zeros.new_zeros(b, total_a), range(num_frames), b=b, use_cfg=use_cfg,
            sample=sample,
        )
        return ids_to_output(self.vae, vbuf, decode_video, decode_max_batchsize), abuf

    def _long_frame(self, wv, wa, ctx, cmask, sample, use_cfg):
        """The next frame of both modalities after the windows ``wv`` (b, Wv)
        and ``wa`` (b, Wa) of the previous max_video_frames - 1 frames: one
        prefill over the window (video positions 0..Wv-1, audio 0..Wa, the
        audio tower one ahead), then one cached step per new token."""
        b, Wv = wv.shape
        Wa = wa.shape[1]
        maxf = self.max_video_frames
        vtpf, atpf = self.tokens_per_frame, self.audio_tokens_per_frame
        dec = DualDecoderCache(self.video_audio_transformer, total_v_in=maxf * vtpf,
                               total_a_in=maxf * atpf + 1)
        dtype = self.dtype or torch.float32
        caches = dec.init_cache(2 * b if use_cfg else b, ctx, cmask, dtype=dtype)
        x_v = self._embed_video_tokens(wv[:, : Wv - 1])
        x_a = self._embed_audio_tokens(wa)
        if use_cfg:
            x_v, x_a = torch.cat([x_v, x_v], dim=0), torch.cat([x_a, x_a], dim=0)
        _, y_a = dec.prefill(caches, x_v.to(dtype), x_a.to(dtype))
        vbuf = wv.new_zeros(b, maxf * vtpf)
        abuf = wv.new_zeros(b, maxf * atpf)
        vbuf, abuf = self._dual_frame_rollout(
            dec, caches, y_a[:, -1], wv[:, -1], vbuf, abuf, [maxf - 1], b=b,
            use_cfg=use_cfg, sample=sample,
        )
        return vbuf[:, Wv:], abuf[:, Wa:]

    @torch.no_grad()
    def generate_long(self, text, *, num_frames, generator=None, filter_thres=0.9,
                      temperature=1.0, cond_scale=2.0, decode_max_batchsize=10,
                      decode_video=True, method="cached"):
        """Generate ``num_frames`` > max_video_frames of video and audio with a
        frame-aligned sliding window over both modalities: each new frame is
        decoded against the previous max_video_frames - 1 frames of video
        and audio tokens, after one prefill of both towers over them
        (``method="cached"``) or by a full re-forward of the window pair for
        each token (``method="full"``). Returns what ``generate`` does."""
        kw = dict(generator=generator, filter_thres=filter_thres, temperature=temperature,
                  cond_scale=cond_scale, method=method)
        maxf = self.max_video_frames
        if num_frames <= maxf:
            return self.generate(text, num_frames=num_frames, decode_video=decode_video,
                                 decode_max_batchsize=decode_max_batchsize, **kw)
        if maxf * self.audio_tokens_per_frame > self.num_audio_tokens:
            raise ValueError("the audio position table is smaller than one window")
        vidx, aidx = self.generate(text, num_frames=maxf, decode_video=False, **kw)
        text = self._ids(text)
        b = text.shape[0]
        use_cfg = cond_scale != 1
        ctx, cmask = self._text_context(text, use_cfg)
        sample = self._sampler(b, use_cfg, generator, filter_thres, temperature, cond_scale)
        vtpf, atpf = self.tokens_per_frame, self.audio_tokens_per_frame
        Wv, Wa = (maxf - 1) * vtpf, (maxf - 1) * atpf
        for _ in range(num_frames - maxf):
            wv, wa = vidx[:, -Wv:], aidx[:, -Wa:]
            if method == "full":  # the whole window pair re-run for every token
                vwin, awin = self._full_frames(
                    torch.cat([wv, wv.new_zeros(b, vtpf)], dim=1),
                    torch.cat([wa, wa.new_zeros(b, atpf)], dim=1), 1, Wv, Wa, ctx, cmask,
                    b=b, use_cfg=use_cfg, generator=generator, filter_thres=filter_thres,
                    temperature=temperature, cond_scale=cond_scale,
                )
                vfr, afr = vwin[:, Wv:], awin[:, Wa:]
            else:
                vfr, afr = self._long_frame(wv, wa, ctx, cmask, sample, use_cfg)
            vidx, aidx = torch.cat([vidx, vfr], dim=1), torch.cat([aidx, afr], dim=1)
        return ids_to_output(self.vae, vidx, decode_video, decode_max_batchsize), aidx
