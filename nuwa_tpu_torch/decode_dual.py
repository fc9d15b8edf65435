"""Cached incremental decoding for the dual-modality (video + audio) decoders.

Counterpart of ``nuwa_tpu/decode_dual.py``. Each generated token belongs to
one modality, and its position flows through that modality's half of every
block. The towers meet only through *stream-value buffers*:

  * ``self`` / ``cross`` blocks: independent per-stream steps (Sparse3DNA
    and SparseCausal2DNA neighbourhoods, dense cross-attention over text k/v
    projected once), those of ``decode.py`` and the two audio steps here;
  * ``xmod`` blocks (chunk-aligned CrossModalityCrossAttention): a token of
    chunk n attends the *buffered* opposite-stream values of chunk n - 1.
    The buffer holds, per xmod block, what the full forward shows the other
    side: the block's input in the plain decoder, the *updated* video half
    in the reversible one.

Token order (one video frame's tokens, then one audio frame's) guarantees
every buffered chunk is complete before it is read. As in ``decode.py``,
positions are Python ints and the caches are updated in place; ``prefill``
runs the window through each module's full forward, so on the card it
launches the Sparse3DNA forward kernel once a decoder depth in each of its
geometries, video and audio.

The audio step keeps the JAX step's mask: a token attends only the tokens
of its own timestep that precede it (``nb_idx <= apos``), while the full
forward attends the whole timestep (``SparseCausal2DNA``).
"""
from __future__ import annotations

import torch

from .decode import (
    _CrossAttnStep, _FFStep, _SandwichStep, _ShiftVideoStep, _Sparse3DNAStep, _th_mix,
)
from .dual_decoder import ReversibleDualModalityDecoder
from .nda import Sparse3DNA, SparseCausal2DNA, build_nda_indices
from .ops.attention import Attention
from .ops.feedforward import FeedForward
from .ops.shift import _torch_chunk_sizes, shift_audio_tokens
from .ops.utils import masked_fill, max_neg_value, stable_softmax
from .transformer import ShiftAudio, ShiftVideo


class _SparseCausal2DNAStep:
    """Audio 2DNA for one token: every token of the K dilated past
    timesteps that precedes it, plus bos."""

    def __init__(self, mod: SparseCausal2DNA, total_audio: int):
        self.mod = mod
        self.total = total_audio
        H = mod.height
        idx, valid = build_nda_indices(
            (-(-total_audio // H), H), (mod.kernel_size, H), (mod.dilation, 1),
            ("causal", "full"),
        )
        idx = idx[:total_audio]
        valid = valid[:total_audio] & (idx < total_audio)
        device = mod.to_qkv.w.device
        self.idx = torch.as_tensor(idx, dtype=torch.long, device=device)
        self.valid = torch.as_tensor(valid, device=device)

    def init_cache(self, b, dtype):
        mod = self.mod
        device = mod.to_qkv.w.device
        shape = (b, mod.heads, self.total, mod.dim_head)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "k_bos": torch.zeros(shape[:2] + shape[3:], dtype=dtype, device=device),
            "v_bos": torch.zeros(shape[:2] + shape[3:], dtype=dtype, device=device),
        }

    def __call__(self, cache, x_i, pos):
        mod = self.mod
        h, dh = mod.heads, mod.dim_head
        b = x_i.shape[0]
        q, k_i, v_i = (u.reshape(b, h, dh) for u in mod.to_qkv(x_i).chunk(3, dim=-1))
        if pos == 0:  # bos fills its slot and adopts its own value
            cache["k_bos"].copy_(k_i)
            cache["v_bos"].copy_(v_i)
            return mod.to_out(v_i.reshape(b, h * dh))

        apos = pos - 1
        cache["k"][:, :, apos] = k_i
        cache["v"][:, :, apos] = v_i
        nb_idx = self.idx[apos]
        # the later tokens of this timestep are not generated yet
        nb_valid = self.valid[apos] & (nb_idx <= apos)
        k_nb, v_nb = cache["k"][:, :, nb_idx], cache["v"][:, :, nb_idx]

        q = q * dh**-0.5
        sim = torch.einsum("bhd,bhjd->bhj", q, k_nb)
        rel_bias = mod.rel_bias()
        if rel_bias is not None:
            sim = sim + rel_bias[None].to(sim.dtype)
        sim = masked_fill(sim, ~nb_valid[None, None, :], max_neg_value(sim.dtype))
        sim_bos = torch.einsum("bhd,bhd->bh", q, cache["k_bos"])[..., None]
        attn = _th_mix(stable_softmax(torch.cat([sim_bos, sim], dim=-1)), mod.talking_heads)
        vals = torch.cat([cache["v_bos"][:, :, None], v_nb], dim=2)
        out = torch.einsum("bhj,bhjd->bhd", attn.to(vals.dtype), vals)
        return mod.to_out(out.reshape(b, h * dh))

    def prefill(self, cache, x):
        """x: (b, n, dim) inputs, position 0 = bos. Fills the bos slot and
        audio rows 0..n-2; the output is the module's full forward."""
        mod = self.mod
        b, n, _ = x.shape
        _, k, v = mod.to_qkv(x).chunk(3, dim=-1)
        k = k.reshape(b, n, mod.heads, mod.dim_head).transpose(1, 2)
        v = v.reshape(b, n, mod.heads, mod.dim_head).transpose(1, 2)
        cache["k_bos"].copy_(k[:, :, 0])
        cache["v_bos"].copy_(v[:, :, 0])
        cache["k"][:, :, : n - 1] = k[:, :, 1:]
        cache["v"][:, :, : n - 1] = v[:, :, 1:]
        return mod(x)


class _ShiftAudioStep:
    """Audio token shift for one token: the first half of the channels comes
    from the previous input position (zeros at position 0)."""

    def __init__(self, inner_step, total_in: int, dim: int):
        self.inner = inner_step
        self.total = total_in
        self.dim = dim

    def init_buffer(self, b, dtype, device):
        return torch.zeros(b, self.total, self.dim, dtype=dtype, device=device)

    def __call__(self, cache, x_i, pos):
        buf = cache["shift_buf"]
        buf[:, pos] = x_i
        half = _torch_chunk_sizes(self.dim, 2)[0]
        prev = buf[:, pos - 1, :half] if pos > 0 else torch.zeros_like(x_i[:, :half])
        return self.inner(cache, torch.cat([prev, x_i[:, half:]], dim=-1), pos)

    def prefill(self, cache, x):
        cache["shift_buf"][:, : x.shape[1]] = x
        return self.inner.prefill(cache, shift_audio_tokens(x))


class _XmodStep:
    """Chunk-aligned cross-modality attention for one query token: a token of
    query chunk n = (pos - 1) // chunk_size reads context chunk n of the
    left-padded context, the opposite stream's buffered positions
    (n - 1) * ccs + 1 .. n * ccs (for n = 0 only its start token). The start
    token's output is zero, as the full forward's."""

    def __init__(self, mod):
        self.mod = mod

    def __call__(self, x_i, pos, ctx_buf):
        """ctx_buf: (b, 1 + opposite tokens, dim), its start token first."""
        mod = self.mod
        h, dh, ccs = mod.heads, mod.dim_head, mod.context_chunk_size
        b = x_i.shape[0]
        if pos == 0:
            return torch.zeros_like(x_i)
        n = (pos - 1) // mod.chunk_size
        ctx_pos = torch.arange((n - 1) * ccs + 1, n * ccs + 1, device=x_i.device)
        valid = ctx_pos >= 0
        ctx = ctx_buf[:, ctx_pos.clamp(0, ctx_buf.shape[1] - 1)]  # (b, ccs, dim)

        q = mod.to_q(x_i).reshape(b, h, dh)
        k, v = (u.reshape(b, ccs, h, dh).transpose(1, 2) for u in mod.to_kv(ctx).chunk(2, -1))
        keys = torch.cat([mod.null_k.to(q.dtype)[None, :, None].expand(b, h, 1, dh), k], dim=2)
        vals = torch.cat([mod.null_v.to(q.dtype)[None, :, None].expand(b, h, 1, dh), v], dim=2)
        sim = torch.einsum("bhd,bhjd->bhj", q * dh**-0.5, keys)
        kmask = torch.cat([valid.new_ones(1), valid])
        sim = masked_fill(sim, ~kmask[None, None, :], max_neg_value(sim.dtype))
        attn = _th_mix(stable_softmax(sim), mod.talking_heads)
        attn = attn + mod.talking_heads_b.to(attn.dtype)[None, :, None]
        out = torch.einsum("bhj,bhjd->bhd", attn.to(vals.dtype), vals)
        return mod.to_out(out.reshape(b, h * dh))


class _SandwichXStep:
    def __init__(self, sandwich, inner: _XmodStep):
        self.s = sandwich
        self.inner = inner

    def __call__(self, x_i, pos, ctx_buf):
        return self.s.post(self.inner(self.s.pre(x_i), pos, ctx_buf))


class DualDecoderCache:
    """Cached stepper for a (Reversible)DualModalityDecoder. ``total_v_in``
    and ``total_a_in`` are the towers' input lengths (bos included). A
    reversible stack decodes its quads as four-stream updates and the mean
    of each tower's streams."""

    def __init__(self, decoder, total_v_in: int, total_a_in: int):
        self.d = decoder
        self.total_v_in = total_v_in
        self.total_a_in = total_a_in
        self.reversible = isinstance(decoder, ReversibleDualModalityDecoder)
        self.blocks = decoder.blocks()
        self.steps = []
        for btype, (f, g, j, k) in self.blocks:
            if btype == "xmod":  # (v2a, audio ff, a2v, video ff)
                self.steps.append((
                    _SandwichXStep(f, _XmodStep(f.inner)), _SandwichStep(g, _FFStep(g.inner)),
                    _SandwichXStep(j, _XmodStep(j.inner)), _SandwichStep(k, _FFStep(k.inner)),
                ))
            else:
                self.steps.append((self._build(f, "video"), self._build(g, "video"),
                                   self._build(j, "audio"), self._build(k, "audio")))

    def _build(self, sandwich, stream):
        inner = sandwich.inner
        wrapper = None
        if isinstance(inner, (ShiftVideo, ShiftAudio)):
            wrapper, inner = inner, inner.inner
        total = self.total_v_in if stream == "video" else self.total_a_in
        if isinstance(inner, Sparse3DNA):
            step = _Sparse3DNAStep(inner, total - 1)
        elif isinstance(inner, SparseCausal2DNA):
            step = _SparseCausal2DNAStep(inner, total - 1)
        elif isinstance(inner, Attention):
            step = _CrossAttnStep(inner)
        elif isinstance(inner, FeedForward):
            step = _FFStep(inner)
        else:
            raise TypeError(f"no decode step for {type(inner).__name__}")
        if isinstance(wrapper, ShiftVideo):
            step = _ShiftVideoStep(wrapper, step, total, self.d.dim)
        elif isinstance(wrapper, ShiftAudio):
            step = _ShiftAudioStep(step, total, self.d.dim)
        return _SandwichStep(sandwich, step)

    def init_cache(self, b, context, context_mask, dtype=torch.float32):
        """Per block: the xmod buffers ("vbuf", "abuf"), or one cache per
        module ("f", "g", "j", "k")."""
        device = self.d.video_norm.norm.g.device
        caches = []
        for (btype, _), steps in zip(self.blocks, self.steps):
            if btype == "xmod":
                caches.append({
                    "vbuf": torch.zeros(b, self.total_v_in, self.d.dim, dtype=dtype,
                                        device=device),
                    "abuf": torch.zeros(b, self.total_a_in, self.d.dim, dtype=dtype,
                                        device=device),
                })
                continue
            c = {}
            for name, step in zip("fgjk", steps):
                sc, inner = {}, step.inner
                if isinstance(inner, (_ShiftVideoStep, _ShiftAudioStep)):
                    sc["shift_buf"] = inner.init_buffer(b, dtype, device)
                    inner = inner.inner
                if isinstance(inner, (_Sparse3DNAStep, _SparseCausal2DNAStep)):
                    sc.update(inner.init_cache(b, dtype))
                elif isinstance(inner, _CrossAttnStep):
                    sc.update(inner.init_cache(context, context_mask))
                c[name] = sc
            caches.append(c)
        return caches

    def prefill(self, caches, x_v, x_a):
        """Run both towers over window inputs ``x_v`` (b, nv, dim) and ``x_a``
        (b, na, dim), positions 0..n-1 each (0 being the stream's bos), in
        one pass, leaving the caches as the interleaved single steps would.
        Returns the normed outputs (y_v, y_a)."""
        nv, na = x_v.shape[1], x_a.shape[1]
        v1 = v2 = v = x_v
        a1 = a2 = a = x_a
        for (btype, (f, g, j, k)), steps, c in zip(self.blocks, self.steps, caches):
            if btype == "xmod":  # the modules' full forwards; g: audio ff, k: video ff
                if self.reversible:
                    v1 = v1 + f(v2, a2)
                    v2 = v2 + k(v1)
                    c["abuf"][:, :na] = a2
                    a1 = a1 + j(a2, v2)
                    a2 = a2 + g(a1)
                    c["vbuf"][:, :nv] = v2
                else:
                    c["vbuf"][:, :nv] = v
                    c["abuf"][:, :na] = a
                    out_v, out_a = f(v, a), j(a, v)
                    v = v + out_v
                    v = v + k(v)
                    a = a + out_a
                    a = a + g(a)
                continue
            sf, sg, sj, sk = steps
            if self.reversible:
                v1 = v1 + sf.prefill(c["f"], v2)
                v2 = v2 + sg.prefill(c["g"], v1)
                a1 = a1 + sj.prefill(c["j"], a2)
                a2 = a2 + sk.prefill(c["k"], a1)
            else:
                v = v + sf.prefill(c["f"], v)
                v = v + sg.prefill(c["g"], v)
                a = a + sj.prefill(c["j"], a)
                a = a + sk.prefill(c["k"], a)
        if self.reversible:
            v, a = (v1 + v2) * 0.5, (a1 + a2) * 0.5
        return self.d.video_norm(v), self.d.audio_norm(a)

    def step_video(self, caches, x_i, vpos):
        return self._step(caches, x_i, vpos, video=True)

    def step_audio(self, caches, x_i, apos):
        return self._step(caches, x_i, apos, video=False)

    def _step(self, caches, x_i, pos, video):
        """x_i: (b, dim) input of one stream at ``pos``; returns its normed
        output."""
        s1 = s2 = s = x_i
        for (btype, _), steps, c in zip(self.blocks, self.steps, caches):
            if btype == "xmod":
                v2a, aff, a2v, vff = steps
                attend, ff = (v2a, vff) if video else (a2v, aff)
                own, other = ("vbuf", "abuf") if video else ("abuf", "vbuf")
                if self.reversible:
                    # video: y1 = x1 + f(x2, m2); y2 = x2 + k(y1), buffered
                    # after the update; audio buffers its m2 before its own
                    if not video:
                        c[own][:, pos] = s2
                    s1 = s1 + attend(s2, pos, c[other])
                    s2 = s2 + ff({}, s1, pos)
                    if video:
                        c[own][:, pos] = s2
                else:  # both sides read the pre-update inputs
                    c[own][:, pos] = s
                    s = s + attend(s, pos, c[other])
                    s = s + ff({}, s, pos)
                continue
            # video: f (attention) and g (ff); audio: j and k
            attn, ff = steps[:2] if video else steps[2:]
            attn_cache, ff_cache = (c["f"], c["g"]) if video else (c["j"], c["k"])
            if self.reversible:
                s1 = s1 + attn(attn_cache, s2, pos)
                s2 = s2 + ff(ff_cache, s1, pos)
            else:
                s = s + attn(attn_cache, s, pos)
                s = s + ff(ff_cache, s, pos)
        y = (s1 + s2) * 0.5 if self.reversible else s
        return (self.d.video_norm if video else self.d.audio_norm)(y)
