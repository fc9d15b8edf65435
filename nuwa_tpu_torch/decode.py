"""Cached autoregressive decoding.

Counterpart of ``nuwa_tpu/decode.py``. Per decoder layer the cache holds
what one incremental step needs:

  * Sparse3DNA: a (b, h, T, dh) k/v buffer plus the bos k/v slot; a new
    token attends its neighbour-table row (at most Kn entries) plus bos;
  * dense causal self-attention: a (b, h, T, dh) k/v buffer of every input
    position, bos included; a new token attends null and positions 0..pos;
  * dense cross-attention: the context k/v, projected once per rollout;
  * SparseCross2DNA: the same, plus the context mask and the raw context,
    so that ``prefill`` can run the module's full forward; a new video token
    attends the F·Kn context rows of its spatial window (the bos token the
    whole context), in plain PyTorch;
  * token shift: a (b, T, dim) buffer of the layer's inputs, so the shifted
    channels can be read from positions p - HW (the frame before, with
    ``shift_time``), p - W and p - 1 (the token above and to the left, with
    ``shift_space``).

Positions are Python ints (PyTorch runs eagerly, so nothing is traced) and
the caches are updated in place, which keeps one buffer per layer instead
of a new one per step. ``prefill`` runs a whole (b, n, dim) block of inputs
through the module's full forward — on the card, through the Sparse3DNA
kernel and SparseCross2DNA through the cross kernel — and leaves the caches
as n single steps would.
"""
from __future__ import annotations

import torch

from .core.tp import whole
from .nda import Sparse3DNA, SparseCross2DNA, build_nda_indices
from .ops.attention import Attention
from .ops.feedforward import FeedForward
from .ops.shift import _torch_chunk_sizes, shift_video_tokens
from .ops.utils import masked_fill, max_neg_value, stable_softmax
from .transformer import ReversibleTransformer, Sandwich, ShiftVideo, Transformer


def _th_mix(attn, w):
    """Talking heads for one query row: attn (b, h, J) -> mixed."""
    return torch.einsum("bhj,gh->bgj", attn, w.to(attn.dtype))


class _DenseSelfStep:
    """Dense causal self-attention over a k/v cache of every position."""

    def __init__(self, mod: Attention, total_in: int):
        self.mod = mod
        self.total = total_in

    def init_cache(self, b, dtype):
        mod = self.mod
        shape = (b, mod.heads, self.total, mod.dim_head)
        device = mod.to_q.w.device
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def __call__(self, cache, x_i, pos):
        mod = self.mod
        h, dh = mod.heads, mod.dim_head
        b = x_i.shape[0]
        k_i, v_i = mod.to_kv(x_i).chunk(2, dim=-1)
        cache["k"][:, :, pos] = k_i.reshape(b, h, dh)
        cache["v"][:, :, pos] = v_i.reshape(b, h, dh)
        q = mod.to_q(x_i).reshape(b, h, dh) * dh**-0.5
        null_k = whole(mod.null_k).to(q.dtype)[None, :, 0].expand(b, h, dh)
        null_v = whole(mod.null_v).to(q.dtype)[None, :, 0].expand(b, h, dh)
        # null and positions 0..pos: the JAX step's mask over the whole
        # buffer leaves exactly these
        keys = torch.cat([null_k[:, :, None], cache["k"][:, :, : pos + 1]], dim=2)
        vals = torch.cat([null_v[:, :, None], cache["v"][:, :, : pos + 1]], dim=2)
        sim = torch.einsum("bhd,bhjd->bhj", q, keys)
        attn = _th_mix(stable_softmax(sim), mod.talking_heads)
        out = torch.einsum("bhj,bhjd->bhd", attn.to(vals.dtype), vals)
        return mod.to_out(out.reshape(b, h * dh))

    def prefill(self, cache, x):
        mod = self.mod
        b, n, _ = x.shape
        k, v = mod.to_kv(x).chunk(2, dim=-1)
        cache["k"][:, :, :n] = k.reshape(b, n, mod.heads, mod.dim_head).transpose(1, 2)
        cache["v"][:, :, :n] = v.reshape(b, n, mod.heads, mod.dim_head).transpose(1, 2)
        return mod(x)


class _CrossAttnStep:
    """Dense cross-attention over context k/v computed once."""

    def __init__(self, mod: Attention):
        self.mod = mod

    def init_cache(self, context, context_mask):
        mod = self.mod
        b, L, _ = context.shape
        k, v = mod.to_kv(context).chunk(2, dim=-1)
        k = k.reshape(b, L, mod.heads, mod.dim_head).transpose(1, 2)
        v = v.reshape(b, L, mod.heads, mod.dim_head).transpose(1, 2)
        if context_mask is None:
            context_mask = torch.ones(b, L, dtype=torch.bool, device=context.device)
        return {"ck": k, "cv": v, "cmask": context_mask}

    def _attend(self, cache, q):
        """q: (b, h, i, dh) -> (b, h, i, dh)."""
        mod = self.mod
        b = q.shape[0]
        shape = (b, mod.heads, 1, mod.dim_head)
        keys = torch.cat([whole(mod.null_k).to(q.dtype).expand(shape), cache["ck"]], dim=2)
        vals = torch.cat([whole(mod.null_v).to(q.dtype).expand(shape), cache["cv"]], dim=2)
        sim = torch.einsum("bhid,bhjd->bhij", q * mod.dim_head**-0.5, keys)
        kmask = torch.nn.functional.pad(cache["cmask"], (1, 0), value=True)
        sim = masked_fill(sim, ~kmask[:, None, None, :], max_neg_value(sim.dtype))
        attn = stable_softmax(sim)
        attn = torch.einsum("bhij,gh->bgij", attn, mod.talking_heads.to(attn.dtype))
        return torch.einsum("bhij,bhjd->bhid", attn.to(vals.dtype), vals)

    def __call__(self, cache, x_i, pos):
        mod = self.mod
        b = x_i.shape[0]
        q = mod.to_q(x_i).reshape(b, mod.heads, 1, mod.dim_head)
        out = self._attend(cache, q)
        return mod.to_out(out.reshape(b, mod.inner_dim))

    def prefill(self, cache, x):
        mod = self.mod
        b, n, _ = x.shape
        q = mod.to_q(x).reshape(b, n, mod.heads, mod.dim_head).transpose(1, 2)
        out = self._attend(cache, q).transpose(1, 2).reshape(b, n, mod.inner_dim)
        return mod.to_out(out)


class _SparseCross2DNAStep:
    """SparseCross2DNA over context k/v computed once: a video token gathers
    the window around its spatial position in every context frame."""

    def __init__(self, mod: SparseCross2DNA):
        self.mod = mod
        fmap, k, dil = mod.image_size, mod.kernel_size, mod.dilation
        idx, valid = build_nda_indices((fmap, fmap), (k, k), (dil, dil), ("centered",) * 2)
        device = mod.to_q.w.device
        self.sp_idx = torch.as_tensor(idx, dtype=torch.long, device=device)  # (HW, Kn)
        self.sp_valid = torch.as_tensor(valid, device=device)

    def init_cache(self, context, context_mask):
        cache = _CrossAttnStep(self.mod).init_cache(context, context_mask)
        cache["ctx_raw"] = context
        return cache

    def __call__(self, cache, x_i, pos):
        mod = self.mod
        h, dh = mod.heads, mod.dim_head
        b = x_i.shape[0]
        q = mod.to_q(x_i).reshape(b, h, dh) * dh**-0.5
        null_k = whole(mod.null_k).to(q.dtype)[None, :, 0].expand(b, h, dh)
        null_v = whole(mod.null_v).to(q.dtype)[None, :, 0].expand(b, h, dh)
        sim_null = torch.einsum("bhd,bhd->bh", q, null_k)[..., None]
        if pos == 0:  # bos: the whole context, no talking heads
            keys, vals, ok = cache["ck"], cache["cv"], cache["cmask"]
        else:
            tpf = mod.image_size**2
            frames = cache["ck"].shape[2] // tpf
            s = (pos - 1) % tpf
            offsets = torch.arange(frames, device=q.device) * tpf
            flat = (offsets[:, None] + self.sp_idx[s][None]).reshape(-1)  # (F * Kn,)
            keys, vals = cache["ck"][:, :, flat], cache["cv"][:, :, flat]
            ok = cache["cmask"][:, flat] & self.sp_valid[s].repeat(frames)[None]
        sim = torch.einsum("bhd,bhjd->bhj", q, keys)
        sim = masked_fill(sim, ~ok[:, None, :], max_neg_value(sim.dtype))
        attn = stable_softmax(torch.cat([sim_null, sim], dim=-1))
        if pos > 0:
            attn = _th_mix(attn, mod.talking_heads)
        vals = torch.cat([null_v[:, :, None], vals], dim=2)
        out = torch.einsum("bhj,bhjd->bhd", attn.to(vals.dtype), vals)
        return mod.to_out(out.reshape(b, h * dh))

    def prefill(self, cache, x):
        return self.mod(x, context=cache["ctx_raw"], context_mask=cache["cmask"])


class _Sparse3DNAStep:
    def __init__(self, mod: Sparse3DNA, total_video: int):
        if not mod.causal:
            raise ValueError("token-by-token decoding needs causal Sparse3DNA")
        self.mod = mod
        self.total = total_video
        _, fh, fw = mod.video_shape
        frames = -(-total_video // (fh * fw))
        idx, valid = build_nda_indices(
            (frames, fh, fw), mod.kernel, mod.dilations, ("causal",) * 3
        )
        idx = idx[:total_video]
        valid = valid[:total_video] & (idx < total_video)
        device = mod.to_q.w.device
        self.idx = torch.as_tensor(idx, dtype=torch.long, device=device)
        self.valid = torch.as_tensor(valid, device=device)

    def init_cache(self, b, dtype):
        mod = self.mod
        device = mod.to_q.w.device
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
        k_i, v_i = mod.to_kv(x_i).chunk(2, dim=-1)
        k_i, v_i = k_i.reshape(b, h, dh), v_i.reshape(b, h, dh)
        if pos == 0:  # bos fills its slot and adopts its own value
            cache["k_bos"].copy_(k_i)
            cache["v_bos"].copy_(v_i)
            return mod.to_out(v_i.reshape(b, h * dh))

        vpos = pos - 1
        cache["k"][:, :, vpos] = k_i
        cache["v"][:, :, vpos] = v_i
        nb_idx, nb_valid = self.idx[vpos], self.valid[vpos]
        k_nb = cache["k"][:, :, nb_idx]  # (b, h, Kn, dh)
        v_nb = cache["v"][:, :, nb_idx]

        q = mod.to_q(x_i).reshape(b, h, dh) * dh**-0.5
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
        video rows 0..n-2; the output is the module's full forward."""
        mod = self.mod
        b, n, _ = x.shape
        k, v = mod.to_kv(x).chunk(2, dim=-1)
        k = k.reshape(b, n, mod.heads, mod.dim_head).transpose(1, 2)
        v = v.reshape(b, n, mod.heads, mod.dim_head).transpose(1, 2)
        cache["k_bos"].copy_(k[:, :, 0])
        cache["v_bos"].copy_(v[:, :, 0])
        cache["k"][:, :, : n - 1] = k[:, :, 1:]
        cache["v"][:, :, : n - 1] = v[:, :, 1:]
        return mod(x)


class _FFStep:
    """The feed-forward unchunked (a step is one position; a prefill's
    chunks would give the same rows)."""

    def __init__(self, mod: FeedForward):
        self.mod = mod

    def __call__(self, cache, x_i, pos):
        return self.mod.net(x_i)

    def prefill(self, cache, x):
        return self.mod.net(x)


class _ShiftVideoStep:
    """Wraps an inner step and keeps the (b, T_in, dim) input buffer that the
    shifted channels are read from."""

    def __init__(self, wrapper: ShiftVideo, inner_step, total_in: int, dim: int):
        self.w = wrapper
        self.inner = inner_step
        self.total = total_in
        self.dim = dim

    def init_buffer(self, b, dtype, device):
        return torch.zeros(b, self.total, self.dim, dtype=dtype, device=device)

    def __call__(self, cache, x_i, pos):
        buf = cache["shift_buf"]
        buf[:, pos] = x_i
        w = self.w
        if pos > 0 and (w.shift_space or w.shift_time):  # bos passes unshifted
            W = w.image_size
            HW = W * W
            v = pos - 1  # video coordinate of this input position
            # (source position, whether it is in the video) of each shifted
            # chunk, in the order of ``shift_video_tokens``: the same token of
            # the frame before, the token above, the token to the left
            sources = ([(pos - HW, v // HW > 0)] if w.shift_time else []) + (
                [(pos - W, (v % HW) // W > 0), (pos - 1, v % W > 0)] if w.shift_space else [])
            chunks = 5 if w.shift_space and w.shift_time else 4 if w.shift_space else 3
            parts, offset = [], 0
            for (src, ok), size in zip(sources, _torch_chunk_sizes(self.dim, chunks)):
                parts.append(buf[:, src, offset : offset + size] if ok
                             else x_i.new_zeros(x_i.shape[0], size))
                offset += size
            parts.append(x_i[:, offset:])
            x_i = torch.cat(parts, dim=-1)
        return self.inner(cache, x_i, pos)

    def prefill(self, cache, x):
        cache["shift_buf"][:, : x.shape[1]] = x
        w = self.w
        return self.inner.prefill(
            cache, shift_video_tokens(x, w.image_size, w.shift_space, w.shift_time))


class _SandwichStep:
    def __init__(self, sandwich: Sandwich, inner_step):
        self.s = sandwich
        self.inner = inner_step

    def __call__(self, cache, x_i, pos):
        return self.s.post(self.inner(cache, self.s.pre(x_i), pos))

    def prefill(self, cache, x):
        return self.s.post(self.inner.prefill(cache, self.s.pre(x)))


class TransformerDecoder:
    """Incremental decoder for a ``Transformer`` or ``ReversibleTransformer``.
    ``total_in`` is the decoder input length (1 + video tokens). A reversible
    stack decodes its couples as two-stream updates (x1 += f(x2);
    x2 += g(x1)) and the mean of the streams: reversibility saves training
    memory and plays no part at inference."""

    def __init__(self, transformer: Transformer | ReversibleTransformer, total_in: int):
        self.t = transformer
        self.total_in = total_in
        self.couples = isinstance(transformer, ReversibleTransformer)
        layers = transformer.layers
        if self.couples:  # steps f0, g0, f1, g1, ...
            layers = [m for couple in layers for m in (couple.f, couple.g)]
        self.steps = [self._build(layer) for layer in layers]

    def _build(self, sandwich: Sandwich):
        inner = sandwich.inner
        wrapper = None
        if isinstance(inner, ShiftVideo):
            wrapper, inner = inner, inner.inner
        if isinstance(inner, Sparse3DNA):
            step = _Sparse3DNAStep(inner, self.total_in - 1)
        elif isinstance(inner, SparseCross2DNA):
            step = _SparseCross2DNAStep(inner)
        elif isinstance(inner, Attention):
            step = (_DenseSelfStep(inner, self.total_in) if inner.causal
                    else _CrossAttnStep(inner))
        elif isinstance(inner, FeedForward):
            step = _FFStep(inner)
        else:
            raise TypeError(f"no decode step for {type(inner).__name__}")
        if wrapper is not None:
            step = _ShiftVideoStep(wrapper, step, self.total_in, self.t.dim)
        return _SandwichStep(sandwich, step)

    def init_cache(self, b, context, context_mask, dtype=torch.float32):
        device = self.t.norm.norm.g.device
        caches = []
        for step in self.steps:
            c = {}
            inner = step.inner
            if isinstance(inner, _ShiftVideoStep):
                c["shift_buf"] = inner.init_buffer(b, dtype, device)
                inner = inner.inner
            if isinstance(inner, (_DenseSelfStep, _Sparse3DNAStep)):
                c.update(inner.init_cache(b, dtype))
            elif isinstance(inner, (_CrossAttnStep, _SparseCross2DNAStep)):
                c.update(inner.init_cache(context, context_mask))
            caches.append(c)
        return caches

    def _run(self, caches, x, call):
        """The stack over ``x`` with ``call(step, cache, x)`` for each block."""
        if not self.couples:
            for step, cache in zip(self.steps, caches):
                x = x + call(step, cache, x)
            return x
        x1 = x2 = x
        for i in range(0, len(self.steps), 2):
            x1 = x1 + call(self.steps[i], caches[i], x2)
            x2 = x2 + call(self.steps[i + 1], caches[i + 1], x1)
        return (x1 + x2) * 0.5

    def prefill(self, caches, x):
        """Run inputs ``x`` (b, n, dim), positions 0..n-1, in one pass,
        leaving the caches as n incremental steps would."""
        self._run(caches, x, lambda step, cache, x: step.prefill(cache, x))
        return caches

    def step(self, caches, x_i, pos):
        """x_i: (b, dim) input at position ``pos``; returns the normed output."""
        return self.t.norm(self._run(caches, x_i, lambda step, cache, x: step(cache, x, pos)))
