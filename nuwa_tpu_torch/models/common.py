"""Shared sampling machinery: the cached AR rollout and the full-forward
loop (``method="full"``), the sliding-window frame decoders of both methods
and the codec's decode of sampled ids. Counterpart of
``nuwa_tpu/models/common.py`` and of ``_long_frame_full_fn`` in
``nuwa_tpu/models/nuwa.py``; a Python loop over positions takes the place
of ``lax.scan``.

Classifier-free guidance runs cond and uncond as one 2x batch: the caches,
or each full forward, see the context mask ``[mask; zeros]``. The frame
decoders take any model with NUWA's attribute names (``NUWA``,
``NUWASketch``). Logits heads are read through ``utils.quantize.head_logits``,
so an int8 model samples the same way.
"""
from __future__ import annotations

import torch

from ..decode import TransformerDecoder
from ..ops.sampling import gumbel_sample, top_k_filter
from ..core.tp import whole
from ..utils.quantize import head_logits


def cached_ar_rollout(*, dec, caches, embed_table, pos_emb, bos_vec, to_logits,
                      batch, total, generator, filter_thres, temperature,
                      cond_scale, dim, dtype=None, start_pos=0, init_prev=None):
    """Sample ``total`` tokens at positions [start_pos, start_pos + total),
    one cached decoder step each; ``init_prev`` is the token before
    ``start_pos`` when resuming after a prefill. Returns (batch, total)."""
    use_cfg = cond_scale != 1
    prev = init_prev
    if prev is None:
        prev = torch.zeros(batch, dtype=torch.long, device=embed_table.device)
    samples = []
    for i in range(start_pos, start_pos + total):
        if i == 0:
            x_i = bos_vec.expand(batch, dim)
        else:
            x_i = embed_table[prev] + pos_emb[i - 1]
        if dtype is not None:
            x_i = x_i.to(dtype)
        if use_cfg:
            x_i = torch.cat([x_i, x_i], dim=0)
        y = dec.step(caches, x_i, i)
        logits = head_logits(y, to_logits)
        if use_cfg:
            cond, uncond = logits[:batch], logits[batch:]
            logits = uncond + (cond - uncond) * cond_scale
        filtered = top_k_filter(logits, thres=filter_thres)
        prev = gumbel_sample(filtered, temperature, generator=generator)
        samples.append(prev)
    return torch.stack(samples, dim=1)


def long_frame_decoder(model, window, ctx, cmask, pos_emb, *, generator,
                       filter_thres, temperature, cond_scale):
    """Decode the next frame of a sliding-window rollout. ``window``:
    (b, W) prior tokens. One prefill re-primes fresh caches over
    [bos, window[:, :W-1]] (positions 0..W-1); then one cached step per token
    of the new frame. Returns (b, tokens_per_frame)."""
    b, W = window.shape
    use_cfg = cond_scale != 1
    dec = TransformerDecoder(model.video_transformer, total_in=model.max_video_tokens)
    cache_dtype = model.dtype or torch.float32
    caches = dec.init_cache(2 * b if use_cfg else b, ctx, cmask, dtype=cache_dtype)
    table = whole(model.image_embedding.table)
    emb = table[window[:, : W - 1]] + pos_emb[: W - 1][None]
    bos = model.video_bos.expand(b, 1, model.dim)
    x = torch.cat([bos, emb], dim=1)
    if use_cfg:
        x = torch.cat([x, x], dim=0)
    dec.prefill(caches, x.to(cache_dtype))
    return cached_ar_rollout(
        dec=dec, caches=caches, embed_table=table, pos_emb=pos_emb,
        bos_vec=model.video_bos, to_logits=model.to_logits, batch=b,
        total=model.tokens_per_frame, generator=generator,
        filter_thres=filter_thres, temperature=temperature,
        cond_scale=cond_scale, dim=model.dim, dtype=model.dtype,
        start_pos=W, init_prev=window[:, -1],
    )


def ar_decode_loop(*, indices, start, stop=None, step_logits_fn, generator, filter_thres,
                   temperature, cond_scale):
    """The full-forward AR loop (``method="full"``): fills ``indices[:,
    start:stop]`` in place, one position at a time, and returns ``indices``.
    ``step_logits_fn(indices, i)`` returns (cond logits (b, V), uncond logits
    or None) at position i; the entries at i and later are still 0 and,
    through causal attention, cannot reach position i."""
    for i in range(start, indices.shape[1] if stop is None else stop):
        logits, uncond = step_logits_fn(indices, i)
        if cond_scale != 1 and uncond is not None:
            logits = uncond + (logits - uncond) * cond_scale
        filtered = top_k_filter(logits, thres=filter_thres)
        indices[:, i] = gumbel_sample(filtered, temperature, generator=generator)
    return indices


def full_ar_rollout(model, ctx, cmask, indices, start=0, **sampling):
    """Fills ``indices[:, start:]`` (b, n) of a single-tower model by
    ``method="full"``: each token re-runs the decoder over the whole (b,
    n - 1) input, under CFG one call on the doubled batch (``ctx`` and
    ``cmask`` already doubled)."""
    b, n = indices.shape
    use_cfg = sampling["cond_scale"] != 1

    def step_logits(indices, i):
        inp = indices[:, : n - 1]
        if use_cfg:
            row = model._decode_logits(torch.cat([inp, inp]), ctx, cmask)[:, i]
            return row[:b], row[b:]
        return model._decode_logits(inp, ctx, cmask)[:, i], None

    return ar_decode_loop(indices=indices, start=start, step_logits_fn=step_logits, **sampling)


def long_frame_full(model, window, ctx, cmask, **sampling):
    """``method="full"``'s next frame of a sliding-window rollout: each of
    the frame's tokens re-runs the decoder over the whole window of
    max_video_frames frames (the reference's pattern, the JAX package's
    oracle). ``window``: (b, W) prior tokens. Returns (b, tokens_per_frame)."""
    b, W = window.shape
    buf = torch.cat([window, window.new_zeros(b, model.tokens_per_frame)], dim=1)
    return full_ar_rollout(model, ctx, cmask, buf, W, **sampling)[:, W:]


def ids_to_output(vae, indices, decode_video, decode_max_batchsize):
    """Sampled ids (b, n), or with a ``vae`` and ``decode_video`` their
    pixels (b, n // HW, c, h, w), decoded ``decode_max_batchsize`` chunks at
    a time."""
    if not decode_video or vae is None:
        return indices
    return vae.codebook_indices_to_video(indices, decode_chunks=decode_max_batchsize)
