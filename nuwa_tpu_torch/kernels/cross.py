"""SparseCross2DNA attention: the Hopper kernels' wrappers, their plain
versions and the autograd function that joins them.

Three kernels replace the cross kernels of ``nuwa_tpu/kernels/nda_pallas.py``:

* ``sparse_cross_2dna_fwd`` (``csrc/sparse_cross2dna_fwd.cu``): the forward,
  out and the per-row logsumexp; replaces ``_xfused_kernel`` (two or more
  context frames) and ``_xfused1_kernel`` (one), both launched by
  ``_xfused_fwd_call``;
* ``sparse_cross_2dna_bwd_q`` (``csrc/sparse_cross2dna_bwd_q.cu``): the
  query-side backward, dq, the null-key/value and talking-heads cotangents,
  and the sparse dS and mixed probabilities;
* ``sparse_cross_2dna_bwd_kv`` (``csrc/sparse_cross2dna_bwd_kv.cu``): the
  key-side backward, dk and dv gathered from dS and the mixed probabilities.
  With the query side it replaces the fused backward ``_xfused_bwd_kernel``
  (launched by ``_xfused_bwd_call``).

They also take the place of the per-frame fallback ``_cross_core_op`` (and
its backward), which the JAX package takes when the fused kernels' score
cache does not fit VMEM: the Hopper kernels read each query's window
directly at any context length.

Each launch is planned on the host (``launch_plan``, by
``kernels.nda.tile_plan``): the forward's and the query side's blocks own
tiles of query positions with all heads (the forward's may span query
frames, which read the same window), the key side's tiles of context keys
of one or more heads (``FWD_TILES``, ``TILES``, ``KV_TILES``).

Every video query at spatial position (y, x) of any frame attends the null
key/value and the centered kernel neighbourhood around (y, x) in every
context frame, where the context mask allows it; the softmax is fp32, the
talking-heads matrix mixes the normalised probabilities across heads (null
column included) before they weight the values. The bos query's full-context
attention stays in plain PyTorch in the module (``nuwa_tpu_torch.nda``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its ``*_plain`` version, the gather math of the JAX package's
``SparseCross2DNA`` in fp32 (the backward's written out with gathers and
``index_add_``, not autograd of the plain forward). ``sparse_cross_2dna`` is
the differentiable op: a ``torch.autograd.Function`` whose forward is
``sparse_cross_2dna_fwd`` and whose backward runs the query side and then
the key side, as ``_xfused_core_op`` does with its two Pallas kernels.

Attention dropout: every function here takes ``dropout=(rate, seed)``
(None, a rate of 0 or a seed of None: no dropout, the launch that runs
without it). The mask is the Sparse3DNA kernels' (``kernels.nda``): inverted
dropout on the mixed probabilities of the non-bos video queries, after the
talking-heads mix and before PV, keyed by the counter hash of (seed, batch
row, head, query, key), the query being the video token after bos (0..t-1),
the key the context token (frame * HW + y * fmap + x) and the null column's
key -2, as the fused Pallas kernels key it (``_keep_mask_abs`` at
nda_pallas.py:2759, :2844 and :2906, the backward's query ids absolute in
every chunk of query frames). The forward's ``lse`` is the undropped
softmax's; the query-side backward masks the cotangent of the mix and
returns the dropped mix, so the key side is the same function with or
without dropout (its ``dropout`` argument only counts the launch). A
dropout launch adds one to its wrapper's ``mode_launches["dropout"]``.
"""
from __future__ import annotations

import functools

import torch

from .nda import FILL
from .nda import TILES as _NDA_TILES
from .nda import _DTYPES, _drop_args, _dropout, _dropped, _gathered, _launch, _plan_args

# the query side's tile candidates, first choice first: 2 x 4 query positions
# measured 7-9% faster than the Sparse3DNA kernels' first choice, 2 x 2, on an
# H100 at the sketch shapes (kernel_ab.py tiles), then those kernels' own
TILES = ((2, 4, 0), *_NDA_TILES)
# the forward's: (rows, columns of query positions, 0, query frames a tile),
# taken where they give at least FWD_FILL blocks an SM. On an H100 80GB HBM3
# at 700 W at the sketch shapes (kernel_ab.py tiles) the grid's fill
# decided (2 x 4 with 320 blocks 23-27% slower than 2 x 2 with 640 at the
# forward shape), then 2 x 2 positions of two query frames 5% faster than
# of one, and 1-3% faster than 2 x 4 of one at the same fill
FWD_TILES = ((2, 2, 0, 2), (2, 2, 0, 1), (1, 2, 0, 1), (1, 1, 0, 1))
FWD_FILL = 4
# the key side's: (rows, columns of context keys, 0, heads a block), one
# head a block. The largest tile that gives two blocks an SM measured
# fastest on an H100 80GB HBM3 at 700 W at the sketch shapes (4 x 4 15-16%
# faster than 2 x 4 at Lc 512, where 2 x 4's grid runs in two waves; 2 x 4
# 17-25% faster than 4 x 4 at Lc 256, where 4 x 4's does not fill the card)
KV_TILES = ((4, 4, 0, 1), (2, 4, 0, 1), (1, 1, 0, 1))
_CANDIDATES = {"cross_fwd": FWD_TILES, "cross_bwd_q": TILES, "cross_bwd_kv": KV_TILES}


@functools.lru_cache(maxsize=64)
def _context_table(fmap, kernel_size, dilation, frames, device):
    """(HW, frames * Kn) context token ids around each spatial position,
    frame-major, and their in-frame validity (a centered 2D window)."""
    from ..nda import build_nda_indices

    hw = fmap * fmap
    idx, valid = build_nda_indices(
        (fmap, fmap), (kernel_size,) * 2, (dilation,) * 2, ("centered",) * 2
    )
    idx = torch.as_tensor(idx, dtype=torch.long, device=device)
    valid = torch.as_tensor(valid, device=device)
    offsets = torch.arange(frames, device=device) * hw
    tokens = (offsets[None, :, None] + idx[:, None, :]).reshape(hw, -1)
    return tokens, valid.repeat(1, frames)


def valid_pairs(t, cmask, *, fmap, kernel_size, dilation) -> int:
    """How many (query, context key) pairs of the op are valid: in the frame
    and allowed by ``cmask`` (b, Lc), summed over the batch."""
    frames = cmask.shape[1] // (fmap * fmap)
    tokens, valid = _context_table(fmap, kernel_size, dilation, frames, str(cmask.device))
    ok = cmask[:, tokens] & valid  # (b, HW, frames * Kn)
    per_position = ok.sum(-1)  # (b, HW)
    s = torch.arange(t, device=cmask.device) % (fmap * fmap)
    return int(per_position[:, s].sum())


def _slots(q, fmap, kernel_size, dilation, lc, cmask):
    """Each query's context token ids (t, Fc * k * k), frame-major, and
    whether each may be attended ((b or 1), t, Fc * k * k): in the frame and
    allowed by ``cmask``."""
    t = q.shape[2]
    tokens, valid = _context_table(fmap, kernel_size, dilation, lc // (fmap * fmap),
                                   str(q.device))
    s = torch.arange(t, device=q.device) % (fmap * fmap)  # each query's spatial position
    ok = valid[s][None]
    if cmask is not None:
        ok = ok & cmask[:, tokens[s]]
    return tokens[s], ok


def _scores(q, k, null_k, tokens, ok):
    """(b, h, t, Fc * k * k + 1) fp32 scores of each query's slots, the null
    key in slot 0, -inf where a slot may not be attended; and the gathered
    keys. The forward and the backward score with this one expression, so a
    row whose context is all masked gets lse equal to its null score and
    P = exp(0) = 1 exactly there, and dS = 0, as the kernels give it."""
    keys = _gathered(k, tokens, null_k)
    sim = torch.einsum("bhid,bhijd->bhij", q.float(), keys)
    slot_ok = torch.cat([ok.new_ones(ok.shape[:-1] + (1,)), ok], dim=-1)
    return sim.masked_fill(~slot_ok[:, None], float("-inf")), keys


def sparse_cross_2dna_fwd_plain(q, k, v, null_k, null_v, talking_heads, cmask=None,
                                *, fmap, kernel_size, dilation, dropout=None):
    """Plain PyTorch version of the kernel (fp32 math); same arguments and
    results as ``sparse_cross_2dna_fwd``."""
    dropout = _dropout(dropout)
    tokens, ok = _slots(q, fmap, kernel_size, dilation, k.shape[2], cmask)
    sim, _ = _scores(q, k, null_k, tokens, ok)
    lse = torch.logsumexp(sim, dim=-1)
    attn = torch.softmax(sim, dim=-1)
    attn = _dropped(torch.einsum("bhij,gh->bgij", attn, talking_heads.float()), dropout,
                    tokens)
    out = torch.einsum("bhij,bhijd->bhid", attn, _gathered(v, tokens, null_v))
    return out.to(q.dtype), lse


def sparse_cross_2dna_fwd(q, k, v, null_k, null_v, talking_heads, cmask=None,
                          *, fmap, kernel_size, dilation, dropout=None, tiles=None):
    """SparseCross2DNA attention of t video queries (the bos query left out)
    over their centered 2D neighbourhoods in every context frame, plus the
    null key/value.

    q (pre-scaled by dim_head**-0.5): (b, h, t, d); k, v: (b, h, Lc, d), Lc a
    whole number of fmap x fmap context frames; null_k, null_v: (b, h, 1, d);
    talking_heads: (h, h); cmask: (b, Lc) bool, True where a context token
    may be attended, or None for all; fmap: the frames' side; kernel_size,
    dilation: the window's side and step; dropout: (rate, seed) or None.
    Returns out (b, h, t, d) in q's dtype and lse (b, h, t) in fp32, the
    undropped softmax's. ``tiles``: (rows, columns, 0, query frames) tiles of
    query positions taken in place of ``FWD_TILES``, the first that fits
    the frame, else the last.
    """
    dropout = _dropout(dropout)
    if q.device.type == "cpu":
        return sparse_cross_2dna_fwd_plain(
            q, k, v, null_k, null_v, talking_heads, cmask,
            fmap=fmap, kernel_size=kernel_size, dilation=dilation, dropout=dropout,
        )
    th, mask = _check_cuda("sparse_cross_2dna_fwd", q, k, v, null_k, null_v, talking_heads,
                           cmask, fmap=fmap, kernel_size=kernel_size)
    b, h, t, d = q.shape
    lc = k.shape[2]
    ins = [x.contiguous() for x in (q, k, v, null_k, null_v)]
    out = torch.empty_like(ins[0])
    lse = torch.empty(b, h, t, device=q.device, dtype=torch.float32)
    if t == 0:
        return out, lse
    _, plan_arg = _plan("cross_fwd", q, lc, fmap, kernel_size, dilation, [*ins, out], tiles)
    _launch("sparse_cross2dna_fwd", q.dtype,
            [*(x.data_ptr() for x in ins), th.data_ptr(), _ptr(mask), out.data_ptr(),
             lse.data_ptr()],
            [b, h, t, d, lc, fmap, kernel_size, dilation, *_drop_args(dropout)], q.device,
            [plan_arg])
    _count(sparse_cross_2dna_fwd, dropout)
    return out, lse


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _count(fn, dropout):
    """One launch of ``fn``'s kernel: its count and, with dropout, its
    dropout count."""
    fn.launches += 1
    if dropout is not None:
        fn.mode_launches["dropout"] += 1


def _check_cuda(name, q, k, v, null_k, null_v, talking_heads, cmask, *, fmap, kernel_size,
                more=()):
    """Raise on anything the kernels do not take; ``more``: (name, tensor,
    shape, dtype) to check beside the forward's arguments. Returns the
    talking-heads matrix as contiguous fp32 and the mask as contiguous
    bytes (or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    b, h, t, d = q.shape
    lc, hw = k.shape[2], fmap * fmap
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {q.dtype}")
    if not (1 <= h <= 32 and 1 <= d <= 256):
        raise ValueError(f"need 1 <= heads <= 32 and 1 <= dim_head <= 256, got {h}, {d}")
    if lc == 0 or lc % hw or kernel_size % 2 == 0:
        raise ValueError(f"need whole context frames of {hw} tokens and an odd kernel, "
                         f"got Lc={lc}, kernel {kernel_size}")
    ctx, null = (b, h, lc, d), (b, h, 1, d)
    for arg, x, shape, dtype in (
        ("k", k, ctx, q.dtype), ("v", v, ctx, q.dtype),
        ("null_k", null_k, null, q.dtype), ("null_v", null_v, null, q.dtype),
        ("cmask", cmask, (b, lc), torch.bool), *more,
    ):
        if x is None:
            continue
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != q.device:
            raise ValueError(f"{name}: {arg} must be {shape} {dtype} on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    th = talking_heads.to(device=q.device, dtype=torch.float32).contiguous()
    if tuple(th.shape) != (h, h):
        raise ValueError(f"talking_heads: expected {(h, h)}, got {tuple(th.shape)}")
    return th, cmask.contiguous() if cmask is not None else None


def sparse_cross_2dna_bwd_q_plain(q, k, v, null_k, null_v, talking_heads, cmask, grad, lse,
                                  *, fmap, kernel_size, dilation, dropout=None):
    """Plain PyTorch version of the query-side backward kernel (fp32 math);
    same arguments and results as ``sparse_cross_2dna_bwd_q``."""
    dropout = _dropout(dropout)
    tokens, ok = _slots(q, fmap, kernel_size, dilation, k.shape[2], cmask)
    qf, gf, th = q.float(), grad.float(), talking_heads.float()
    sim, keys = _scores(q, k, null_k, tokens, ok)
    vals = _gathered(v, tokens, null_v)
    p = torch.exp(sim - lse[..., None])
    # the cotangent of the (undropped) mix, and the mix that weighted the values
    da = _dropped(torch.einsum("bhid,bhijd->bhij", gf, vals), dropout, tokens)
    dp = torch.einsum("bgij,gh->bhij", da, th)  # through the talking-heads mix
    mix = _dropped(torch.einsum("bhij,gh->bgij", p, th), dropout, tokens)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))  # through the softmax
    dq = torch.einsum("bhij,bhijd->bhid", ds, keys)
    dth = torch.einsum("bgij,bhij->gh", da, p)
    dnull_k = torch.einsum("bhi,bhid->bhd", ds[..., 0], qf)[:, :, None]
    dnull_v = torch.einsum("bhi,bhid->bhd", mix[..., 0], gf)[:, :, None]
    return dq.to(q.dtype), ds, mix, dnull_k, dnull_v, dth


def sparse_cross_2dna_bwd_kv_plain(q, grad, ds, mix, *, fmap, kernel_size, dilation,
                                   dropout=None):
    """Plain PyTorch version of the key-side backward kernel (fp32 math);
    same arguments and results as ``sparse_cross_2dna_bwd_kv`` (the ``mix``
    it is given is the dropped one, so ``dropout`` changes nothing)."""
    b, h, t, d = q.shape
    frames = (ds.shape[-1] - 1) // kernel_size**2
    lc = frames * fmap * fmap
    tokens, ok = _slots(q, fmap, kernel_size, dilation, lc, None)
    flat = tokens.reshape(-1)
    out = []
    for w, x in ((ds, q), (mix, grad)):
        w = w[..., 1:].masked_fill(~ok, 0.0)
        terms = (w[..., None] * x.float()[:, :, :, None, :]).reshape(b, h, -1, d)
        out.append(terms.new_zeros(b, h, lc, d).index_add_(2, flat, terms))
    return out[0].to(q.dtype), out[1].to(q.dtype)


def _plan(which, q, lc, fmap, kernel_size, dilation, tensors, tiles):
    """(plan dict, ctypes int array) of the forward (``which="cross_fwd"``),
    the query side (``"cross_bwd_q"``): tiles of query positions of one
    video frame (the forward's of ``tf`` frames), with the window (Fc, k, k)
    of the Fc context frames; or the key side (``"cross_bwd_kv"``): tiles of
    keys of one context frame and ``hs`` heads, with each key's reflected
    k x k window. By the Sparse3DNA kernels' rule (``kernels.nda.tile_plan``)
    over the kernel's candidates (``FWD_TILES`` at ``FWD_FILL``, ``TILES``,
    ``KV_TILES``), or ``tiles`` in their place with the fill rule off."""
    key_side = which == "cross_bwd_kv"
    geometry = dict(fmap=(fmap, fmap), dilation=(1, dilation, dilation), mode="centered",
                    kernel=(1 if key_side else lc // (fmap * fmap), kernel_size, kernel_size))
    return _plan_args(which, q, geometry, tensors, tiles, _CANDIDATES[which],
                      t=lc if key_side else None,
                      fill=FWD_FILL if which == "cross_fwd" else FILL)


def launch_plan(q, lc, *, fmap, kernel_size, dilation, tiles=None, which="cross_bwd_q"):
    """The plan with which the query side (``which="cross_bwd_q"``), the
    forward (``"cross_fwd"``) or the key side (``"cross_bwd_kv"``) launches
    on q (b, h, t, d) against Lc context tokens, given its ``tiles``
    argument."""
    return _plan(which, q, lc, fmap, kernel_size, dilation, [q], tiles)[0]


def sparse_cross_2dna_bwd_q(q, k, v, null_k, null_v, talking_heads, cmask, grad, lse,
                            *, fmap, kernel_size, dilation, dropout=None, tiles=None):
    """Query side of the SparseCross2DNA backward.

    Takes the forward's arguments (its dropout too), its output cotangent
    ``grad`` (b, h, t, d, q's dtype) and its ``lse``. Returns dq (q's dtype),
    dS and the mixed probabilities mix, dropped with dropout (both (b, h, t,
    Fc * k * k + 1) fp32, slot 0 being the null key, a masked or
    out-of-frame slot 0 in both), dnull_k and dnull_v (b, h, 1, d) fp32, one
    sum per batch row, and dth (h, h) fp32. ``tiles``: (rows, columns, 0)
    tiles of query positions taken in place of ``TILES``, the first that
    fits the frame, else the last.
    """
    dropout = _dropout(dropout)
    if q.device.type == "cpu":
        return sparse_cross_2dna_bwd_q_plain(
            q, k, v, null_k, null_v, talking_heads, cmask, grad, lse,
            fmap=fmap, kernel_size=kernel_size, dilation=dilation, dropout=dropout,
        )
    b, h, t, d = q.shape
    lc = k.shape[2]
    th, mask = _check_cuda(
        "sparse_cross_2dna_bwd_q", q, k, v, null_k, null_v, talking_heads, cmask,
        fmap=fmap, kernel_size=kernel_size,
        more=[("grad", grad, (b, h, t, d), q.dtype), ("lse", lse, (b, h, t), torch.float32)],
    )
    slots = lc // (fmap * fmap) * kernel_size**2 + 1
    ins = [x.contiguous() for x in (q, k, v, null_k, null_v)]
    grad, lse = grad.contiguous(), lse.contiguous()
    dq = torch.empty_like(ins[0])
    ds = torch.empty(b, h, t, slots, device=q.device, dtype=torch.float32)
    mix = torch.empty_like(ds)
    # each tile's sums over its queries: [dth | dnull_k | dnull_v], one slot
    # a block of the plan's grid
    hh, hd = h * h, h * d
    plan, plan_arg = _plan("cross_bwd_q", q, lc, fmap, kernel_size, dilation,
                           [*ins, grad, dq], tiles)
    partial = torch.empty(b, plan["blocks"] if t > 0 else 0, hh + 2 * hd, device=q.device,
                          dtype=torch.float32)
    if t > 0:
        _launch("sparse_cross2dna_bwd_q", q.dtype,
                [*(x.data_ptr() for x in ins), th.data_ptr(), _ptr(mask), grad.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), ds.data_ptr(), mix.data_ptr(),
                 partial.data_ptr()],
                [b, h, t, d, lc, fmap, kernel_size, dilation, *_drop_args(dropout)], q.device,
                [plan_arg])
        _count(sparse_cross_2dna_bwd_q, dropout)
    sums = partial.sum(dim=1)  # one fixed-order reduction over the blocks: (b, nsum)
    dth = sums[:, :hh].sum(dim=0).view(h, h)
    dnull_k = sums[:, hh:hh + hd].reshape(b, h, 1, d)
    dnull_v = sums[:, hh + hd:].reshape(b, h, 1, d)
    return dq, ds, mix, dnull_k, dnull_v, dth


def sparse_cross_2dna_bwd_kv(q, grad, ds, mix, *, fmap, kernel_size, dilation,
                             dropout=None, tiles=None):
    """Key side of the SparseCross2DNA backward: dk and dv (b, h, Lc, d,
    q's dtype) from q, the output cotangent ``grad`` and the ``ds`` and
    ``mix`` that ``sparse_cross_2dna_bwd_q`` returned (Lc follows from their
    slots). Those carry the forward's dropout, so the function is the same
    with or without it; ``dropout`` only counts the launch as a dropout
    launch. ``tiles``: (rows, columns, 0, heads a block) tiles of context
    keys taken in place of ``KV_TILES``, the first that fits the frame, else
    the last."""
    dropout = _dropout(dropout)
    if q.device.type == "cpu":
        return sparse_cross_2dna_bwd_kv_plain(
            q, grad, ds, mix, fmap=fmap, kernel_size=kernel_size, dilation=dilation
        )
    if q.device.type != "cuda":
        raise ValueError(f"sparse_cross_2dna_bwd_kv runs on cuda or cpu, not {q.device}")
    b, h, t, d = q.shape
    kk = kernel_size**2
    if q.dtype not in _DTYPES:
        raise TypeError(f"sparse_cross_2dna_bwd_kv takes float32 or bfloat16, not {q.dtype}")
    if ds.ndim != 4 or (ds.shape[-1] - 1) % kk or ds.shape[-1] == 1:
        raise ValueError(f"ds: expected (b, h, t, Fc * {kk} + 1), got {tuple(ds.shape)}")
    slots = tuple(ds.shape)
    for arg, x, shape, dtype in (
        ("grad", grad, (b, h, t, d), q.dtype),
        ("ds", ds, (b, h, t, slots[-1]), torch.float32),
        ("mix", mix, (b, h, t, slots[-1]), torch.float32),
    ):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != q.device:
            raise ValueError(f"sparse_cross_2dna_bwd_kv: {arg} must be {shape} {dtype} on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if not (1 <= h <= 32 and 1 <= d <= 256):
        raise ValueError(f"need 1 <= heads <= 32 and 1 <= dim_head <= 256, got {h}, {d}")
    lc = (slots[-1] - 1) // kk * fmap * fmap
    ins = [x.contiguous() for x in (q, grad, ds, mix)]
    if t == 0:
        return q.new_zeros(b, h, lc, d), q.new_zeros(b, h, lc, d)
    dk = q.new_empty(b, h, lc, d)  # every key's row is written
    dv = torch.empty_like(dk)
    _, plan_arg = _plan("cross_bwd_kv", q, lc, fmap, kernel_size, dilation,
                        [*ins[:2], dk, dv], tiles)
    _launch("sparse_cross2dna_bwd_kv", q.dtype,
            [*(x.data_ptr() for x in ins), dk.data_ptr(), dv.data_ptr()],
            [b, h, t, d, lc, fmap, kernel_size, dilation], q.device, [plan_arg])
    _count(sparse_cross_2dna_bwd_kv, dropout)
    return dk, dv


def reset_launches():
    """Set every kernel's launch count, and its count with dropout, to 0."""
    for fn in (sparse_cross_2dna_fwd, sparse_cross_2dna_bwd_q, sparse_cross_2dna_bwd_kv):
        fn.launches = 0
        fn.mode_launches = {"dropout": 0}


# kernel launches since the counts were last reset, in all and with dropout
reset_launches()


def sparse_cross_2dna_bwd(q, k, v, null_k, null_v, talking_heads, cmask, grad, lse,
                          *, fmap, kernel_size, dilation, dropout=None):
    """The whole SparseCross2DNA backward: the query side, then the key side.
    Returns dq, dk, dv (q's dtype), dnull_k, dnull_v ((b, h, 1, d), one sum
    per batch row) and dth (h, h), the last three in fp32."""
    geo = dict(fmap=fmap, kernel_size=kernel_size, dilation=dilation, dropout=dropout)
    dq, ds, mix, dnull_k, dnull_v, dth = sparse_cross_2dna_bwd_q(
        q, k, v, null_k, null_v, talking_heads, cmask, grad, lse, **geo
    )
    dk, dv = sparse_cross_2dna_bwd_kv(q, grad, ds, mix, **geo)
    return dq, dk, dv, dnull_k, dnull_v, dth


def sparse_cross_2dna_bwd_plain(q, k, v, null_k, null_v, talking_heads, cmask, grad, lse,
                                *, fmap, kernel_size, dilation, dropout=None):
    """``sparse_cross_2dna_bwd`` from the plain versions of its two kernels."""
    geo = dict(fmap=fmap, kernel_size=kernel_size, dilation=dilation, dropout=dropout)
    dq, ds, mix, dnull_k, dnull_v, dth = sparse_cross_2dna_bwd_q_plain(
        q, k, v, null_k, null_v, talking_heads, cmask, grad, lse, **geo
    )
    dk, dv = sparse_cross_2dna_bwd_kv_plain(q, grad, ds, mix, **geo)
    return dq, dk, dv, dnull_k, dnull_v, dth


class SparseCross2DNAFunction(torch.autograd.Function):
    """Differentiable SparseCross2DNA: the forward kernel saves only ``lse``
    beside its inputs; the backward recomputes the probabilities query-side
    and gathers dk and dv key-side. The null key/value gradients come back
    per batch row, and autograd sums them through the ``expand`` that made
    the (b, h, 1, d) null rows from the parameters. The dropout (rate, seed)
    is kept beside the geometry: the backward draws the forward's mask again
    from it."""

    @staticmethod
    def forward(ctx, q, k, v, null_k, null_v, talking_heads, cmask, geometry, dropout):
        out, lse = sparse_cross_2dna_fwd(q, k, v, null_k, null_v, talking_heads, cmask,
                                         dropout=dropout, **geometry)
        ctx.save_for_backward(q, k, v, null_k, null_v, talking_heads, cmask, lse)
        ctx.geometry, ctx.dropout = geometry, dropout
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, null_k, null_v, th, cmask, lse = ctx.saved_tensors
        dq, dk, dv, dnull_k, dnull_v, dth = sparse_cross_2dna_bwd(
            q, k, v, null_k, null_v, th, cmask, grad.to(q.dtype), lse, dropout=ctx.dropout,
            **ctx.geometry
        )
        return (dq, dk, dv, dnull_k.to(null_k.dtype), dnull_v.to(null_v.dtype),
                dth.to(th.dtype), None, None, None)


def sparse_cross_2dna(q, k, v, null_k, null_v, talking_heads, cmask=None,
                      *, fmap, kernel_size, dilation, dropout=None):
    """``sparse_cross_2dna_fwd``'s output, differentiable in every tensor
    argument but the mask, with or without dropout ((rate, seed) or None)."""
    geometry = dict(fmap=fmap, kernel_size=kernel_size, dilation=dilation)
    return SparseCross2DNAFunction.apply(q, k, v, null_k, null_v, talking_heads, cmask,
                                         geometry, _dropout(dropout))
