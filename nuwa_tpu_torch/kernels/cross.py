"""SparseCross2DNA attention: the Hopper kernel's wrapper and its plain
version.

``sparse_cross_2dna_fwd`` (``csrc/sparse_cross2dna_fwd.cu``) replaces the
fused cross forward of ``nuwa_tpu/kernels/nda_pallas.py``: ``_xfused_kernel``
(two or more context frames) and ``_xfused1_kernel`` (one), both launched by
``_xfused_fwd_call``, and the per-frame fallback ``_cross_core_op`` that the
JAX package takes when the fused kernels' score cache does not fit VMEM. The
Hopper kernel reads each query's neighbours directly at any context length,
so one kernel covers all three.

Every video query at spatial position (y, x) of any frame attends the null
key/value and the centered kernel neighbourhood around (y, x) in every
context frame, where the context mask allows it; the softmax is fp32, the
talking-heads matrix mixes the normalised probabilities across heads (null
column included) before they weight the values. The bos query's full-context
attention stays in plain PyTorch in the module (``nuwa_tpu_torch.nda``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs ``sparse_cross_2dna_fwd_plain``, the gather math of the JAX
package's ``SparseCross2DNA`` in fp32. The gradient belongs to the next
slice (NUWASketch training, with the fused cross backward): on a CUDA tensor
that requires grad the wrapper raises rather than fall back to autograd of
the plain version.
"""
from __future__ import annotations

import functools

import torch

from .nda import _DTYPES, _launch


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


def sparse_cross_2dna_fwd_plain(q, k, v, null_k, null_v, talking_heads, cmask=None,
                                *, fmap, kernel_size, dilation):
    """Plain PyTorch version of the kernel (fp32 math); same arguments and
    results as ``sparse_cross_2dna_fwd``."""
    b, h, t, d = q.shape
    hw = fmap * fmap
    tokens, valid = _context_table(
        fmap, kernel_size, dilation, k.shape[2] // hw, str(q.device)
    )
    s = torch.arange(t, device=q.device) % hw  # each query's spatial position
    ok = valid[s][None]
    if cmask is not None:
        ok = ok & cmask[:, tokens[s]]
    qf = q.float()
    sim = torch.einsum("bhid,bhijd->bhij", qf, k.float()[:, :, tokens[s]])
    sim = sim.masked_fill(~ok[:, None], float("-inf"))
    sim_null = torch.einsum("bhid,bhd->bhi", qf, null_k.float()[:, :, 0])
    sim = torch.cat([sim_null[..., None], sim], dim=-1)
    lse = torch.logsumexp(sim, dim=-1)
    attn = torch.softmax(sim, dim=-1)
    attn = torch.einsum("bhij,gh->bgij", attn, talking_heads.float())
    out = attn[..., :1] * null_v.float()
    out = out + torch.einsum("bhij,bhijd->bhid", attn[..., 1:], v.float()[:, :, tokens[s]])
    return out.to(q.dtype), lse


def sparse_cross_2dna_fwd(q, k, v, null_k, null_v, talking_heads, cmask=None,
                          *, fmap, kernel_size, dilation):
    """SparseCross2DNA attention of t video queries (the bos query left out)
    over their centered 2D neighbourhoods in every context frame, plus the
    null key/value.

    q (pre-scaled by dim_head**-0.5): (b, h, t, d); k, v: (b, h, Lc, d), Lc a
    whole number of fmap x fmap context frames; null_k, null_v: (b, h, 1, d);
    talking_heads: (h, h); cmask: (b, Lc) bool, True where a context token
    may be attended, or None for all; fmap: the frames' side; kernel_size,
    dilation: the window's side and step. Returns out (b, h, t, d) in q's
    dtype and lse (b, h, t) in fp32.
    """
    if q.device.type == "cpu":
        return sparse_cross_2dna_fwd_plain(
            q, k, v, null_k, null_v, talking_heads, cmask,
            fmap=fmap, kernel_size=kernel_size, dilation=dilation,
        )
    if q.device.type != "cuda":
        raise ValueError(f"sparse_cross_2dna_fwd runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v, null_k, null_v, talking_heads)
    ):
        raise NotImplementedError(
            "sparse_cross_2dna_fwd has no backward on the card yet: the fused "
            "cross backward comes with the NUWASketch training slice; run "
            "serving under torch.no_grad()"
        )
    b, h, t, d = q.shape
    lc, hw = k.shape[2], fmap * fmap
    if q.dtype not in _DTYPES:
        raise TypeError(f"sparse_cross_2dna_fwd takes float32 or bfloat16, not {q.dtype}")
    if not (1 <= h <= 32 and 1 <= d <= 256):
        raise ValueError(f"need 1 <= heads <= 32 and 1 <= dim_head <= 256, got {h}, {d}")
    if lc == 0 or lc % hw or kernel_size % 2 == 0:
        raise ValueError(f"need whole context frames of {hw} tokens and an odd kernel, "
                         f"got Lc={lc}, kernel {kernel_size}")
    ctx, null = (b, h, lc, d), (b, h, 1, d)
    for arg, x, shape, dtype in (
        ("k", k, ctx, q.dtype), ("v", v, ctx, q.dtype),
        ("null_k", null_k, null, q.dtype), ("null_v", null_v, null, q.dtype),
        ("cmask", cmask, (b, lc), torch.bool),
    ):
        if x is None:
            continue
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != q.device:
            raise ValueError(f"sparse_cross_2dna_fwd: {arg} must be {shape} {dtype} on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    th = talking_heads.to(device=q.device, dtype=torch.float32).contiguous()
    if tuple(th.shape) != (h, h):
        raise ValueError(f"talking_heads: expected {(h, h)}, got {tuple(th.shape)}")
    ins = [x.contiguous() for x in (q, k, v, null_k, null_v)]
    mask = cmask.contiguous() if cmask is not None else None
    out = torch.empty_like(ins[0])
    lse = torch.empty(b, h, t, device=q.device, dtype=torch.float32)
    if t == 0:
        return out, lse
    _launch("sparse_cross2dna_fwd", q.dtype,
            [*(x.data_ptr() for x in ins), th.data_ptr(),
             mask.data_ptr() if mask is not None else None, out.data_ptr(), lse.data_ptr()],
            [b, h, t, d, lc, fmap, kernel_size, dilation], q.device)
    sparse_cross_2dna_fwd.launches += 1
    return out, lse


# kernel launches since the count was last reset
sparse_cross_2dna_fwd.launches = 0
