"""Context parallelism for Sparse3DNA: the frames over a mesh axis.

Counterpart of ``nuwa_tpu/parallel/context_parallel.py``. The 3DNA window is
local along the frames (a lookback of (Kf - 1)·dilation frames; a centered
window also looks ahead half of that), so context parallelism is a halo
exchange, not ring attention: each rank of the frame axis

  * projects q, k and v of bos and of its own frames only (``Floc`` frames a
    rank, the last ranks' ragged or empty where the frames do not divide);
  * receives the k and v of the lookback frames before its own (and, centered,
    of the lookahead frames after them) from the ranks that own them, sent
    point to point (``dist.batch_isend_irecv``), one or more ranks back as
    the window needs (JAX's single- and multi-hop ``ppermute`` relays);
  * attends its own queries over that key buffer with the Sparse3DNA
    kernels' query window (``kernels.nda``: the buffer is the contiguous
    slice of the sequence from its first halo token, so the kernels' frame
    masks and the dropout hash's token ids, offset by ``tok0``, are the whole
    sequence's);
  * all-gathers the outputs back into the whole sequence; bos adopts its own
    value.

Everything outside the attention stays whole on every rank, as under JAX's
``shard_map`` with ``out_specs=P(data_axis, axis, None)`` and a replicated
consumer, and as the port's TP keeps it. So the backward is: the gathered
output's cotangent (the same on every rank) sliced to the rank's queries,
the kernels' backward, each halo piece's cotangent sent back to its owner
and added there in rank order, and the cotangents of the layer's input and
of its parameters summed over the axis in one all-reduce (``_Replicated``:
each rank's covers its own frames), so every rank ends with the whole
gradient. bos's own value takes its gradient on the axis's rank 0 only,
which the sum then carries to every rank. ``cp_step`` is the layer's one
body: the unmeshed ``Sparse3DNA`` runs it over an axis of one rank
(``axis_comm`` without a mesh), which sends nothing.

Every rank of the axis must run the same layers in the same order, forward
and backward (the reversible runtimes' recompute included), as the
collectives pair up in that order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.layers import RowSeed, kernel_seed, with_row0
from ..core.tp import Shard, gathered_parts
from ..kernels.nda import sparse_3dna
from ..ops.attention import merge_heads, split_heads
from .mesh import axis_sizes


def cp_axes(mesh, cp_axis="data"):
    """(frame axis, batch axis or None) of ``cp_axis`` on ``mesh``, as the
    JAX module routes them: a tuple is both; on a mesh whose 'context' axis
    is above 1 the frames ride 'context' and the batch 'data' (where it is
    above 1); else the frames ride ``cp_axis`` and the batch is whole."""
    if isinstance(cp_axis, tuple):
        return cp_axis
    sizes = axis_sizes(mesh)
    if sizes.get("context", 1) > 1:
        return "context", "data" if sizes.get("data", 1) > 1 else None
    return cp_axis, None


def shard_layout(t, tokens_per_frame, size, lookback, lookahead):
    """Per rank of an axis of ``size``: ((lo, hi), (k_lo, k_hi)), the video
    tokens it owns and its key buffer, for ``t`` tokens, whole frames a
    rank (the last ranks' ragged or empty) and windows reaching ``lookback``
    frames back and ``lookahead`` ahead. A rank that owns no token needs no
    key."""
    hw = tokens_per_frame
    per = -(-(-(-t // hw)) // size) * hw  # tokens a rank: Floc frames
    out = []
    for r in range(size):
        lo, hi = min(r * per, t), min((r + 1) * per, t)
        keys = (lo, hi) if lo == hi else (max(0, lo - lookback * hw),
                                           min(t, hi + lookahead * hw))
        out.append(((lo, hi), keys))
    return per, out


def _halo_pieces(layout, rank):
    """(sends, recvs): {peer: (a, b)}, the tokens [a, b) this rank sends to
    each peer's key buffer and receives from each peer for its own."""

    def piece(src, dst):
        (lo, hi), _ = layout[src]
        _, (k_lo, k_hi) = layout[dst]
        a, b = max(lo, k_lo), min(hi, k_hi)
        return (a, b) if a < b else None

    peers = [p for p in range(len(layout)) if p != rank]
    sends = {p: piece(rank, p) for p in peers}
    recvs = {p: piece(p, rank) for p in peers}
    return ({p: r for p, r in sends.items() if r}, {p: r for p, r in recvs.items() if r})


_JOINED = set()  # the groups whose ranks have all met in a collective


def _exchange(group, sends, recvs, like):
    """Post every send and receive ({peer: tensor}) at once and wait. A
    group's first exchange begins with an all-reduce of one element (on
    ``like``'s device) that every rank enters: NCCL builds the group's
    communicator in its first collective, which every rank must join, and a
    rank that owns no frame posts no send or receive."""
    if group not in _JOINED:
        dist.all_reduce(like.new_zeros(1), group=group)
        _JOINED.add(group)
    peer = lambda p: dist.get_global_rank(group, p)  # noqa: E731
    ops = ([dist.P2POp(dist.isend, x, peer(p), group) for p, x in sorted(sends.items())]
           + [dist.P2POp(dist.irecv, x, peer(p), group) for p, x in sorted(recvs.items())])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Halo(torch.autograd.Function):
    """This rank's k and v stacked, (2, b, h, n, d) over its own tokens
    [lo, hi), to its key buffer [k_lo, k_hi): the halo pieces received from
    their owners around its own. Backward: each received piece's cotangent
    goes back to its owner, and the cotangents of the pieces this rank sent
    come back and are added to its own in peer order."""

    @staticmethod
    def forward(ctx, kv, group, layout, rank):
        (lo, hi), (k_lo, _) = layout[rank]
        sends, recvs = _halo_pieces(layout, rank)
        got = {p: kv.new_empty(*kv.shape[:3], b - a, kv.shape[-1]) for p, (a, b) in recvs.items()}
        _exchange(group, {p: kv[:, :, :, a - lo:b - lo].contiguous()
                          for p, (a, b) in sends.items()}, got, kv)
        ctx.group, ctx.layout, ctx.rank = group, layout, rank
        parts = sorted([(a, got[p]) for p, (a, _) in recvs.items()] + [(lo, kv)],
                       key=lambda part: part[0])
        return torch.cat([x for _, x in parts], dim=3) if len(parts) > 1 else kv.clone()

    @staticmethod
    def backward(ctx, grad):
        layout, rank = ctx.layout, ctx.rank
        (lo, hi), (k_lo, _) = layout[rank]
        sends, recvs = _halo_pieces(layout, rank)
        back = {p: grad.new_empty(*grad.shape[:3], b - a, grad.shape[-1])
                for p, (a, b) in sends.items()}
        _exchange(ctx.group, {p: grad[:, :, :, a - k_lo:b - k_lo].contiguous()
                              for p, (a, b) in recvs.items()}, back, grad)
        own = grad[:, :, :, lo - k_lo:hi - k_lo].clone()
        for p in sorted(back):
            a, b = sends[p]
            own[:, :, :, a - lo:b - lo] += back[p]
        return own, None, None, None


class _Replicated(torch.autograd.Function):
    """Tensors every rank of the axis holds whole and reads for its own
    share of the work: the identity forward; backward, their cotangents
    summed over the axis's ranks in one fp32 all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return (None, *out)


class AxisComm:
    """The frame axis's collectives for one rank: ``replicated`` (the
    tensors whose gradients are summed over the axis), ``halo`` (own k and v
    to the key buffer) and ``gather`` (own output rows to the whole
    sequence's), over the ``layout`` of ``shard_layout``. An axis of one
    rank sends nothing."""

    def __init__(self, group, size, rank, layout, per):
        self.group, self.size, self.rank, self.layout, self.per = group, size, rank, layout, per

    def replicated(self, *xs):
        """``xs`` through ``_Replicated`` where any needs a gradient; None
        stays None."""
        live = [i for i, x in enumerate(xs)
                if x is not None and x.requires_grad and torch.is_floating_point(x)]
        if self.size == 1 or not live or not torch.is_grad_enabled():
            return xs
        out = list(xs)
        for i, view in zip(live, _Replicated.apply(self.group, *(xs[i] for i in live))):
            out[i] = view
        return tuple(out)

    def halo(self, k, v):
        """This rank's k and v (b, h, n, d) to its key buffer's."""
        if self.size == 1:
            return k, v
        kv = _Halo.apply(torch.stack([k, v]), self.group, self.layout, self.rank)
        return kv[0], kv[1]

    def gather(self, out):
        """(b, h, per, d) rows of every rank, trimmed to the t tokens."""
        if self.size == 1:
            return out
        (lo, hi), _ = self.layout[self.rank]
        t = self.layout[-1][0][1]
        out = F.pad(out, (0, 0, 0, self.per - (hi - lo)))
        return gathered_parts(out, Shard(2, self.group, self.size, self.rank))[:, :, :t]


def frame_reach(mod):
    """(lookback, lookahead) frames of a Sparse3DNA's window."""
    kf, df = mod.kernel[0], mod.dilations[0]
    lookback = (kf - 1) * df if mod.causal else (kf - 1) // 2 * df
    return lookback, (0 if mod.causal else (kf - 1) * df - lookback)


def axis_comm(mod, t, mesh=None, axis=None):
    """This rank's ``AxisComm`` for ``t`` video tokens of ``mod`` with the
    frames over the mesh axis ``axis``; without a mesh, an axis of one rank
    (the unsharded layer)."""
    _, fh, fw = mod.video_shape
    size = 1 if mesh is None else axis_sizes(mesh)[axis]
    per, layout = shard_layout(t, fh * fw, size, *frame_reach(mod))
    if mesh is None:
        return AxisComm(None, 1, 0, layout, per)
    return AxisComm(mesh.get_group(axis), size, mesh.get_local_rank(axis), layout, per)


def context_parallel_sparse_3dna(mod, x, mesh, axis="data", *, seed=None, data_axis=None):
    """``mod(x, seed=seed)`` of a ``Sparse3DNA`` with its video tokens'
    frames over the mesh axis ``axis``: x (b, 1 + t, dim), whole on every
    rank of the axis, as is the result. Causal windows exchange a lookback
    halo only, centered ones (the sketch encoder) halos both ways; a ragged
    last frame (the teacher-forced t = F·HW - 1) and frames that the axis
    does not divide leave the last ranks ragged or empty, their phantom
    tokens masked by the kernels. ``data_axis``: the batch is split over it
    and x holds this rank's rows; a ``seed`` that names no rows of its own
    (an int, not a ``core.layers.RowSeed``) then keys the dropout masks by
    the global rows, as JAX's ``b_base`` does."""
    if data_axis is not None and not isinstance(seed, RowSeed):
        seed = with_row0(seed, mesh.get_local_rank(data_axis) * x.shape[0])
    return cp_step(mod, x, axis_comm(mod, x.shape[1] - 1, mesh, axis), seed=seed)


def cp_step(mod, x, comm, *, seed=None):
    """The Sparse3DNA layer ``mod`` on one rank of the frame axis that
    ``comm`` spans (``AxisComm``): x (b, 1 + t, dim) whole; returns the
    layer's output rows that ``comm.gather`` gives (the whole sequence's,
    bos first). A bos-only input (t = 0) adopts its own value."""
    if x.shape[1] == 1:
        return mod.to_out(mod.to_kv(x).chunk(2, dim=-1)[1])
    (lo, hi), (k_lo, _) = comm.layout[comm.rank]
    _, fh, fw = mod.video_shape
    h = mod.heads
    x, wq, wkv, th, bias = comm.replicated(x, mod.to_q.w, mod.to_kv.w, mod.talking_heads,
                                           mod.rel_bias())
    # bos and this rank's frames, projected together
    xs = x[:, :1 + hi] if lo == 0 else torch.cat([x[:, :1], x[:, 1 + lo:1 + hi]], dim=1)
    q = split_heads(mod.to_q(xs, w=wq), h) * mod.dim_head**-0.5
    k, v = (split_heads(u, h) for u in mod.to_kv(xs, w=wkv).chunk(2, dim=-1))
    keys, values = comm.halo(k[:, :, 1:], v[:, :, 1:])
    out = sparse_3dna(
        q[:, :, 1:], keys, values, k[:, :, :1], v[:, :, :1], th, bias,
        fmap=(fh, fw), kernel=mod.kernel, dilation=mod.dilations,
        mode="causal" if mod.causal else "centered", dropout=(mod.dropout, kernel_seed(seed)),
        q_lo=lo - k_lo, tok0=k_lo,
    )
    # bos adopts its own value, whose gradient the axis's rank 0 carries
    bos = v[:, :, :1] if comm.rank == 0 else v[:, :, :1].detach()
    return mod.to_out(merge_heads(torch.cat([bos, comm.gather(out)], dim=2)))
