"""GPipe pipeline parallelism of the decoder stacks on ``torch.distributed``.

Counterpart of ``nuwa_tpu/parallel/pipeline.py``. The layers of a stack are
cut into S statically identical stages over the mesh axis 'pipe' (stage s
holds layer slots ``[s * L, (s + 1) * L)``), and M microbatches go through
them in M + S - 1 steps: plain GPipe, all forwards, then all backwards.
Everything outside the stack (the encoders, the embeddings, the final norm,
the logits and the loss) runs whole on every rank of 'pipe'.

The JAX package runs one SPMD program and XLA transposes its ``ppermute``s,
so its backward pipeline falls out of ``jax.grad``. The port runs one
process a rank, so the schedule is written out, one ``torch.autograd.Function``
a call (``_GPipe``):

  * its forward runs this rank's stage on each microbatch in turn under
    grad, keeps the stage's inputs and outputs, and hands the outputs to
    stage s + 1 (``send`` / ``recv`` over the 'pipe' group); the last
    stage's outputs are then broadcast over 'pipe', so every rank computes
    the same loss;
  * its backward takes the output cotangent on the last stage only (every
    rank holds the same one: the loss is replicated), walks the
    microbatches in one fixed reverse order that is the same on every rank
    (NCCL and gloo pair point-to-point messages by order, so the autograd
    engine must not choose it), receives each cotangent from stage s + 1,
    runs ``torch.autograd.backward`` on the stage's saved outputs, which
    adds the stage parameters' gradients in place, and sends the input
    cotangent to stage s - 1; it returns the input cotangent broadcast from
    stage 0 and the cross-attention ``context``'s summed over 'pipe' in
    fp32, so the replicated layers before the stack get the same gradients
    on every rank.

Reversible stacks pipeline with their O(1)-memory runners: the carry is the
stream pair (x1, x2), or the quad (v1, v2, a1, a2) of the dual decoder,
duplicated before stage 0 and averaged after stage S - 1.

Rows: the input is this rank's rows of the batch (its 'data' share under
PPxDP, as the models' forward takes them), cut into M microbatches of
consecutive rows; ``b * data`` must divide by ``M * data`` as JAX checks
``b % M`` and ``mb % data``. Dropout: stage s's slot j takes the seed that
the unpipelined stack gives layer ``s * L + j`` (``core.layers.split_seed``),
and microbatch m keys its masks by its rows' global ids (``RowSeed``), so a
pipelined run drops exactly what the unpipelined port drops (JAX folds the
microbatch index into its keys instead, and parity is not defined there).

``chained_transformer`` / ``chained_dual_decoder`` run the same stages and
the same schedule with all S stages in one process (the handoffs kept in
memory): the stage body on one card, where NCCL cannot put two ranks.

The trainer's per-stage layout (``StageLayout``): each rank keeps its own
stage's parameters of the stack, the other stages' tensors freed;
``stack_stage_params`` / ``unstack_stage_params`` give the JAX checkpoint's
layout, each slot's leaves with a leading (S,) axis.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
import torch.distributed as dist
from torch import nn
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..core.layers import seed_parts, split_seed, with_row0
from ..dual_decoder import ReversibleDualModalityDecoder, apply_dual_block, block_seeds
from ..dual_decoder import reversible_dual_blocks
from ..reversible import reversible_pair
from ..reversible_dual import dual_reversible_quad
from ..transformer import ReversibleTransformer
from .mesh import axis_size

STACK = ("video_transformer", "layers")  # the trainer's pipelined stack in the params tree


# ---- stage validation -------------------------------------------------------


def _plain(v):
    if isinstance(v, (tuple, list)):
        return all(_plain(x) for x in v)
    return v is None or isinstance(v, (bool, int, float, str))


def _settings(module):
    """A module's own static settings: its attributes of plain values."""
    return tuple((k, v) for k, v in sorted(vars(module).items())
                 if not k.startswith("_") and k != "training" and _plain(v))


def signature(entry):
    """The static signature of a menu entry's module (or tuple of
    modules): its class, its settings (widths, dilation, kernel, causality
    ...), the names and types of its own tensors (not their shapes: a
    pipelined trainer frees the other stages') and its children's
    signatures. ``nn.Module`` has no value equality; two entries with equal
    signatures run the same program, as two equal frozen JAX modules do."""
    if isinstance(entry, (tuple, list)):
        return tuple(signature(e) for e in entry)
    if not isinstance(entry, nn.Module):
        return entry
    tensors = tuple((n, t.dtype)
                    for n, t in (*entry._parameters.items(), *entry._buffers.items())
                    if t is not None)
    return (type(entry).__qualname__, _settings(entry), tensors,
            tuple((n, signature(c)) for n, c in entry.named_children()))


def _describe(entry):
    if isinstance(entry, (tuple, list)):
        return "(" + ", ".join(_describe(e) for e in entry) + ")"
    settings = ", ".join(f"{k}={v!r}" for k, v in _settings(entry) if k != "dim")
    inner = ", ".join(_describe(c) for c in entry.children())
    return f"{type(entry).__name__}({settings}{'; ' if settings and inner else ''}{inner})"


def _validate_menu(menu, n_stages: int) -> int:
    """Check a menu of (kind, module(s), ...) entries splits into
    ``n_stages`` statically identical stages; returns the per-stage
    length."""
    if len(menu) % n_stages:
        raise ValueError(
            f"menu of {len(menu)} layer entries does not split into "
            f"{n_stages} stages"
        )
    L = len(menu) // n_stages
    base = menu[:L]
    for s in range(1, n_stages):
        for j, (e0, e1) in enumerate(zip(base, menu[s * L : (s + 1) * L])):
            if e0[0] != e1[0] or signature(e0[1]) != signature(e1[1]):
                raise ValueError(
                    f"stage {s} entry {j} ({e1[0]}: {_describe(e1[1])}) differs from "
                    f"stage 0 ({e0[0]}: {_describe(e0[1])}) — pipeline stages must be "
                    f"statically identical (depth must be a multiple of "
                    f"n_stages x the schedule cycle)"
                )
    return L


def validate_stages(transformer, n_stages: int) -> int:
    """Check the layer menu splits into ``n_stages`` statically identical
    stages; returns the per-stage menu length."""
    return _validate_menu(transformer.layer_menu, n_stages)


def stage_param_slots(transformer, n_stages: int) -> int:
    """Per-stage count of ``transformer.layers`` entries: menu entries for a
    plain ``Transformer``, (f, g) couples for a ``ReversibleTransformer``.
    Validates stage-periodicity either way."""
    if isinstance(transformer, ReversibleTransformer):
        return _validate_menu([("couple", c) for c in transformer.layers], n_stages)
    return validate_stages(transformer, n_stages)


def validate_dual_stages(decoder, n_stages: int) -> int:
    """Stage-periodicity check of the dual decoder's schedule (self / cross
    / every-k xmod blocks): ``depth`` must be a multiple of ``n_stages *
    lcm(cross_modality_attn_every, dilation cycles)``."""
    return _validate_menu(decoder.blocks(), n_stages)


def _check_microbatching(mesh, axis, data_axis, b, M):
    """Validate the split of a batch of ``b`` rows (all of 'data''s);
    returns the rows of a microbatch."""
    if b % M:
        raise ValueError(f"batch {b} not divisible by {M} microbatches")
    mb = b // M
    if data_axis is not None and mb % axis_size(mesh, data_axis):
        raise ValueError(
            f"microbatch rows {mb} not divisible by mesh axis "
            f"{data_axis}={axis_size(mesh, data_axis)}"
        )
    return mb


# ---- the stacked layout -----------------------------------------------------


def stack_stage_params(layer_params, n_stages: int):
    """[one {path: tensor} per layer] -> [one {path: tensor} per stage slot],
    each leaf with a leading (n_stages,) axis: the JAX checkpoint's layout."""
    L = len(layer_params) // n_stages
    return [{path: torch.stack([layer_params[s * L + j][path] for s in range(n_stages)])
             for path in layer_params[j]}
            for j in range(L)]


def unstack_stage_params(stacked):
    """Inverse of ``stack_stage_params``: the per-layer list, stage 0's
    slots first."""
    S = next(iter(stacked[0].values())).shape[0]
    return [{path: leaf[s] for path, leaf in slot.items()} for s in range(S) for slot in stacked]


def _split_stack_path(parts):
    """(index of the stack's layer number in ``parts``, or None)."""
    for k in range(len(parts) - 2):
        if tuple(parts[k:k + 2]) == STACK and isinstance(parts[k + 2], int):
            return k + 2
    return None


# ---- the schedule -----------------------------------------------------------


class _Ranks:
    """The handoffs of one rank's stage over the 'pipe' group."""

    def __init__(self, mesh, axis):
        self.group = mesh.get_group(axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.n_stages = len(self.ranks)
        self.stages = (mesh.get_local_rank(axis),)
        self.device_type = mesh.device_type

    def give(self, tensors, src, dst):
        for t in tensors:
            dist.send(t.detach().contiguous(), self.ranks[dst], group=self.group)

    def take(self, like, src, dst):
        out = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in like]
        for t in out:
            dist.recv(t, self.ranks[src], group=self.group)
        return out

    def broadcast(self, tensors, stage):
        for t in tensors:
            dist.broadcast(t, self.ranks[stage], group=self.group)

    def sum(self, t):
        dist.all_reduce(t, group=self.group)


class _Chain:
    """Every stage in this process, the handoffs kept in memory."""

    def __init__(self, n_stages, device_type):
        self.n_stages = n_stages
        self.stages = tuple(range(n_stages))
        self.device_type = device_type
        self.queue = defaultdict(list)

    def give(self, tensors, src, dst):
        self.queue[src, dst].append([t.detach() for t in tensors])

    def take(self, like, src, dst):
        return self.queue[src, dst].pop(0)

    def broadcast(self, tensors, stage):
        pass

    def sum(self, t):
        pass


def _rows(t, m, mb):
    return None if t is None else t[m * mb:(m + 1) * mb]


def _forward(pipe, stage_fns, M, streams, context, grad):
    """The forward steps of the stages this process runs: per microbatch,
    each stage's input (the batch's rows on stage 0, else the previous
    stage's handoff) through the stage under grad. Returns the last stage's
    outputs (every rank's, after the broadcast) and what the backward keeps:
    {(stage, microbatch): (inputs, context rows, outputs)}."""
    S, mb = pipe.n_stages, streams[0].shape[0] // M
    saved, outs = {}, []
    for m in range(M):
        for s in pipe.stages:
            if s == 0:
                xs = [_rows(x, m, mb) for x in streams]
            else:  # a stage keeps its streams' shapes and dtypes
                xs = pipe.take([x[:mb] for x in streams], s - 1, s)
            xs = [x.detach().requires_grad_(grad) for x in xs]
            c = _rows(context, m, mb)
            if c is not None:
                c = c.detach().requires_grad_(grad and context.requires_grad)
            with torch.set_grad_enabled(grad):
                ys = stage_fns[s](tuple(xs), c, m)
            if grad:
                saved[s, m] = (xs, c, ys)
            if s < S - 1:
                pipe.give(ys, s, s + 1)
            else:
                outs.append([y.detach() for y in ys])
    if S - 1 in pipe.stages:
        out = [torch.cat(parts) for parts in zip(*outs)]
    else:
        out = [torch.empty_like(x) for x in streams]
    pipe.broadcast(out, S - 1)
    return out, saved


class _GPipe(torch.autograd.Function):
    """The schedule of one call: forward steps, then backward steps in one
    fixed reverse order. Inputs: the streams, the context (or None), then
    the stages' parameters, which make the outputs need grad; their
    gradients are added in place by the stages' own backward."""

    @staticmethod
    def forward(ctx, pipe, stage_fns, M, n, *tensors):
        streams, context = tensors[:n], tensors[n]
        out, ctx.saved = _forward(pipe, stage_fns, M, streams, context, True)
        ctx.pipe, ctx.M, ctx.n = pipe, M, n
        ctx.context_like = None if context is None else (context.shape, context.dtype)
        ctx.n_params = len(tensors) - n - 1
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *douts):
        pipe, M, saved = ctx.pipe, ctx.M, ctx.saved
        S = pipe.n_stages
        like = saved[next(iter(saved))][0]
        mb = like[0].shape[0]
        dstreams = [torch.zeros((M * mb, *x.shape[1:]), dtype=x.dtype, device=x.device)
                    for x in like]
        dcontext = None
        if ctx.context_like is not None and ctx.needs_input_grad[4 + ctx.n]:
            shape, _ = ctx.context_like
            dcontext = torch.zeros(shape, dtype=torch.float32, device=like[0].device)
        for m in reversed(range(M)):
            for s in reversed(pipe.stages):
                xs, c, ys = saved.pop((s, m))
                if s == S - 1:
                    gs = [torch.zeros_like(y) if d is None else _rows(d, m, mb)
                          for y, d in zip(ys, douts)]
                else:
                    gs = pipe.take(ys, s + 1, s)
                pairs = [(y, g) for y, g in zip(ys, gs) if y.requires_grad]
                torch.autograd.backward([y for y, _ in pairs], [g for _, g in pairs])
                dxs = [torch.zeros_like(x) if x.grad is None else x.grad for x in xs]
                if s > 0:
                    pipe.give(dxs, s, s - 1)
                else:
                    for d, dx in zip(dstreams, dxs):
                        _rows(d, m, mb).copy_(dx)
                if dcontext is not None and c.grad is not None:
                    _rows(dcontext, m, mb).add_(c.grad.float())
        pipe.broadcast(dstreams, 0)
        if dcontext is not None:
            pipe.sum(dcontext)
            dcontext = dcontext.to(ctx.context_like[1])
        return (None, None, None, None, *dstreams, dcontext, *([None] * ctx.n_params))


def _check_device(mesh, x):
    """A mesh on the CPU (gloo) takes CPU tensors, one on ``cuda`` (NCCL)
    CUDA tensors."""
    if mesh.device_type != x.device.type:
        raise ValueError(f"a pipeline on a {mesh.device_type} mesh got tensors on "
                         f"{x.device.type}")


def _schedule(pipe, stage_fns, params, M, streams, context):
    grad = torch.is_grad_enabled() and (
        any(x.requires_grad for x in streams)
        or (context is not None and context.requires_grad)
        or any(p.requires_grad for p in params))
    if not grad:
        return _forward(pipe, stage_fns, M, streams, context, False)[0]
    return _GPipe.apply(pipe, stage_fns, M, len(streams), *streams, context, *params)


def _microbatch_seed(seed, rows):
    """``seed`` for the microbatch whose row 0 is row ``rows`` of the batch."""
    base, row0 = seed_parts(seed)
    return with_row0(base, row0 + rows)


# ---- the stacks -------------------------------------------------------------


def _transformer_stages(transformer, S, M, b, *, mask, context, context_mask,
                        rotary_pos_emb, seed):
    """(stage functions {s: fn}, streams' count, each stage's parameters)
    of a Transformer or ReversibleTransformer cut into ``S`` stages."""
    reversible = isinstance(transformer, ReversibleTransformer)
    L = stage_param_slots(transformer, S)
    if context is None and "cross" in transformer.kinds[:L]:
        raise ValueError(
            "pipelined_transformer: the transformer has cross-attention "
            "layers (cross_attend=True) but no `context=` was given"
        )
    mb = b // M
    if reversible:
        couples = transformer.couples(seed)
    else:
        seeds = split_seed(seed, len(transformer.layers))

    def stage_fn(s):
        lo, hi = s * L, (s + 1) * L

        def run(xs, c, m):
            rows = dict(mask=_rows(mask, m, mb), context=c,
                        context_mask=_rows(context_mask, m, mb), rotary_pos_emb=rotary_pos_emb)
            if reversible:
                mine = [(f, fr, g, gr, tuple(_microbatch_seed(x, m * mb) for x in fg))
                        for f, fr, g, gr, fg in couples[lo:hi]]
                return reversible_pair(mine, *xs, {k: v for k, v in rows.items()
                                                   if v is not None})
            mine = [_microbatch_seed(x, m * mb) for x in seeds[lo:hi]]
            return (transformer.run_layers(xs[0], lo, hi, mine, **rows),)

        return run

    params = {s: [p for layer in transformer.layers[s * L:(s + 1) * L]
                  for p in layer.parameters()] for s in range(S)}
    return stage_fn, params


def _run_transformer(pipe, transformer, x, M, context, stage_fn, params):
    fns = {s: stage_fn(s) for s in pipe.stages}
    own = [p for s in pipe.stages for p in params[s]]
    if isinstance(transformer, ReversibleTransformer):
        o1, o2 = _schedule(pipe, fns, own, M, (x, x), context)
        return transformer.norm((o1 + o2) * 0.5)
    (out,) = _schedule(pipe, fns, own, M, (x,), context)
    return transformer.norm(out)


def pipelined_transformer(transformer, x, mesh, *, num_microbatches, axis="pipe",
                          data_axis=None, mask=None, context=None, context_mask=None,
                          rotary_pos_emb=None, seed=None):
    """``transformer(x, ...)`` pipelined over ``mesh``'s ``axis`` with
    ``num_microbatches`` microbatches. ``x`` (and ``mask``, ``context``,
    ``context_mask``) are this rank's rows; ``data_axis`` names the axis
    that splits the batch (PPxDP), whose gradient average is the caller's
    (the trainer's). A 'model' axis of the mesh splits each stage's
    parameters by the TP rules (PPxTP), as ``parallel.shard_params`` left
    them. ``seed``: the stack's dropout seed (a ``RowSeed`` for a rank's
    rows). One stage (``S == 1``) is the plain stack."""
    _check_device(mesh, x)
    S, M, b = axis_size(mesh, axis), num_microbatches, x.shape[0]
    dp = axis_size(mesh, data_axis) if data_axis is not None else 1
    stage_fn, params = _transformer_stages(transformer, S, M, b, mask=mask, context=context,
                                           context_mask=context_mask,
                                           rotary_pos_emb=rotary_pos_emb, seed=seed)
    _check_microbatching(mesh, axis, data_axis, b * dp, M)
    if S == 1:
        return transformer(x, mask=mask, context=context, context_mask=context_mask,
                           rotary_pos_emb=rotary_pos_emb, seed=seed)
    return _run_transformer(_Ranks(mesh, axis), transformer, x, M, context, stage_fn, params)


def chained_transformer(transformer, x, n_stages, *, num_microbatches, mask=None,
                        context=None, context_mask=None, rotary_pos_emb=None, seed=None):
    """``pipelined_transformer``'s stages and schedule with all
    ``n_stages`` in this process, stage s's outputs stage s + 1's inputs."""
    M, b = num_microbatches, x.shape[0]
    stage_fn, params = _transformer_stages(transformer, n_stages, M, b, mask=mask,
                                           context=context, context_mask=context_mask,
                                           rotary_pos_emb=rotary_pos_emb, seed=seed)
    _check_microbatching(None, None, None, b, M)
    return _run_transformer(_Chain(n_stages, x.device.type), transformer, x, M, context,
                            stage_fn, params)


def _dual_stages(decoder, S, M, b, *, context_mask, video_mask, audio_mask, seed):
    """(stage functions, each stage's parameters) of a dual decoder cut into
    ``S`` stages."""
    reversible = isinstance(decoder, ReversibleDualModalityDecoder)
    blocks = decoder.blocks()
    L = _validate_menu(blocks, S)
    seeds = block_seeds(seed, len(blocks))
    mb = b // M

    def stage_fn(s):
        lo, hi = s * L, (s + 1) * L

        def run(xs, c, m):
            mine = [_microbatch_seed(x, m * mb) for sd in seeds[lo:hi] for x in sd]
            kw = dict(context=c, context_mask=_rows(context_mask, m, mb),
                      video_mask=_rows(video_mask, m, mb), audio_mask=_rows(audio_mask, m, mb))
            if reversible:
                return dual_reversible_quad(reversible_dual_blocks(blocks[lo:hi], mine), *xs,
                                            {k: v for k, v in kw.items() if v is not None})
            v, a = xs
            for i, (btype, mods) in enumerate(blocks[lo:hi]):
                kw["seeds"] = tuple(mine[4 * i:4 * i + 4])
                if decoder.remat:
                    v, a = checkpoint(apply_dual_block, btype, mods, v, a, use_reentrant=False,
                                      **kw)
                else:
                    v, a = apply_dual_block(btype, mods, v, a, **kw)
            return v, a

        return run

    params = {s: [p for quad in decoder.layers[s * L:(s + 1) * L] for p in quad.parameters()]
              for s in range(S)}
    return stage_fn, params


def _run_dual(pipe, decoder, video, audio, M, context, stage_fn, params):
    fns = {s: stage_fn(s) for s in pipe.stages}
    own = [p for s in pipe.stages for p in params[s]]
    if isinstance(decoder, ReversibleDualModalityDecoder):
        v1, v2, a1, a2 = _schedule(pipe, fns, own, M, (video, video, audio, audio), context)
        v, a = (v1 + v2) * 0.5, (a1 + a2) * 0.5
    else:
        v, a = _schedule(pipe, fns, own, M, (video, audio), context)
    return decoder.video_norm(v), decoder.audio_norm(a)


def pipelined_dual_decoder(decoder, video, audio, mesh, *, num_microbatches, axis="pipe",
                           data_axis=None, context=None, context_mask=None, video_mask=None,
                           audio_mask=None, seed=None):
    """The dual decoder pipelined over ``mesh``'s ``axis``: both modality
    streams ride the same pipeline (the xmod blocks couple them within a
    stage), the quad of a ``ReversibleDualModalityDecoder``'s stream pairs
    through its O(1)-memory runner, a plain decoder's blocks under
    ``remat`` when it has it. Rows and seeds as in
    ``pipelined_transformer``."""
    _check_device(mesh, video)
    S, M, b = axis_size(mesh, axis), num_microbatches, video.shape[0]
    dp = axis_size(mesh, data_axis) if data_axis is not None else 1
    stage_fn, params = _dual_stages(decoder, S, M, b, context_mask=context_mask,
                                    video_mask=video_mask, audio_mask=audio_mask, seed=seed)
    _check_microbatching(mesh, axis, data_axis, b * dp, M)
    if S == 1:
        return decoder(video, audio, context=context, context_mask=context_mask,
                       video_mask=video_mask, audio_mask=audio_mask, seed=seed)
    return _run_dual(_Ranks(mesh, axis), decoder, video, audio, M, context, stage_fn, params)


def chained_dual_decoder(decoder, video, audio, n_stages, *, num_microbatches, context=None,
                         context_mask=None, video_mask=None, audio_mask=None, seed=None):
    """``pipelined_dual_decoder``'s stages and schedule with all
    ``n_stages`` in this process."""
    M, b = num_microbatches, video.shape[0]
    stage_fn, params = _dual_stages(decoder, n_stages, M, b, context_mask=context_mask,
                                    video_mask=video_mask, audio_mask=audio_mask, seed=seed)
    _check_microbatching(None, None, None, b, M)
    return _run_dual(_Chain(n_stages, video.device.type), decoder, video, audio, M, context,
                     stage_fn, params)


# ---- the trainer's per-stage layout -----------------------------------------


class StageLayout:
    """``transformer``'s layers cut into the stages of ``mesh``'s ``axis``:
    this rank keeps its stage's tensors, and the other stages' are freed
    (size 0), so its stack parameters, and the moments of an optimizer over
    ``own_parameters()``, are 1/S of the whole."""

    def __init__(self, transformer, mesh, axis="pipe"):
        self.n_stages = axis_size(mesh, axis)
        self.stage = mesh.get_local_rank(axis)
        self.slots = stage_param_slots(transformer, self.n_stages)
        self.group = mesh.get_group(axis)
        self.layers = transformer.layers
        lo = self.stage * self.slots
        self.own = range(lo, lo + self.slots)
        self.shapes = {}  # id of a freed tensor: its shape
        self.free()

    def _tensors(self, layers):
        return [t for layer in layers for t in (*layer.parameters(), *layer.buffers())]

    def own_parameters(self):
        return [p for i in self.own for p in self.layers[i].parameters()]

    def other_layers(self):
        return [layer for i, layer in enumerate(self.layers) if i not in self.own]

    @torch.no_grad()
    def free(self):
        for t in self._tensors(self.other_layers()):
            if t.numel():
                self.shapes[id(t)] = t.shape
                t.data = t.data.new_empty(0)

    @contextlib.contextmanager
    def whole(self, gather=True):
        """Inside the block every stage's tensors hold their values (each
        slot's gathered over 'pipe', a collective; with ``gather=False``
        left uninitialised, for a block that loads them); on the way out
        the other stages' are freed again."""
        with torch.no_grad():
            for j in range(self.slots):
                mine = self._tensors([self.layers[self.own[j]]])
                group = [self._tensors([self.layers[s * self.slots + j]])
                         for s in range(self.n_stages)]
                for k, t in enumerate(mine):
                    parts = [ts[k] for ts in group]
                    for p in parts:
                        if p is not t:
                            p.data = t.data.new_empty(self.shapes[id(p)])
                    if gather:
                        dist.all_gather([p.data for p in parts], t.data.clone(),
                                        group=self.group)
        try:
            yield
        finally:
            self.free()

    def stack(self, flat, gather=True):
        """A flat {dotted JAX path: tensor} of this rank's tensors in the
        stacked layout: each own stack layer's leaf under its slot, gathered
        over 'pipe' into one (S, ...) leaf (a collective), or with
        ``gather=False`` (a per-leaf step count, equal on every stage) kept
        as it is."""
        out = {}
        for path, t in flat.items():
            parts = path.split(".")
            at = _split_stack_path(tuple(int(p) if p.isdigit() else p for p in parts))
            if at is None:
                out[path] = t
                continue
            parts[at] = str(int(parts[at]) - self.own.start)
            if gather:
                gathered = [torch.empty_like(t) for _ in range(self.n_stages)]
                dist.all_gather(gathered, t.contiguous(), group=self.group)
                t = torch.stack(gathered)
            out[".".join(parts)] = t
        return out

    def unstack(self, leaves):
        """Checkpoint leaves ({keystr: tensor}) in the stacked layout (the
        stack's layer indices all below the slots, each leaf with a leading
        (S,) axis, a scalar step count for every stage) in the flat layout;
        leaves in the flat layout as they are."""
        from ..train.checkpoint import keystr, parse_keystr

        parsed = {parse_keystr(key): value for key, value in leaves.items()}
        stacked = [parts[at] for parts in parsed
                   if (at := _split_stack_path(parts)) is not None]
        if not stacked or max(stacked) >= self.slots:
            return leaves
        out = {}
        for parts, value in parsed.items():
            at = _split_stack_path(parts)
            if at is None:
                out[keystr(parts)] = value
                continue
            for s in range(self.n_stages):
                flat = parts[:at] + (s * self.slots + parts[at],) + parts[at + 1:]
                out[keystr(flat)] = value if value.ndim == 0 else value[s]
        return out
