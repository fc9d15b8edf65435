"""Parameter partitioning rules (tensor parallelism) and the data-parallel
step.

Counterpart of ``nuwa_tpu/parallel/sharding.py``, with the JAX package's
rules verbatim: the head / inner dimension of every attention and
feed-forward projection is split over the 'model' axis.

  * to_q / to_kv / to_qkv / w_in:   (None, 'model')   column parallel
  * to_out / w_out:                 ('model', None)   row parallel
  * embeddings / logits heads:      (None, 'model')   features / vocabulary
  * null_k / null_v:                ('model', None, None)   heads
  * norms, biases, the codec's convolutions: replicated

The rules match the '/'-joined path of a leaf in the JAX params tree
(``convert.jax_path``), so ``make_param_specs`` gives the JAX package's
specs leaf for leaf, as tuples of axis names and None. ``shard_params``
keeps this rank's part of each split parameter in place and marks it
(``core.tp``); the layers then run the column- and row-parallel products
and keep every activation whole. Under data parallelism every rank takes
its rows of the global batch (``data_rows``), the model's forward keys its
dropout masks by those global rows (its ``row0``), and the gradients are
averaged over 'data' (``all_reduce_grads_``), as pjit's global-batch mean
does.
"""
from __future__ import annotations

import contextlib
import re

import numpy as np
import torch
import torch.distributed as dist

from ..convert import _tensors
from ..core.tp import shard_of
from .mesh import axis_shard, axis_size

# ordered (regex over '/'-joined path, spec builder of the leaf's ndim) rules;
# the first match whose spec fits the leaf wins
_TP_RULES = (
    # column-parallel projections (shard output features)
    (r"(to_q|to_kv|to_qkv|w_in)/w$", lambda nd: (None, "model") if nd == 2 else ()),
    # row-parallel projections (shard input features)
    (r"(to_out|w_out)/w$", lambda nd: ("model", None) if nd == 2 else ()),
    # int8-quantized leaves: per-output-channel scales shard with the output
    # dim of their weight
    (r"(to_q|to_kv|to_qkv|w_in)/w_scale$", lambda nd: ("model",) if nd == 1 else ()),
    (r"(to_logits|to_video_logits|to_audio_logits)/w_scale$",
     lambda nd: ("model",) if nd == 1 else ()),
    # logits heads: shard the vocab (output) dim; `/w` covers the int8 form
    (r"(to_logits|to_video_logits|to_audio_logits)(/w)?$",
     lambda nd: (None, "model") if nd == 2 else ()),
    # embedding tables: shard the feature axis, not the vocab axis
    (r"(text_embedding|image_embedding|audio_embedding|sketch_embedding)/table$",
     lambda nd: (None, "model")),
    # null kv: per-head params, shard the head axis
    (r"null_[kv]$", lambda nd: ("model", None, None) if nd == 3 else ()),
)


def _slashed(path: str) -> str:
    return path.replace(".", "/")


def partition_spec_for(path: str, leaf) -> tuple:
    """The TP spec of the leaf at ``path`` ('/'- or '.'-joined)."""
    nd = np.ndim(leaf)
    path = _slashed(path)
    for pattern, spec_fn in _TP_RULES:
        if re.search(pattern, path):
            spec = spec_fn(nd)
            if len(spec) <= nd:
                return spec
    return ()


def _leaves(params):
    """{dotted JAX path: tensor}: a module's parameters and buffers, or a
    flat mapping as it is."""
    if isinstance(params, torch.nn.Module):
        return {path: t for path, (t, _, _) in _tensors(params).items()}
    return dict(params)


def make_param_specs(params) -> dict:
    """{JAX path: spec} of a module's parameters and buffers (or of a flat
    {path: leaf} mapping)."""
    return {path: partition_spec_for(path, leaf) for path, leaf in _leaves(params).items()}


def global_shape(t) -> tuple:
    """The whole tensor's shape of a (possibly split) parameter."""
    shape = list(t.shape)
    shard = shard_of(t)
    if shard is not None:
        shape[shard.dim] *= shard.size
    return tuple(shape)


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh):
    """Split ``model``'s parameters (and int8 buffers) over the 'model' axis
    by the TP rules, in place: each keeps this rank's part and its
    ``core.tp.Shard``. A dimension that the axis does not divide stays
    replicated. Returns the model."""
    size = axis_size(mesh, "model")
    if size == 1:
        return model
    for path, t in _leaves(model).items():
        spec = partition_spec_for(path, t)
        if "model" not in spec or shard_of(t) is not None:
            continue
        dim = spec.index("model")
        if t.shape[dim] % size:
            continue
        shard = axis_shard(mesh, "model", dim)
        t.data = shard.part(t.data)
        t.tp = shard
    return model


@contextlib.contextmanager
def gathered(model: torch.nn.Module):
    """Inside the block every split tensor of ``model`` holds its whole
    value (a collective: every rank enters); on the way out each keeps this
    rank's part of what the block left there (a checkpoint loaded in it)."""
    split = [t for t in _leaves(model).values() if shard_of(t) is not None]
    with torch.no_grad():
        for t in split:
            t.data = t.tp.gather(t.data)
    try:
        yield model
    finally:
        with torch.no_grad():
            for t in split:
                t.data = t.tp.part(t.data)


@torch.no_grad()
def all_reduce_grads_(params, mesh, axis="data"):
    """Average the gradients of ``params`` over ``axis`` in one collective.
    A parameter no rank has a gradient for keeps None (no AdamW step, as on
    one device); one that only some ranks reached averages with zeros."""
    params = list(params)
    size = axis_size(mesh, axis)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                      for p in params]
                     + [torch.tensor([p.grad is not None for p in params],
                                     dtype=torch.float32, device=params[0].device)])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    counts = flat[-len(params):]
    offset = 0
    for p, count in zip(params, counts.tolist()):
        g = flat[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
        p.grad = None if count == 0 else (g / size).to(p.dtype)


def all_reduce_mean(x, mesh, axis="data"):
    """The mean of a tensor over ``axis``."""
    x = torch.as_tensor(x).detach().clone()
    dist.all_reduce(x, group=mesh.get_group(axis))
    return x / axis_size(mesh, axis)


def data_rows(mesh, batch):
    """The slice of this rank's rows of a global batch of ``batch`` rows
    over 'data'."""
    dp = axis_size(mesh, "data")
    assert batch % dp == 0, f"batch_size {batch} not divisible by data axis {dp}"
    start = mesh.get_local_rank("data") * (batch // dp)
    return slice(start, start + batch // dp)


def sharded_train_step(mesh, loss_fn, opt):
    """A step callable ``step(*batch) -> loss``: ``loss_fn(*rows, row0=...)``
    on this rank's rows of each global batch tensor, ``row0`` the global
    row of their row 0 (for the model's forward: its dropout masks), the
    gradients averaged over 'data', one ``opt`` step. Per-row draws, such as
    the condition dropout, are the caller's to make for the global batch
    and pass as a batch tensor. Returns the loss averaged over 'data' (the
    global batch's)."""
    params = [p for group in opt.param_groups for p in group["params"]]

    def step(*batch):
        rows = data_rows(mesh, batch[0].shape[0])
        loss = loss_fn(*(x[rows] for x in batch), row0=rows.start)
        loss.backward()
        all_reduce_grads_(params, mesh)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return all_reduce_mean(loss, mesh)

    return step
