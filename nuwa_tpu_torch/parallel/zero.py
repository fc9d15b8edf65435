"""ZeRO-1: the AdamW moments split over the 'data' mesh axis.

Counterpart of ``nuwa_tpu/parallel/zero.py``. Under plain data parallelism
every rank holds both AdamW moments of every parameter; ZeRO-1 (the
optimizer-state stage of ZeRO, Rajbhandari et al., 2020) splits each
moment over 'data' along the largest dimension that 'data' divides and the
TP rules leave free, so a rank's optimizer bytes drop by about the size of
the axis. The update is elementwise: each rank updates its slice of every
moment and parameter from its slice of the averaged gradient, then the
updated parameter slices are all-gathered over 'data'. The math is that of
AdamW on one device. (``torch.distributed.optim.ZeroRedundancyOptimizer``
would assign whole parameters to ranks, another layout with other per-rank
bytes, so it is not used.)

``zero_opt_specs`` gives each moment leaf's spec as the JAX package does:
its TP spec (the parameter's path is a suffix of the moment's), with
'data' on the largest free divisible axis, and scalars replicated.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.tp import shard_of
from ..train.optimizer import get_optimizer
from .mesh import Sharding, axis_shard, axis_sizes
from .sharding import _leaves, global_shape, partition_spec_for


def _axes_of(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _zero_spec(path: str, leaf, mesh, data_axis: str) -> tuple:
    """The spec of one optimizer-state leaf: its parameter's TP layout (the
    split it carries, else the rules' spec with their divisibility
    fallback) plus ``data_axis`` on the largest remaining divisible
    dimension."""
    nd = np.ndim(leaf)
    if nd == 0:
        return ()
    sizes = axis_sizes(mesh)
    dp = sizes.get(data_axis, 1)
    shape = global_shape(leaf) if torch.is_tensor(leaf) else np.shape(leaf)
    shard = shard_of(leaf)
    if shard is not None:  # already placed: its split is ground truth
        entries = [None] * nd
        entries[shard.dim] = "model"
    else:
        base = partition_spec_for(path, leaf)
        entries = list(base) + [None] * (nd - len(base))
        # the divisibility fallback of shard_params
        if any(shape[ax] % sizes.get(a, 1) for ax, e in enumerate(entries)
               for a in _axes_of(e)):
            entries = [None] * nd
    used = {a for e in entries for a in _axes_of(e)}
    if dp > 1 and data_axis not in used:
        free = [ax for ax in range(nd) if entries[ax] is None and shape[ax] % dp == 0]
        if free:
            best = max(free, key=lambda ax: shape[ax])
            entries[best] = data_axis
    return tuple(entries)


def zero_opt_specs(opt_state, mesh, data_axis: str = "data") -> dict:
    """{path: spec} of the optimizer-state leaves ``opt_state`` (a flat
    {path: leaf} mapping, paths '/'- or '.'-joined) in the ZeRO-1 layout."""
    return {path: _zero_spec(path, leaf, mesh, data_axis)
            for path, leaf in _leaves(opt_state).items()}


def zero_opt_shardings(opt_state, mesh, data_axis: str = "data") -> dict:
    """{path: Sharding} of ``opt_state`` in the ZeRO-1 layout."""
    return {path: Sharding(mesh, spec)
            for path, spec in zero_opt_specs(opt_state, mesh, data_axis).items()}


def shard_opt_state(opt_state, mesh, data_axis: str = "data"):
    """This rank's part of each whole leaf of ``opt_state`` in the ZeRO-1
    layout; returns (parts, shardings)."""
    shardings = zero_opt_shardings(opt_state, mesh, data_axis)
    parts = {path: shardings[path].local(leaf) for path, leaf in _leaves(opt_state).items()}
    return parts, shardings


class Zero1AdamW:
    """AdamW (``train.optimizer.get_optimizer``: decay on ndim >= 2) whose
    moments are split over 'data' by ``zero_opt_specs``. ``params`` are the
    trained parameters (this rank's TP parts) and ``paths`` their JAX paths.
    A parameter that 'data' does not divide keeps whole moments, as in the
    JAX layout. ``step`` reads the parameters' (averaged) gradients and
    their values as they stand: it takes each split parameter's slice anew,
    so weights loaded into the parameters since (a resumed checkpoint) are
    the ones it updates."""

    def __init__(self, params, paths, mesh, lr=3e-4, wd=1e-1):
        self.slots = []  # (parameter, its Shard over 'data' or None, the optimized leaf)
        for p, path in zip(params, paths):
            spec = _zero_spec(path, p, mesh, "data")
            if "data" in spec:
                shard = axis_shard(mesh, "data", spec.index("data"))
                leaf = nn.Parameter(shard.part(p.detach()).clone())
            else:
                shard, leaf = None, p
            self.slots.append((p, shard, leaf))
        self.opt = get_optimizer([leaf for _, _, leaf in self.slots], lr=lr, wd=wd)
        self.state = _WholeState(self)

    @torch.no_grad()
    def step(self):
        for p, shard, leaf in self.slots:
            if shard is not None:
                leaf.copy_(shard.part(p))
                leaf.grad = None if p.grad is None else shard.part(p.grad)
        self.opt.step()
        for p, shard, leaf in self.slots:
            if shard is not None:
                p.copy_(shard.gather(leaf))

    def zero_grad(self, set_to_none=True):
        for p, _, leaf in self.slots:
            p.grad = None
            leaf.grad = None

    def local_bytes(self):
        """Bytes of the moments this rank holds."""
        return sum(v.numel() * v.element_size() for state in self.opt.state.values()
                   for k, v in state.items() if k != "step")


class _WholeState:
    """``opt.state[p]`` of the parameters: each moment whole over 'data' (a
    collective on read); setting one keeps this rank's slice."""

    def __init__(self, zero):
        self.zero = zero
        self.slot = {id(p): (shard, leaf) for p, shard, leaf in zero.slots}

    def __getitem__(self, p):
        shard, leaf = self.slot[id(p)]
        state = self.zero.opt.state[leaf]
        if shard is None or not state:
            return state
        return {k: v if k == "step" else shard.gather(v) for k, v in state.items()}

    def __setitem__(self, p, state):
        shard, leaf = self.slot[id(p)]
        self.zero.opt.state[leaf] = (
            state if shard is None else
            {k: v if k == "step" else shard.part(v) for k, v in state.items()})
