"""Reversible two-stream runtime: activation memory independent of depth.

Counterpart of ``nuwa_tpu/reversible.py``. Blocks are couples ``(f, g)``:

    y1 = x1 + f(x2)        y2 = x2 + g(y1)

The input is duplicated into both streams and the output is their mean
(``reversible_sequence``); a pipeline stage takes the pair and hands it on
(``reversible_pair``). The forward keeps only the last two streams; the
backward walks the couples in reverse, inverts each one (``x2 = y2 -
g(y1)``, ``x1 = y1 - f(x2)``) and re-runs f and g with grad enabled to get
their input and parameter gradients, which it returns through autograd (so
each parameter's gradient is accumulated once, by autograd). ``reverse=False`` runs the same math
under plain autograd, which keeps every activation.

Each couple carries the dropout seeds of its f and g, which every call of
them gets (``seed=``), the recompute's too, as the JAX package hands each
sub-function its key (``key{i}f`` / ``key{i}g``): the masks are counter
hashes of the seed, so the recompute drops what the forward dropped.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def _route(kwargs, names):
    return {n: kwargs[n] for n in names if n in kwargs}


def _detached(kwargs):
    """Leaf copies of the routed tensors, with grad where the caller's had it."""
    return {
        n: v.detach().requires_grad_(v.requires_grad) if torch.is_tensor(v) else v
        for n, v in kwargs.items()
    }


def _grads(out, cotangent, inputs, module, kwargs):
    """Cotangents of the ``inputs``, of the module's parameters and of the
    routed tensors that need grad; None where the output does not depend on
    one."""
    params = list(module.parameters())
    leaves = {n: v for n, v in kwargs.items() if torch.is_tensor(v) and v.requires_grad}
    grads = torch.autograd.grad(
        out, [*inputs, *params, *leaves.values()], cotangent, allow_unused=True
    )
    n, m = len(inputs), len(inputs) + len(params)
    return grads[:n], grads[n:m], dict(zip(leaves, grads[m:]))


def _add(a, b):
    if a is None:
        return b
    return a if b is None else a + b


class _Reversible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, couples, names, x1, x2, *tensors):
        values = tensors[: len(names)]  # the parameters follow, for their gradients
        kwargs = dict(zip(names, values))
        for f, f_route, g, g_route, (fs, gs) in couples:
            x1 = x1 + f(x2, seed=fs, **_route(kwargs, f_route))
            x2 = x2 + g(x1, seed=gs, **_route(kwargs, g_route))
        ctx.couples, ctx.names = couples, names
        ctx.save_for_backward(x1, x2, *values)
        return x1, x2

    @staticmethod
    @once_differentiable
    def backward(ctx, dy1, dy2):
        y1, y2, *values = ctx.saved_tensors
        kwargs = _detached(dict(zip(ctx.names, values)))
        dkwargs = {}
        dparams = []
        for f, f_route, g, g_route, (fs, gs) in reversed(ctx.couples):
            with torch.enable_grad():
                y1_ = y1.detach().requires_grad_()
                g_kw = _route(kwargs, g_route)
                g_out = g(y1_, seed=gs, **g_kw)
                (dgy1,), dpg, dkw_g = _grads(g_out, dy2, [y1_], g, g_kw)
            x2 = y2 - g_out.detach()
            dy1 = dy1 + dgy1

            with torch.enable_grad():
                x2_ = x2.detach().requires_grad_()
                f_kw = _route(kwargs, f_route)
                f_out = f(x2_, seed=fs, **f_kw)
                (dfx2,), dpf, dkw_f = _grads(f_out, dy1, [x2_], f, f_kw)
            x1 = y1 - f_out.detach()

            dparams = [*dpf, *dpg, *dparams]
            for n, d in (*dkw_g.items(), *dkw_f.items()):
                dkwargs[n] = _add(dkwargs.get(n), d)
            y1, y2 = x1, x2
            dy2 = dy2 + dfx2  # dy1 already holds the x1 cotangent
        dvalues = [dkwargs.get(n) for n in ctx.names]
        return (None, None, dy1, dy2, *dvalues, *dparams)


def reversible_pair(couples, x1, x2, kwargs):
    """The stream pair (x1, x2) through ``couples`` (as in
    ``reversible_sequence``) with the O(1)-memory backward; returns the
    pair. ``kwargs`` holds no None."""
    names = tuple(kwargs)
    params = [p for f, _, g, *_ in couples for p in (*f.parameters(), *g.parameters())]
    return _Reversible.apply(couples, names, x1, x2, *kwargs.values(), *params)


def reversible_sequence(couples, x, kwargs, *, reverse=True):
    """Run the two-stream stack of ``couples``, each ``(f, f_route, g,
    g_route, (f_seed, g_seed))``: modules called as ``module(x, seed=s,
    **kw)`` with their dropout seed (or None) and the entries of ``kwargs``
    that their route names. Returns the mean of the two streams."""
    kwargs = {n: v for n, v in kwargs.items() if v is not None}
    if not reverse:
        y1 = y2 = x
        for f, f_route, g, g_route, (fs, gs) in couples:
            y1 = y1 + f(y2, seed=fs, **_route(kwargs, f_route))
            y2 = y2 + g(y1, seed=gs, **_route(kwargs, g_route))
        return (y1 + y2) * 0.5
    # autograd adds the two streams' cotangents into x's
    y1, y2 = reversible_pair(couples, x, x, kwargs)
    return (y1 + y2) * 0.5
