"""Dual-stream (video + audio) reversible runtime.

Counterpart of ``nuwa_tpu/reversible_dual.py``. Twin reversible towers with
three block types, each a quad of modules (f, g, j, k):

  * ``self`` / ``cross``: two independent couples
        y1 = x1 + f(x2) ; y2 = x2 + g(y1)        (video)
        n1 = m1 + j(m2) ; n2 = m2 + k(n1)        (audio)
  * ``xmod``: the audio->video attention reads the *updated* video stream,
    which keeps the quad invertible:
        y1 = x1 + f(x2, m2)   # video attends audio
        y2 = x2 + k(y1)       # video ff
        n1 = m1 + j(m2, y2)   # audio attends the updated video
        n2 = m2 + g(n1)       # audio ff

Each stream enters both halves of its tower and leaves as their mean
(``dual_reversible_sequence``); a pipeline stage takes the quad and hands it
on (``dual_reversible_quad``). The forward keeps only the last four streams
and the routed tensors. The backward walks the blocks in reverse and
inverts each quad in the JAX package's order: an ``xmod`` quad g, then j
(which reads the updated y2), then k, then f (which reads m2); a ``self`` /
``cross`` quad g and f, then k and j. It re-runs each module with grad
enabled on detached inputs to get its input, parameter and routed-tensor
cotangents (the text ``context`` among them), and returns them through
autograd, so each parameter's gradient is accumulated once.
``reverse=False`` runs the same math under plain autograd, which keeps
every activation. Each block carries the dropout seeds of its four
modules, which every call of them gets, the recompute's too (the JAX
package's ``key{i}f`` ... ``key{i}k``).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .reversible import _add, _detached, _grads


def _route(kwargs, names):
    """The entries of ``kwargs`` that ``names`` routes: each a name, or a
    (name in ``kwargs``, keyword) pair."""
    out = {}
    for entry in names:
        src, dst = entry if isinstance(entry, tuple) else (entry, entry)
        if src in kwargs:
            out[dst] = kwargs[src]
    return out


def _run(blocks, x1, x2, m1, m2, kwargs):
    """The quad-stream stack: ``blocks`` of (type, (f, g, j, k), routes,
    seeds)."""
    for btype, (f, g, j, k), routes, seeds in blocks:
        kw = {name: dict(_route(kwargs, routes[name]), seed=s) for name, s in zip("fgjk", seeds)}
        if btype == "xmod":
            x1 = x1 + f(x2, m2, **kw["f"])
            x2 = x2 + k(x1, **kw["k"])
            m1 = m1 + j(m2, x2, **kw["j"])
            m2 = m2 + g(m1, **kw["g"])
        else:
            x1 = x1 + f(x2, **kw["f"])
            x2 = x2 + g(x1, **kw["g"])
            m1 = m1 + j(m2, **kw["j"])
            m2 = m2 + k(m1, **kw["k"])
    return x1, x2, m1, m2


def _vjp(module, inputs, kwargs, names, seed, cotangent, dkwargs):
    """Re-run ``module(*inputs, seed=seed, **kw)``, ``kw`` the entries of
    ``kwargs`` that ``names`` routes, with grad on detached copies of the
    inputs; add
    the routed tensors' cotangents into ``dkwargs`` under their names in
    ``kwargs``. Returns the output (detached) and the cotangents of the
    inputs and of the module's parameters, None where the output does not
    depend on one."""
    kw = _route(kwargs, names)
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_() for x in inputs]
        out = module(*inputs, seed=seed, **kw)
        dinputs, dparams, dkw = _grads(out, cotangent, inputs, module, kw)
    for entry in names:
        src, dst = entry if isinstance(entry, tuple) else (entry, entry)
        if dst in dkw:
            dkwargs[src] = _add(dkwargs.get(src), dkw[dst])
    return out.detach(), dinputs, dparams


class _DualReversible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, names, x1, x2, m1, m2, *tensors):
        values = tensors[: len(names)]  # the parameters follow, for their gradients
        outs = _run(blocks, x1, x2, m1, m2, dict(zip(names, values)))
        ctx.blocks, ctx.names = blocks, names
        ctx.save_for_backward(*outs, *values)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, dy1, dy2, dn1, dn2):
        y1, y2, n1, n2, *values = ctx.saved_tensors
        kwargs = _detached(dict(zip(ctx.names, values)))
        dkwargs, dparams = {}, []
        for btype, (f, g, j, k), routes, (sf, sg, sj, sk) in reversed(ctx.blocks):
            if btype == "xmod":
                out, (dgn1,), dpg = _vjp(g, (n1,), kwargs, routes["g"], sg, dn2, dkwargs)
                m2 = n2 - out
                dn1 = dn1 + dgn1

                out, (djm2, djy2), dpj = _vjp(j, (m2, y2), kwargs, routes["j"], sj, dn1,
                                              dkwargs)
                m1 = n1 - out
                dm2 = dn2 + djm2
                dy2 = dy2 + djy2

                out, (dky1,), dpk = _vjp(k, (y1,), kwargs, routes["k"], sk, dy2, dkwargs)
                x2 = y2 - out
                dy1 = dy1 + dky1

                out, (dfx2, dfm2), dpf = _vjp(f, (x2, m2), kwargs, routes["f"], sf, dy1,
                                              dkwargs)
                x1 = y1 - out
                dx2 = dy2 + dfx2
                dm2 = dm2 + dfm2
            else:
                out, (dgy1,), dpg = _vjp(g, (y1,), kwargs, routes["g"], sg, dy2, dkwargs)
                x2 = y2 - out
                dy1 = dy1 + dgy1

                out, (dfx2,), dpf = _vjp(f, (x2,), kwargs, routes["f"], sf, dy1, dkwargs)
                x1 = y1 - out
                dx2 = dy2 + dfx2

                out, (dkn1,), dpk = _vjp(k, (n1,), kwargs, routes["k"], sk, dn2, dkwargs)
                m2 = n2 - out
                dn1 = dn1 + dkn1

                out, (djm2,), dpj = _vjp(j, (m2,), kwargs, routes["j"], sj, dn1, dkwargs)
                m1 = n1 - out
                dm2 = dn2 + djm2
            # the forward's parameter order: f, g, j, k per block
            dparams = [*dpf, *dpg, *dpj, *dpk, *dparams]
            y1, y2, n1, n2 = x1, x2, m1, m2
            dy2, dn2 = dx2, dm2  # dy1 and dn1 already hold the x1, m1 cotangents
        dvalues = [dkwargs.get(n) for n in ctx.names]
        return (None, None, dy1, dy2, dn1, dn2, *dvalues, *dparams)


def dual_reversible_quad(blocks, x1, x2, m1, m2, kwargs):
    """The quad (x1, x2, m1, m2) through ``blocks`` (as in
    ``dual_reversible_sequence``) with the O(1)-memory backward; returns the
    quad. ``kwargs`` holds no None."""
    names = tuple(kwargs)
    params = [p for _, mods, *_ in blocks for m in mods for p in m.parameters()]
    return _DualReversible.apply(blocks, names, x1, x2, m1, m2, *kwargs.values(), *params)


def dual_reversible_sequence(blocks, video, audio, kwargs, *, reverse=True):
    """Run the twin towers over ``video`` and ``audio``; ``blocks`` are
    (type, (f, g, j, k), routes, seeds) with routes {"f": names, ...} into
    ``kwargs`` and seeds the four modules' dropout seeds (f, g, j, k).
    Returns the mean of each tower's two streams."""
    kwargs = {n: v for n, v in kwargs.items() if v is not None}
    if reverse:  # autograd adds each tower's two cotangents into its input's
        y1, y2, n1, n2 = dual_reversible_quad(blocks, video, video, audio, audio, kwargs)
    else:
        y1, y2, n1, n2 = _run(blocks, video, video, audio, audio, kwargs)
    return (y1 + y2) * 0.5, (n1 + n2) * 0.5
