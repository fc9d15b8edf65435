"""Dual-stream (video + audio) reversible runtime: its forward.

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

Each stream enters both halves of its tower and leaves as their mean. The
forward keeps no activation: it runs inside a ``torch.autograd.Function``
whose ``backward`` raises until the recompute backward lands with
NUWAVideoAudio training. ``reverse=False`` runs the same math under plain
autograd, which keeps every activation.
"""
from __future__ import annotations

import torch


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
    """The quad-stream stack: ``blocks`` of (type, (f, g, j, k), routes)."""
    for btype, (f, g, j, k), routes in blocks:
        kw = {name: _route(kwargs, names) for name, names in routes.items()}
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


class _DualReversible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, names, video, audio, *tensors):
        kwargs = dict(zip(names, tensors[: len(names)]))  # the parameters follow
        return _run(blocks, video, video, audio, audio, kwargs)

    @staticmethod
    def backward(ctx, *cotangents):
        raise NotImplementedError(
            "the reversible dual backward comes with NUWAVideoAudio training; "
            "use reverse=False for gradients under plain autograd"
        )


def dual_reversible_sequence(blocks, video, audio, kwargs, *, reverse=True):
    """Run the twin towers over ``video`` and ``audio``; ``blocks`` are
    (type, (f, g, j, k), routes) with routes {"f": names, ...} into
    ``kwargs``. Returns the mean of each tower's two streams."""
    kwargs = {n: v for n, v in kwargs.items() if v is not None}
    if reverse:
        names = tuple(kwargs)
        params = [p for _, mods, _ in blocks for m in mods for p in m.parameters()]
        y1, y2, n1, n2 = _DualReversible.apply(
            blocks, names, video, audio, *kwargs.values(), *params
        )
    else:
        y1, y2, n1, n2 = _run(blocks, video, video, audio, audio, kwargs)
    return (y1 + y2) * 0.5, (n1 + n2) * 0.5
