"""Transformer stacks: depth x [self-attention, cross-attention?,
feed-forward], each block in a sandwich norm, and a final StableLayerNorm.

Counterpart of ``Transformer`` (a residual around every block) and
``ReversibleTransformer`` (the blocks run as reversible couples) of
``nuwa_tpu/transformer.py``, with their ``attn_dropout`` and ``ff_dropout``
and ``BindCP``. A Sparse3DNA stack's ``forward(..., cp_mesh=...)`` splits
each self-attention's frames over a mesh axis (context parallelism,
``parallel.context_parallel``); the other blocks run whole.
A stack's ``forward(..., seed=...)`` gives each layer a dropout seed of its
own, as the JAX stacks split one key a layer: one a menu entry in
``Transformer``, one for f and one for g of each couple in
``ReversibleTransformer`` (``core.layers.split_seed``). No seed: no dropout.
"""
from __future__ import annotations

from torch import nn

from .core.layers import LayerNorm, StableLayerNorm, split_seed
from .nda import Sparse3DNA, SparseCross2DNA
from .ops.attention import Attention
from .ops.feedforward import FeedForward
from .ops.shift import shift_audio_tokens
from .ops.shift import shift_video_tokens as shift_tokens
from .reversible import reversible_sequence


class Sandwich(nn.Module):
    """Pre- and post-LayerNorm around an inner block (CogView sandwich)."""

    def __init__(self, dim, inner):
        super().__init__()
        self.dim = dim
        self.pre = LayerNorm(dim)
        self.post = LayerNorm(dim)
        self.inner = inner

    def forward(self, x, **kw):
        return self.post(self.inner(self.pre(x), **kw))


class BindCP(nn.Module):
    """A block with a context-parallel mesh bound in: every call passes
    ``cp_mesh`` on to it. The reversible stacks route only tensors through
    their couples, so they bind the mesh into the self-attention instead, a
    new binding each call; the recompute in the backward calls it again, and
    its halo exchange with it."""

    def __init__(self, inner, cp_mesh):
        super().__init__()
        self.inner = inner
        self.cp_mesh = cp_mesh

    def forward(self, x, **kw):
        return self.inner(x, cp_mesh=self.cp_mesh, **kw)


class ShiftVideo(nn.Module):
    """Token shift before the inner block, along height and width
    (``shift_space``) and along the frames (``shift_time``), with the JAX
    module's defaults; the stacks build it with the defaults. It owns no
    parameters of its own: in the JAX params tree its inner block's
    parameters sit in its place (``convert`` skips this level)."""

    def __init__(self, inner, image_size, shift_space=True, shift_time=False):
        super().__init__()
        self.inner = inner
        self.image_size = image_size
        self.shift_space = shift_space
        self.shift_time = shift_time

    def forward(self, x, **kw):
        x = shift_tokens(x, self.image_size, self.shift_space, self.shift_time)
        return self.inner(x, **kw)


class ShiftAudio(nn.Module):
    """Audio token shift before the inner block; like ``ShiftVideo`` it owns
    no parameters, and its inner block's sit in its place in the JAX tree."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x, **kw):
        return self.inner(shift_audio_tokens(x), **kw)


def _build_layer_menu(dim, depth, heads=8, dim_head=64, causal=False, cross_attend=False,
                      cross_2dna_attn=False, cross_2dna_image_size=None,
                      cross_2dna_kernel_size=3, cross_2dna_dilations=(1,),
                      sparse_3dna_attn=False, sparse_3dna_kernel_size=3,
                      sparse_3dna_video_shape=None, sparse_3dna_dilations=(1,),
                      sparse_3dna_rel_pos_bias=False, shift_video_tokens=False,
                      include_cross_ff=False, attn_dropout=0.0, ff_dropout=0.0,
                      ff_chunk_size=None):
    """(kind, Sandwich) entries in the order of the JAX package's menu: per
    depth a self block, a cross block when cross-attending (followed by its
    own "ff_cross" when ``include_cross_ff``, the reversible layout), and one
    ff. The self block is Sparse3DNA, causal (the video decoder) or centered
    (the sketch encoder), or dense attention, causal (a dense decoder) or
    bidirectional (the text and sketch encoders); the cross block is dense
    attention (to text) or SparseCross2DNA (to sketch frames, dilation
    ``cross_2dna_dilations[depth % len]``). Every attention takes
    ``attn_dropout`` and every feed-forward ``ff_dropout`` and
    ``ff_chunk_size``."""
    if sparse_3dna_attn and sparse_3dna_video_shape is None:
        raise ValueError("sparse_3dna_attn needs sparse_3dna_video_shape")
    if cross_2dna_attn and cross_2dna_image_size is None:
        raise ValueError("cross_2dna_attn needs cross_2dna_image_size")
    shift = sparse_3dna_attn and shift_video_tokens
    fmap = sparse_3dna_video_shape[-1] if shift else None
    entries = []
    for ind in range(depth):
        if sparse_3dna_attn:
            self_attn = Sparse3DNA(
                dim=dim, heads=heads, dim_head=dim_head, causal=causal,
                kernel_size=sparse_3dna_kernel_size,
                dilation=sparse_3dna_dilations[ind % len(sparse_3dna_dilations)],
                video_shape=sparse_3dna_video_shape,
                rel_pos_bias=sparse_3dna_rel_pos_bias, dropout=attn_dropout,
            )
        else:
            self_attn = Attention(dim=dim, heads=heads, dim_head=dim_head, causal=causal,
                                  dropout=attn_dropout)
        ff = FeedForward(dim=dim, dropout=ff_dropout, chunk_size=ff_chunk_size)
        if shift:
            self_attn = ShiftVideo(self_attn, image_size=fmap)
            ff = ShiftVideo(ff, image_size=fmap)
        entries.append(("self", Sandwich(dim, self_attn)))
        if cross_attend:
            if cross_2dna_attn:
                cross = SparseCross2DNA(
                    dim=dim, heads=heads, dim_head=dim_head,
                    image_size=cross_2dna_image_size,
                    kernel_size=cross_2dna_kernel_size,
                    dilation=cross_2dna_dilations[ind % len(cross_2dna_dilations)],
                    dropout=attn_dropout,
                )
            else:
                cross = Attention(dim=dim, heads=heads, dim_head=dim_head,
                                  dropout=attn_dropout)
            entries.append(("cross", Sandwich(dim, cross)))
            if include_cross_ff:
                ff_cross = FeedForward(dim=dim, dropout=ff_dropout, chunk_size=ff_chunk_size)
                if shift:
                    ff_cross = ShiftVideo(ff_cross, image_size=fmap)
                entries.append(("ff_cross", Sandwich(dim, ff_cross)))
        entries.append(("ff", Sandwich(dim, ff)))
    return entries


class Transformer(nn.Module):
    include_cross_ff = False  # the reversible stack's layout adds ff_cross

    def __init__(self, dim, depth, heads=8, dim_head=64, causal=False, cross_attend=False,
                 cross_2dna_attn=False, cross_2dna_image_size=None,
                 cross_2dna_kernel_size=3, cross_2dna_dilations=(1,),
                 sparse_3dna_attn=False, sparse_3dna_kernel_size=3,
                 sparse_3dna_video_shape=None, sparse_3dna_dilations=(1,),
                 sparse_3dna_rel_pos_bias=False, shift_video_tokens=False,
                 attn_dropout=0.0, ff_dropout=0.0, ff_chunk_size=None):
        super().__init__()
        self.dim = dim
        self.sparse_3dna_attn = sparse_3dna_attn
        self._assemble(_build_layer_menu(
            dim, depth, heads=heads, dim_head=dim_head, causal=causal,
            cross_attend=cross_attend,
            cross_2dna_attn=cross_2dna_attn, cross_2dna_image_size=cross_2dna_image_size,
            cross_2dna_kernel_size=cross_2dna_kernel_size,
            cross_2dna_dilations=tuple(cross_2dna_dilations),
            sparse_3dna_attn=sparse_3dna_attn,
            sparse_3dna_kernel_size=sparse_3dna_kernel_size,
            sparse_3dna_video_shape=sparse_3dna_video_shape,
            sparse_3dna_dilations=tuple(sparse_3dna_dilations),
            sparse_3dna_rel_pos_bias=sparse_3dna_rel_pos_bias,
            shift_video_tokens=shift_video_tokens,
            include_cross_ff=self.include_cross_ff,
            attn_dropout=attn_dropout, ff_dropout=ff_dropout, ff_chunk_size=ff_chunk_size,
        ))
        self.norm = StableLayerNorm(dim)

    def _assemble(self, menu):
        self.kinds = [kind for kind, _ in menu]
        self.layers = nn.ModuleList([m for _, m in menu])

    @property
    def layer_menu(self):
        """(kind, module) per entry in the JAX package's menu order."""
        return list(zip(self.kinds, self.layers))

    def run_layers(self, x, start, stop, seeds, *, mask=None, context=None, context_mask=None,
                   rotary_pos_emb=None, cp_mesh=None):
        """Residual layers ``start`` to ``stop`` (a pipeline stage's slice),
        ``seeds`` theirs, each block's keyword arguments routed by its kind."""
        for kind, layer, s in zip(self.kinds[start:stop], self.layers[start:stop], seeds):
            if kind == "self":
                kw = dict(mask=mask, rotary_pos_emb=rotary_pos_emb)
                if cp_mesh is not None and self.sparse_3dna_attn:
                    kw["cp_mesh"] = cp_mesh
            elif kind == "cross":
                kw = dict(context=context, context_mask=context_mask)
            else:
                kw = {}
            x = layer(x, seed=s, **kw) + x
        return x

    def forward(self, x, *, mask=None, context=None, context_mask=None,
                rotary_pos_emb=None, seed=None, cp_mesh=None):
        x = self.run_layers(x, 0, len(self.layers), split_seed(seed, len(self.layers)),
                            mask=mask, context=context, context_mask=context_mask,
                            rotary_pos_emb=rotary_pos_emb, cp_mesh=cp_mesh)
        return self.norm(x)


class Couple(nn.Module):
    """One reversible couple: ``f`` reads the second stream into the first,
    ``g`` the first into the second (the JAX params' ``{"f", "g"}``)."""

    def __init__(self, f, g):
        super().__init__()
        self.f = f
        self.g = g


# which call-site keyword arguments each couple's f receives (g, a
# feed-forward, takes none)
_ROUTES = {"self": ("mask", "rotary_pos_emb"), "cross": ("context", "context_mask")}


class ReversibleTransformer(Transformer):
    """The same layer menu as ``Transformer``, with a feed-forward of its own
    after each cross block, run as reversible couples: per depth
    (self, ff) and, when cross-attending, (cross, ff_cross)."""

    include_cross_ff = True

    def _assemble(self, menu):
        kinds, couples = [], []
        for i, (kind, module) in enumerate(menu):
            if kind == "self":  # paired with the ff that closes its depth
                ff = next(m for k, m in menu[i + 1 :] if k == "ff")
                kinds.append(kind)
                couples.append(Couple(module, ff))
            elif kind == "cross":
                kinds.append(kind)
                couples.append(Couple(module, menu[i + 1][1]))
        self.kinds = kinds
        self.layers = nn.ModuleList(couples)

    @property
    def layer_menu(self):
        """(kind, module) per entry in the JAX package's menu order: per
        depth self, cross, ff_cross, ff."""
        menu = []
        for i, (kind, c) in enumerate(zip(self.kinds, self.layers)):
            if kind == "self":
                menu.append(("self", c.f))
                ff = c.g  # closes the depth, after its cross couple if any
                if self.kinds[i + 1:i + 2] != ["cross"]:
                    menu.append(("ff", ff))
            else:
                menu += [("cross", c.f), ("ff_cross", c.g), ("ff", ff)]
        return menu

    def couples(self, seed=None, cp_mesh=None):
        """The couples in ``reversible_sequence``'s form, each with its f and
        g dropout seeds (f0, g0, f1, g1, ... of ``seed``)."""
        seeds = split_seed(seed, 2 * len(self.layers))
        bind = cp_mesh is not None and self.sparse_3dna_attn
        return [(BindCP(c.f, cp_mesh) if bind and kind == "self" else c.f,
                 _ROUTES[kind], c.g, (), (seeds[2 * i], seeds[2 * i + 1]))
                for i, (kind, c) in enumerate(zip(self.kinds, self.layers))]

    def forward(self, x, *, mask=None, context=None, context_mask=None,
                rotary_pos_emb=None, reverse=True, seed=None, cp_mesh=None):
        kwargs = dict(mask=mask, context=context, context_mask=context_mask,
                      rotary_pos_emb=rotary_pos_emb)
        return self.norm(reversible_sequence(self.couples(seed, cp_mesh), x, kwargs,
                                             reverse=reverse))
