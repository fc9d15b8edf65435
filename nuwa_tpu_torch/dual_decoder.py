"""Twin-tower video + audio decoders.

Counterpart of ``nuwa_tpu/dual_decoder.py``. Per depth:

  intra-modality self:  video Sparse3DNA and audio SparseCausal2DNA (+ FFs)
  intra-modality cross: video->text and audio->text dense Attention (+ FFs)
  every k-th depth:     video<->audio chunk-aligned CrossModalityCrossAttention

as a schedule of (type, quad) blocks, each quad (f, g, j, k) of sandwiched
modules: f and g act on the video stream and j and k on audio, except in an
``xmod`` quad, whose g is the audio stream's feed-forward and k the video
stream's (the JAX package's order). ``DualModalityDecoder`` runs the
schedule with plain residuals, its inter-modality step reading the
pre-update opposite streams, and with ``remat`` recomputes each block in
the backward (``torch.utils.checkpoint``) instead of keeping its
activations; ``ReversibleDualModalityDecoder`` runs it through
``reversible_dual``, where audio reads the updated video and the backward
rebuilds every activation by inversion (it ignores ``remat``). Both keep
the JAX package's layer menu: per depth [self + ff] then [cross + ff], so
the plain decoder carries one more FF per stream and depth than the
reference's non-reversible layout. The context-parallel binding (``BindCP``)
is not ported.

``attn_dropout`` reaches every attention of the schedule and ``ff_dropout``
and ``ff_chunk_size`` every feed-forward. ``forward(..., seed=...)`` gives each block four seeds,
one for each of f, g, j and k (``core.layers.split_seed``), as the JAX
decoders split four keys a block; the reversible recompute and ``remat``'s
both re-run each module with its seed, and the counter-hash masks replay.
"""
from __future__ import annotations

from torch import nn
from torch.utils.checkpoint import checkpoint

from .core.layers import StableLayerNorm, split_seed
from .nda import Sparse3DNA, SparseCausal2DNA
from .ops.attention import Attention
from .ops.crossmodality import CrossModalityCrossAttention
from .ops.feedforward import FeedForward
from .reversible_dual import dual_reversible_sequence
from .transformer import Sandwich, ShiftAudio, ShiftVideo


class SandwichX(Sandwich):
    """Sandwich norm whose inner module takes (x, context) positionally: the
    dual decoder's CrossModalityCrossAttention. The context is not normed."""

    def forward(self, x, context=None, **kw):
        return self.post(self.inner(self.pre(x), context, **kw))


class Quad(nn.Module):
    """One schedule entry's four modules (the JAX params' f, g, j, k)."""

    def __init__(self, f, g, j, k):
        super().__init__()
        self.f, self.g, self.j, self.k = f, g, j, k

    def mods(self):
        return self.f, self.g, self.j, self.k


def apply_dual_block(btype, mods, video, audio, *, context=None, context_mask=None,
                     video_mask=None, audio_mask=None, seeds=(None,) * 4):
    """One schedule entry of the plain dual decoder: the (video, audio) pair
    through the block's four sandwiched modules, each with its dropout seed
    (``seeds``: f, g, j, k)."""
    f, g, j, k = mods
    sf, sg, sj, sk = seeds
    if btype == "self":
        video = f(video, mask=video_mask, seed=sf) + video
        video = g(video, seed=sg) + video
        audio = j(audio, mask=audio_mask, seed=sj) + audio
        audio = k(audio, seed=sk) + audio
    elif btype == "cross":
        video = f(video, context=context, mask=video_mask, context_mask=context_mask,
                  seed=sf) + video
        video = g(video, seed=sg) + video
        audio = j(audio, context=context, mask=audio_mask, context_mask=context_mask,
                  seed=sj) + audio
        audio = k(audio, seed=sk) + audio
    else:  # xmod: both sides read the pre-update streams
        video_new = f(video, audio, mask=video_mask, context_mask=audio_mask, seed=sf) + video
        audio_new = j(audio, video, mask=audio_mask, context_mask=video_mask, seed=sj) + audio
        # g is the audio stream's ff, k the video stream's
        video = k(video_new, seed=sk) + video_new
        audio = g(audio_new, seed=sg) + audio_new
    return video, audio


# the keyword arguments each module of a quad reads in the reversible
# runtime: a name of the decoder's keyword arguments or (name, keyword)
_ROUTES = {
    "self": {"f": (("video_mask", "mask"),), "g": (),
             "j": (("audio_mask", "mask"),), "k": ()},
    "cross": {"f": ("context", "context_mask", ("video_mask", "mask")), "g": (),
              "j": ("context", "context_mask", ("audio_mask", "mask")), "k": ()},
    "xmod": {"f": (("video_mask", "mask"), ("audio_mask", "context_mask")), "g": (),
             "j": (("audio_mask", "mask"), ("video_mask", "context_mask")), "k": ()},
}


def block_seeds(seed, n):
    """The dropout seeds (f, g, j, k) of each of ``n`` blocks from ``seed``
    (``core.layers.split_seed``: None, one int, or four a block in order)."""
    seeds = split_seed(seed, 4 * n)
    return [tuple(seeds[4 * i:4 * i + 4]) for i in range(n)]


def reversible_dual_blocks(blocks, seed=None):
    """A ``DualModalityDecoder.blocks()`` schedule in ``reversible_dual``'s
    form: each (type, quad) with the routes its four modules read and their
    four dropout seeds."""
    return [(btype, mods, _ROUTES[btype], seeds)
            for (btype, mods), seeds in zip(blocks, block_seeds(seed, len(blocks)))]


class DualModalityDecoder(nn.Module):
    def __init__(self, dim, depth, num_audio_tokens_per_video_frame,
                 num_video_tokens_per_frame, sparse_3dna_video_shape, heads=8, dim_head=64,
                 sparse_3dna_kernel_size=3, sparse_3dna_dilations=(1,),
                 sparse_3dna_rel_pos_bias=False, sparse_2dna_kernel_size=7,
                 sparse_2dna_dilation=(1,), sparse_2dna_rel_pos_bias=False,
                 shift_video_tokens=False, shift_audio_tokens=False,
                 audio_tokens_per_timestep=1, cross_modality_attn_every=3, remat=False,
                 attn_dropout=0.0, ff_dropout=0.0, ff_chunk_size=None):
        super().__init__()
        self.dim = dim
        self.remat = remat
        fmap = sparse_3dna_video_shape[-1]

        def sand(inner):
            return Sandwich(dim, inner)

        def feedforward():
            return FeedForward(dim, dropout=ff_dropout, chunk_size=ff_chunk_size)

        def video_ff():
            ff = feedforward()
            return sand(ShiftVideo(ff, image_size=fmap) if shift_video_tokens else ff)

        def audio_ff():
            ff = feedforward()
            return sand(ShiftAudio(ff) if shift_audio_tokens else ff)

        def attention():
            return sand(Attention(dim=dim, heads=heads, dim_head=dim_head, dropout=attn_dropout))

        def xmod(chunk, context_chunk):
            return SandwichX(dim, CrossModalityCrossAttention(
                dim=dim, heads=heads, dim_head=dim_head, chunk_size=chunk,
                context_chunk_size=context_chunk, dropout=attn_dropout))

        kinds, quads = [], []
        vtpf, atpf = num_video_tokens_per_frame, num_audio_tokens_per_video_frame
        for ind in range(depth):
            video_self = Sparse3DNA(
                dim=dim, heads=heads, dim_head=dim_head, causal=True,
                kernel_size=sparse_3dna_kernel_size,
                dilation=sparse_3dna_dilations[ind % len(sparse_3dna_dilations)],
                video_shape=sparse_3dna_video_shape, rel_pos_bias=sparse_3dna_rel_pos_bias,
                dropout=attn_dropout,
            )
            if shift_video_tokens:
                video_self = ShiftVideo(video_self, image_size=fmap)
            audio_self = SparseCausal2DNA(
                dim=dim, height=audio_tokens_per_timestep, heads=heads, dim_head=dim_head,
                kernel_size=sparse_2dna_kernel_size,
                dilation=sparse_2dna_dilation[ind % len(sparse_2dna_dilation)],
                rel_pos_bias=sparse_2dna_rel_pos_bias, dropout=attn_dropout,
            )
            if shift_audio_tokens:
                audio_self = ShiftAudio(audio_self)
            kinds.append("self")
            quads.append(Quad(sand(video_self), video_ff(), sand(audio_self), audio_ff()))
            kinds.append("cross")
            quads.append(Quad(attention(), video_ff(), attention(), audio_ff()))
            if (ind + 1) % cross_modality_attn_every == 0:
                # the xmod feed-forwards take no token shift
                kinds.append("xmod")
                quads.append(Quad(xmod(vtpf, atpf), sand(feedforward()),
                                  xmod(atpf, vtpf), sand(feedforward())))
        self.kinds = kinds
        self.layers = nn.ModuleList(quads)
        self.video_norm = StableLayerNorm(dim)
        self.audio_norm = StableLayerNorm(dim)

    def blocks(self):
        """The schedule: (type, (f, g, j, k)) per block."""
        return [(kind, quad.mods()) for kind, quad in zip(self.kinds, self.layers)]

    def forward(self, video, audio, *, context, audio_mask=None, video_mask=None,
                context_mask=None, seed=None):
        kw = dict(context=context, context_mask=context_mask, video_mask=video_mask,
                  audio_mask=audio_mask)
        blocks = self.blocks()
        for (btype, mods), seeds in zip(blocks, block_seeds(seed, len(blocks))):
            kw["seeds"] = seeds
            if self.remat:
                video, audio = checkpoint(apply_dual_block, btype, mods, video, audio,
                                          use_reentrant=False, **kw)
            else:
                video, audio = apply_dual_block(btype, mods, video, audio, **kw)
        return self.video_norm(video), self.audio_norm(audio)


class ReversibleDualModalityDecoder(DualModalityDecoder):
    """The same schedule as quad-stream reversible blocks."""

    def forward(self, video, audio, *, context, audio_mask=None, video_mask=None,
                context_mask=None, reverse=True, seed=None):
        blocks = reversible_dual_blocks(self.blocks(), seed)
        kwargs = dict(context=context, context_mask=context_mask, video_mask=video_mask,
                      audio_mask=audio_mask)
        video, audio = dual_reversible_sequence(blocks, video, audio, kwargs, reverse=reverse)
        return self.video_norm(video), self.audio_norm(audio)
