"""Building blocks: attention, cross-modality attention, positional
embeddings, the feed-forward, sampling and the token shifts.

Counterpart of ``nuwa_tpu/ops``, with the same exports.
"""
from .attention import Attention
from .crossmodality import CrossModalityCrossAttention
from .embeddings import AxialPositionalEmbedding, apply_rotary_pos_emb, rotary_freqs
from .feedforward import FeedForward, geglu
from .sampling import gumbel_sample, prob_mask_like, top_k_filter
from .shift import shift_audio_tokens, shift_video_tokens

__all__ = [
    "Attention",
    "CrossModalityCrossAttention",
    "AxialPositionalEmbedding",
    "apply_rotary_pos_emb",
    "rotary_freqs",
    "FeedForward",
    "geglu",
    "gumbel_sample",
    "prob_mask_like",
    "top_k_filter",
    "shift_audio_tokens",
    "shift_video_tokens",
]
