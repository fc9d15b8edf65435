"""nuwa_tpu_torch — the PyTorch / CUDA port of nuwa_tpu for NVIDIA Hopper.

It imports torch and numpy, never JAX or ``nuwa_tpu``. Module names follow
the JAX package's, so each module's counterpart is easy to find. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``. The names below
are the JAX package's public surface, and the default ``tokenizer`` (CLIP's
vocabulary of 49,408).
"""
from .models import NUWA, NUWASketch, NUWAVideoAudio
from .nda import Sparse3DNA, SparseCausal2DNA, SparseCross2DNA
from .ops.attention import Attention
from .ops.crossmodality import CrossModalityCrossAttention
from .tokenizer import tokenizer
from .train import NUWATrainer, VQGanVAETrainer
from .vqgan_vae import VQGanVAE

__all__ = ["NUWA", "NUWASketch", "NUWAVideoAudio", "VQGanVAE", "Sparse3DNA",
           "SparseCausal2DNA", "SparseCross2DNA", "CrossModalityCrossAttention", "Attention",
           "NUWATrainer", "VQGanVAETrainer", "tokenizer"]
