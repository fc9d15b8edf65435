"""nuwa_tpu_torch — the PyTorch / CUDA port of nuwa_tpu for NVIDIA Hopper.

It imports torch and numpy, never JAX or ``nuwa_tpu``. Module names follow
the JAX package's, so each module's counterpart is easy to find. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .models import NUWA, NUWASketch
from .vqgan_vae import VQGanVAE

__all__ = ["NUWA", "NUWASketch", "VQGanVAE"]
