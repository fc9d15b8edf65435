"""Training: the optimizer, the host-side data pipeline, checkpoints and
``NUWATrainer``.

Counterpart of ``nuwa_tpu/train`` for NUWA on one device; the EMA and the
VQGAN trainer are still to port.
"""
from .checkpoint import latest_checkpoint, load_checkpoint, restore_latest, save_checkpoint
from .data import DataLoader, accum_log, cycle, pad_collate, stack_microbatches
from .optimizer import clip_by_global_norm_, get_optimizer, weight_decay_mask
from .trainer_nuwa import NUWATrainer

__all__ = [
    "DataLoader",
    "accum_log",
    "cycle",
    "pad_collate",
    "stack_microbatches",
    "clip_by_global_norm_",
    "get_optimizer",
    "weight_decay_mask",
    "NUWATrainer",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "restore_latest",
]
