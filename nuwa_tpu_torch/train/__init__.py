"""Training: the optimizer, the host-side data pipeline, checkpoints, the
EMA, ``NUWATrainer`` and ``VQGanVAETrainer``.

Counterpart of ``nuwa_tpu/train``: the trainers on one device or, with
``mesh=``, data- and tensor-parallel (``nuwa_tpu_torch.parallel``).
"""
from .checkpoint import latest_checkpoint, load_checkpoint, restore_latest, save_checkpoint
from .data import (
    DataLoader,
    GifVideoDataset,
    ImageDataset,
    MemmappedImageDataset,
    MnistDataset,
    VideoIndicesDataset,
    accum_log,
    convert_video_dataset_to_indices,
    cycle,
    pad_collate,
    stack_microbatches,
)
from .ema import ema_init, ema_update
from .optimizer import clip_by_global_norm_, get_optimizer, weight_decay_mask
from .trainer_nuwa import NUWATrainer
from .trainer_vqgan import VQGanVAETrainer

__all__ = [
    "DataLoader",
    "GifVideoDataset",
    "ImageDataset",
    "MemmappedImageDataset",
    "MnistDataset",
    "VideoIndicesDataset",
    "accum_log",
    "convert_video_dataset_to_indices",
    "cycle",
    "pad_collate",
    "stack_microbatches",
    "ema_init",
    "ema_update",
    "clip_by_global_norm_",
    "get_optimizer",
    "weight_decay_mask",
    "NUWATrainer",
    "VQGanVAETrainer",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "restore_latest",
]
