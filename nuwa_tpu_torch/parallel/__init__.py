"""Data and tensor parallelism and ZeRO-1 on ``torch.distributed``.

Counterpart of ``nuwa_tpu/parallel`` without its context and pipeline
parallelism (``context_parallel.py``, ``pipeline.py``: ROADMAP A8b).
"""
from .mesh import Sharding, data_sharding, make_mesh, replicated
from .sharding import (
    make_param_specs,
    partition_spec_for,
    shard_params,
    sharded_train_step,
)
from .zero import Zero1AdamW, shard_opt_state, zero_opt_shardings, zero_opt_specs

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "Sharding",
    "make_param_specs",
    "partition_spec_for",
    "shard_params",
    "sharded_train_step",
    "shard_opt_state",
    "zero_opt_shardings",
    "zero_opt_specs",
    "Zero1AdamW",
]
