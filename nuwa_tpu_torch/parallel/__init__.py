"""Data, tensor, context and pipeline parallelism and ZeRO-1 on
``torch.distributed``.

Counterpart of ``nuwa_tpu/parallel``. As in the JAX package, the
context-parallel function is not exported here: it lives at
``nuwa_tpu_torch.parallel.context_parallel.context_parallel_sparse_3dna``.
"""
from .mesh import Sharding, data_sharding, make_mesh, replicated
from .pipeline import pipelined_transformer, stack_stage_params, validate_stages
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
    "pipelined_transformer",
    "stack_stage_params",
    "validate_stages",
    "shard_opt_state",
    "zero_opt_shardings",
    "zero_opt_specs",
    "Zero1AdamW",
]
