"""The device mesh and where a tensor's parts lie on it.

Counterpart of ``nuwa_tpu/parallel/mesh.py``. The JAX package is one
program over a ``jax.sharding.Mesh`` and XLA inserts the collectives; the
port runs one process a rank, every rank the same code, over a
``torch.distributed`` device mesh with the axes ``("data", "model")``: the
batch over ``data``, the TP rules' parameter splits over ``model``
(``parallel.sharding``), or ``("data", "model", "context")`` with the
frames of the Sparse3DNA attention over ``context``
(``parallel.context_parallel``), or ``("data", "pipe")`` with the decoder
stack's stages over ``pipe`` (``parallel.pipeline``). The ranks talk over
NCCL on the card and over gloo on the CPU (the tests); a mesh on ``cuda``
needs NCCL and never falls back.

``Sharding(mesh, spec)`` takes the place of ``NamedSharding``: ``spec`` a
tuple of axis names or None a dimension, as a ``PartitionSpec``; ``local``
takes this rank's part of a whole tensor, ``whole`` gathers the parts.
"""
from __future__ import annotations

import torch.distributed as dist

from ..core.tp import Shard

AXES = ("data", "model")
CP_AXES = ("data", "model", "context")
PP_AXES = ("data", "pipe")


def make_mesh(data: int = -1, model: int = 1, context: int = 1, pipe: int = 1,
              device: str = "cuda"):
    """A ("data", "model") device mesh over the initialised process group's
    ranks (rank = data index * model + model index), or with ``context > 1``
    a ("data", "model", "context") one (DPxCP: the batch over 'data', the
    frames over 'context'; rank = (data index * model + model index) *
    context + context index, JAX's ``reshape(data, model, context)``), or
    with ``pipe > 1`` a ("data", "pipe") one (PPxDP: GPipe stages over
    'pipe'; rank = data index * pipe + pipe index, JAX's ``reshape(data,
    pipe)``); ``data=-1`` takes the rest of the world. ``device="cpu"``
    builds it on the CPU over gloo (the tests); on ``cuda`` the group's
    backend must be NCCL."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    backend = dist.get_backend()
    want = "nccl" if device == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"a mesh on {device} needs the {want} backend, the process "
                           f"group has {backend}")
    n = dist.get_world_size()
    from torch.distributed.device_mesh import init_device_mesh

    if pipe > 1:
        assert model == 1 and context == 1, (
            "pipe composes with 'data' only (stage params are replicated "
            "across every other axis)")
        if data == -1:
            assert n % pipe == 0, f"{n} devices not divisible by pipe={pipe}"
            data = n // pipe
        assert data * pipe == n, f"mesh {data}x{pipe} != {n} devices"
        return init_device_mesh(device, (data, pipe), mesh_dim_names=PP_AXES)
    if data == -1:
        assert n % (model * context) == 0, (
            f"{n} devices not divisible by model*context={model * context}")
        data = n // (model * context)
    assert data * model * context == n, f"mesh {data}x{model}x{context} != {n} devices"
    if context > 1:
        return init_device_mesh(device, (data, model, context), mesh_dim_names=CP_AXES)
    return init_device_mesh(device, (data, model), mesh_dim_names=AXES)


def axis_sizes(mesh) -> dict:
    """{axis name: size}: JAX's ``mesh.shape``."""
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"a mesh is a device mesh from make_mesh, got {type(mesh).__name__}")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name) -> int:
    return axis_sizes(mesh).get(name, 1)


def axis_shard(mesh, name, dim) -> Shard:
    """The ``Shard`` of a split along ``dim`` over the axis ``name``."""
    return Shard(dim, mesh.get_group(name), axis_size(mesh, name), mesh.get_local_rank(name))


class Sharding:
    """A tensor's layout on ``mesh``: ``spec[i]`` is the axis that splits
    dimension i, or None (a missing entry is None)."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def shards(self):
        return [axis_shard(self.mesh, name, dim) for dim, name in enumerate(self.spec)
                if name is not None and axis_size(self.mesh, name) > 1]

    def local(self, t):
        """This rank's part of the whole tensor ``t``."""
        for shard in self.shards():
            t = shard.part(t)
        return t

    def whole(self, t):
        """The whole tensor from every rank's part ``t`` (a collective)."""
        for shard in reversed(self.shards()):
            t = shard.gather(t)
        return t


def data_sharding(mesh, ndim: int = 1) -> Sharding:
    """The leading (batch) axis over 'data', the rest whole: ``local``
    takes this rank's rows of a global batch."""
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())
