"""The device mesh and where a tensor's parts lie on it.

Counterpart of ``nuwa_tpu/parallel/mesh.py``. The JAX package is one
program over a ``jax.sharding.Mesh`` and XLA inserts the collectives; the
port runs one process a rank, every rank the same code, over a
``torch.distributed`` device mesh with the axes ``("data", "model")``: the
batch over ``data``, the TP rules' parameter splits over ``model``
(``parallel.sharding``). The ranks talk over NCCL on the card and over gloo
on the CPU (the tests); a mesh on ``cuda`` needs NCCL and never falls back.

``Sharding(mesh, spec)`` takes the place of ``NamedSharding``: ``spec`` a
tuple of axis names or None a dimension, as a ``PartitionSpec``; ``local``
takes this rank's part of a whole tensor, ``whole`` gathers the parts.
"""
from __future__ import annotations

import torch.distributed as dist

from ..core.tp import Shard

AXES = ("data", "model")


def make_mesh(data: int = -1, model: int = 1, context: int = 1, pipe: int = 1,
              device: str = "cuda"):
    """A ("data", "model") device mesh over the initialised process group's
    ranks (rank = data index * model + model index); ``data=-1`` takes the
    rest of the world. ``device="cpu"`` builds it on the CPU over gloo (the
    tests); on ``cuda`` the group's backend must be NCCL."""
    if context > 1 or pipe > 1:
        raise NotImplementedError(
            "context and pipeline parallelism (the 'context' and 'pipe' axes) are "
            "not in the port yet (ROADMAP A8b)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    backend = dist.get_backend()
    want = "nccl" if device == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"a mesh on {device} needs the {want} backend, the process "
                           f"group has {backend}")
    n = dist.get_world_size()
    if data == -1:
        assert n % model == 0, f"{n} devices not divisible by model={model}"
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    from torch.distributed.device_mesh import init_device_mesh

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
