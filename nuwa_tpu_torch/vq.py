"""EMA vector quantizer.

Counterpart of ``VectorQuantizeEMA`` in ``nuwa_tpu/vq.py``: the optional
lower-dim codebook projection (``project_in`` / ``project_out``), the
cosine-similarity argmax or the euclidean argmin, the commitment loss (plus
the orthogonal penalty when it is on), and the straight-through output in
input space. With ``update=True`` (the codec's training) it also runs the
k-means init of the first update (once: the ``initted`` flag), the EMA of
``cluster_size`` and ``embed_avg`` with Laplace smoothing, and the dead-code
expiry, as the JAX package does.

The codebook state (``embed``, ``embed_avg``, ``cluster_size``,
``initted``) lives in buffers, the JAX package's ``state["vq"]``; an update
writes them in place, where the JAX package returns a new state. The random
draws (k-means' starting points, the vectors that re-seed dead codes) come
from a ``torch.Generator`` (``draw``), not from ``jax.random``, so they are
not the JAX package's bits; the tests inject JAX's draws through ``draw``.

Across ranks an update takes one of two semantics. ``axis_name`` (a
process group, or a one-axis device mesh such as ``mesh["data"]``) is the
JAX package's ``shard_map`` one: the counts and sums are all-reduced over
it, the k-means start is each rank's own, and the dead-code seeds are rank
0's picks from its rows, broadcast. ``batch_group`` is pjit's global batch,
which the data-parallel trainers use: x is this rank's equal share of a
batch split in rank order over the group, the statistics are the global
batch's, k-means runs on the gathered batch, and the dead-code picks are
drawn over the global batch's rows (every rank draws the same indices and
contributes the rows it holds), so every rank's codebook is the one
process's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .core.layers import Dense


def l2norm(t, eps=1e-12):
    return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + eps)


def _group(axis):
    """The process group of ``axis``: a group, or a one-axis device mesh."""
    if isinstance(axis, str):
        raise TypeError(f"axis_name takes a process group or a one-axis device mesh, not the "
                        f"name {axis!r}")
    return axis.get_group() if hasattr(axis, "get_group") else axis


def _all_reduce(x, group):
    dist.all_reduce(x, group=group)
    return x


def _kmeans(data, means, num_clusters, iters):
    """k-means from the starting ``means`` (C, d): nearest centroid by
    argmax of 2·x·m − ‖m‖², the old mean kept for an empty cluster."""
    for _ in range(iters):
        sim = 2.0 * (data @ means.T) - (means * means).sum(-1)[None]
        onehot = F.one_hot(sim.argmax(dim=-1), num_clusters).to(data.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ data) / counts.clamp_min(1.0)[:, None]
        means = torch.where(counts[:, None] > 0, new, means)
    return means


class VectorQuantizeEMA(nn.Module):
    def __init__(self, dim, codebook_size, codebook_dim=None, decay=0.8,
                 commitment_weight=1.0, kmeans_init=True, kmeans_iters=10, cosine_sim=True,
                 eps=1e-5, orthogonal_reg_weight=0.0, threshold_ema_dead_code=0.0):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.cdim = codebook_dim if codebook_dim is not None else dim
        self.decay, self.eps = decay, eps
        self.commitment_weight = commitment_weight
        self.kmeans_init, self.kmeans_iters = kmeans_init, kmeans_iters
        self.cosine_sim = cosine_sim
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.threshold_ema_dead_code = threshold_ema_dead_code
        if self.cdim != dim:
            self.project_in = Dense(dim, self.cdim, use_bias=True)
            self.project_out = Dense(self.cdim, dim, use_bias=True)
        else:
            self.project_in = self.project_out = None
        self.register_buffer("embed", torch.empty(codebook_size, self.cdim))
        self.register_buffer("embed_avg", torch.empty(codebook_size, self.cdim))
        self.register_buffer("cluster_size", torch.empty(codebook_size))
        self.register_buffer("initted", torch.empty(()))

    @torch.no_grad()
    def reset_parameters(self, generator):
        embed = torch.randn(self.embed.shape, generator=generator)
        if self.cosine_sim:
            embed = l2norm(embed)
        self.embed.copy_(embed)
        self.embed_avg.copy_(embed)
        self.cluster_size.zero_()
        self.initted.fill_(0.0 if self.kmeans_init else 1.0)

    def _project_in(self, x):
        return self.project_in(x) if self.project_in is not None else x

    def _project_out(self, x):
        return self.project_out(x) if self.project_out is not None else x

    def codebook(self):
        """The codebook in decoder space (``project_out`` applied)."""
        return self._project_out(self.embed)

    def codebook_usage(self, threshold=None):
        """Share of the codes whose EMA cluster size is above ``threshold``
        (default: ``threshold_ema_dead_code`` when it is on, else ``eps``)."""
        if threshold is None:
            threshold = self.threshold_ema_dead_code or self.eps
        return (self.cluster_size > threshold).float().mean()

    def draw(self, high, generator, what):
        """``codebook_size`` ints in [0, high), from ``generator`` (a CPU
        generator; a fresh one seeded 0 when None, as the JAX package takes
        ``PRNGKey(0)`` without a key). ``what`` is ``"kmeans"`` or
        ``"dead_code"``."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return torch.randint(high, (self.codebook_size,), generator=generator)

    @torch.no_grad()
    def _update(self, zq, indices, generator, axis=None, batch=None):
        """The EMA of cluster sizes and sums, Laplace smoothing, and the
        dead-code expiry, written into the buffers; ``axis`` / ``batch``
        the process group of ``forward``'s ``axis_name`` / ``batch_group``."""
        onehot = F.one_hot(indices, self.codebook_size).to(zq.dtype)
        counts, sums = onehot.sum(0), onehot.T @ zq
        group = axis if axis is not None else batch
        if group is not None:
            counts, sums = _all_reduce(counts, group), _all_reduce(sums, group)
        d = self.decay
        cluster_size = self.cluster_size * d + counts * (1 - d)
        embed_avg = self.embed_avg * d + sums * (1 - d)
        n = cluster_size.sum()
        smoothed = (cluster_size + self.eps) / (n + self.codebook_size * self.eps) * n
        embed = embed_avg / smoothed.clamp_min(1e-12)[:, None]
        if self.cosine_sim:
            embed = l2norm(embed)
        thr = self.threshold_ema_dead_code
        if thr > 0:
            if batch is not None:  # picks over the global batch's rows
                n = zq.shape[0]
                start = dist.get_rank(batch) * n
                pick = self.draw(n * dist.get_world_size(batch), generator,
                                 "dead_code").to(zq.device) - start
                mine = (pick >= 0) & (pick < n)
                seeds = _all_reduce(torch.where(mine[:, None], zq[pick.clamp(0, n - 1)], 0.0),
                                    batch)
            else:
                seeds = zq[self.draw(zq.shape[0], generator, "dead_code").to(zq.device)]
                if axis is not None:  # rank 0's picks
                    dist.broadcast(seeds, src=dist.get_global_rank(axis, 0), group=axis)
            dead = (cluster_size < thr)[:, None]
            embed = torch.where(dead, seeds, embed)
            embed_avg = torch.where(dead, seeds * thr, embed_avg)
            cluster_size = torch.where(dead[:, 0], thr, cluster_size)
        self.embed.copy_(embed)
        self.embed_avg.copy_(embed_avg)
        self.cluster_size.copy_(cluster_size)

    def forward(self, x, *, update=False, generator=None, axis_name=None, batch_group=None):
        """Quantize ``x`` (..., dim). Returns (quantized (..., dim), indices
        (...), commit loss). ``update=True`` runs the k-means init (first
        call) and the EMA update on the buffers, over the ranks of
        ``axis_name`` or ``batch_group`` (the module's docstring)."""
        if axis_name is not None and batch_group is not None:
            raise ValueError("axis_name and batch_group exclude each other")
        axis = _group(axis_name) if axis_name is not None else None
        batch = _group(batch_group) if batch_group is not None else None
        flat = x.reshape(-1, self.dim)
        z = self._project_in(flat)
        zq = l2norm(z) if self.cosine_sim else z
        if update and self.kmeans_init and not self.initted.item():
            with torch.no_grad():
                data = zq.detach()
                if batch is not None:  # the global batch, in rank order
                    parts = [torch.empty_like(data) for _ in range(dist.get_world_size(batch))]
                    dist.all_gather(parts, data.contiguous(), group=batch)
                    data = torch.cat(parts)
                start = data[self.draw(data.shape[0], generator, "kmeans").to(data.device)]
                means = _kmeans(data, start, self.codebook_size, self.kmeans_iters)
                if self.cosine_sim:
                    means = l2norm(means)
                self.embed.copy_(means)
                self.embed_avg.copy_(means)
                self.cluster_size.zero_()
                self.initted.fill_(1.0)
        embed = self.embed
        with torch.no_grad():
            if self.cosine_sim:
                indices = (zq @ embed.T).argmax(dim=-1)
            else:
                distance = ((z * z).sum(-1, keepdim=True) - 2 * z @ embed.T
                        + (embed * embed).sum(-1)[None])
                indices = distance.argmin(dim=-1)
        codes = embed[indices]
        commit = self.commitment_weight * ((codes - z) ** 2).mean()
        if self.orthogonal_reg_weight > 0:
            cb = l2norm(embed)
            gram = cb @ cb.T
            commit = commit + self.orthogonal_reg_weight * (
                (gram**2).sum() - (gram.diagonal() ** 2).sum()
            ) / self.codebook_size**2
        # the straight-through output is taken from the codes before the update
        quantized = flat + (self._project_out(codes) - flat).detach()
        if update:
            self._update(zq.detach(), indices, generator, axis, batch)
        return quantized.reshape(x.shape), indices.reshape(x.shape[:-1]), commit
