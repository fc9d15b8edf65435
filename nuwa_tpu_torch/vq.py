"""Vector quantizer, inference half.

Counterpart of ``VectorQuantizeEMA`` in ``nuwa_tpu/vq.py`` with
``update=False``: the optional lower-dim codebook projection
(``project_in`` / ``project_out``), the cosine-similarity argmax or the
euclidean argmin, the commitment loss (plus the orthogonal penalty when it
is on), and the straight-through output in input space. The codebook state
(``embed``, ``embed_avg``, ``cluster_size``, ``initted``) lives in buffers,
loaded from the JAX package's ``state["vq"]``; only ``embed`` is read here.
The EMA update, k-means init and dead-code expiry belong to the codec's
training.
"""
from __future__ import annotations

import torch
from torch import nn

from .core.layers import Dense


def l2norm(t, eps=1e-12):
    return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + eps)


class VectorQuantizeEMA(nn.Module):
    def __init__(self, dim, codebook_size, codebook_dim=None, commitment_weight=1.0,
                 kmeans_init=True, cosine_sim=True, orthogonal_reg_weight=0.0):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.cdim = codebook_dim if codebook_dim is not None else dim
        self.commitment_weight = commitment_weight
        self.kmeans_init = kmeans_init
        self.cosine_sim = cosine_sim
        self.orthogonal_reg_weight = orthogonal_reg_weight
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

    def forward(self, x):
        """Quantize ``x`` (..., dim). Returns (quantized (..., dim), indices
        (...), commit loss)."""
        flat = x.reshape(-1, self.dim)
        z = self._project_in(flat)
        embed = self.embed
        if self.cosine_sim:
            indices = (l2norm(z) @ embed.T).argmax(dim=-1)
        else:
            dist = ((z * z).sum(-1, keepdim=True) - 2 * z @ embed.T
                    + (embed * embed).sum(-1)[None])
            indices = dist.argmin(dim=-1)
        codes = embed[indices]
        commit = self.commitment_weight * ((codes.detach() - z) ** 2).mean()
        if self.orthogonal_reg_weight > 0:
            cb = l2norm(embed)
            gram = cb @ cb.T
            commit = commit + self.orthogonal_reg_weight * (
                (gram**2).sum() - (gram.diagonal() ** 2).sum()
            ) / self.codebook_size**2
        quantized = flat + (self._project_out(codes) - flat).detach()
        return quantized.reshape(x.shape), indices.reshape(x.shape[:-1]), commit
