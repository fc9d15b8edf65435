"""Port parity for Sparse3DNA's centered mode (the sketch encoder's): the
plain versions of the three kernels and the module against nuwa_tpu.

Centered windows look forward, so at t = F·HW - 1 (the sketch encoder's
length: its first token is the bos) the queries of the last frame reach the
phantom token at position t, which must be masked. Every case below is
ragged and reaches it.

  * the plain query-side and key-side backward, run through
    ``sparse_3dna(mode="centered")``, against ``torch.autograd`` of
    ``sparse_3dna_fwd_plain(mode="centered")``, fp64 inputs (the plain versions
    compute in fp32): within 1e-5 of each gradient's max abs;
  * ``Sparse3DNA(causal=False)``'s output (atol 1e-5) and its gradients for
    x and every parameter (within 1e-5 of each reference's max abs) against
    the JAX module (``causal=False``) on its dense path and on the Pallas
    kernels in interpret mode, with their score cache widened to fp32.
The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nuwa_tpu.nda import Sparse3DNA as JSparse3DNA
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.kernels import nda as knda
from nuwa_tpu_torch.nda import Sparse3DNA, build_nda_indices

torch.set_num_threads(1)
REL = 1e-5
DIM, HEADS, DIM_HEAD = 16, 2, 8


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _reaches_phantom(t, fmap, kernel, dilation):
    """Whether some query's centered window, in the grid, holds token t."""
    frames = -(-t // (fmap[0] * fmap[1]))
    idx, valid = build_nda_indices((frames, *fmap), kernel, dilation, ("centered",) * 3)
    return bool((valid[:t] & (idx[:t] == t)).any())


# (fmap, kernel, dilation, t, bias): t one short of whole frames
@pytest.mark.parametrize("fmap,kernel,dilation,t,bias", [
    ((4, 4), (3, 3, 3), (1, 1, 1), 47, True),
    ((3, 4), (5, 3, 3), (2, 1, 2), 35, False),
])
def test_plain_backward_matches_autograd(fmap, kernel, dilation, t, bias):
    assert _reaches_phantom(t, fmap, kernel, dilation)
    b, h, d, kn = 2, 3, 5, kernel[0] * kernel[1] * kernel[2]
    ins = [torch.tensor(_rnd(b, h, t, d, seed=i), requires_grad=True) for i in range(3)]
    ins += [torch.tensor(_rnd(b, h, 1, d, seed=3 + i), requires_grad=True) for i in range(2)]
    ins.append(torch.tensor(_rnd(h, h, seed=5), requires_grad=True))
    rel = torch.tensor(_rnd(h, kn, seed=6), requires_grad=True) if bias else None
    geo = dict(fmap=fmap, kernel=kernel, dilation=dilation, mode="centered")
    grad = torch.tensor(_rnd(b, h, t, d, seed=7))
    leaves = ins + ([rel] if bias else [])
    out, _ = knda.sparse_3dna_fwd_plain(*ins, rel, **geo)
    want = torch.autograd.grad(out, leaves, grad)
    got = torch.autograd.grad(knda.sparse_3dna(*ins, rel, **geo), leaves, grad)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=REL * max(1.0, w.abs().max().item()), rtol=0)


def _pair(fmap, kernel, dilation, bias, frames, seed=0):
    kw = dict(dim=DIM, video_shape=(frames, fmap, fmap), kernel_size=kernel,
              dilation=dilation, heads=HEADS, dim_head=DIM_HEAD, rel_pos_bias=bias,
              causal=False)
    jmod = JSparse3DNA(**kw)
    p = jmod.init(jax.random.PRNGKey(seed))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    tmod = load_jax_params(Sparse3DNA(**kw), jax.tree.map(np.asarray, p))
    return jmod, p, tmod


def _check(jmod, p, tmod, t, seed):
    x = _rnd(2, 1 + t, DIM, seed=seed).astype(np.float32)
    w = _rnd(2, 1 + t, DIM, seed=seed + 1).astype(np.float32)
    run = jax.jit(jax.value_and_grad(lambda p, x: (jnp.sum(jmod(p, x) * w), jmod(p, x)),
                                     argnums=(0, 1), has_aux=True))
    (_, want), (jgrads, jgx) = run(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    ref = flatten_params(jax.tree.map(np.asarray, jgrads))
    got = {jax_path(tmod, n): q.grad.numpy() for n, q in tmod.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, g, r in [("x", xt.grad.numpy(), np.asarray(jgx)),
                       *((n, got[n], r) for n, r in ref.items())]:
        np.testing.assert_allclose(g, r, atol=REL * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=name)


# (fmap, kernel, dilation, frames, bias): t = frames * HW - 1
@pytest.mark.parametrize("fmap,kernel,dilation,frames,bias", [
    (4, 3, 1, 3, True),
    (4, (5, 3, 3), 2, 2, False),
])
def test_centered_sparse3dna_matches_jax_dense(fmap, kernel, dilation, frames, bias):
    jmod, p, tmod = _pair(fmap, kernel, dilation, bias, frames)
    t = frames * fmap * fmap - 1
    assert _reaches_phantom(t, (fmap, fmap), tmod.kernel, tmod.dilations)
    _check(jmod, p, tmod, t, seed=1)


def test_centered_sparse3dna_matches_pallas_interpret(monkeypatch):
    import nuwa_tpu.kernels.nda_pallas as K

    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    K._VJP_CACHE.clear()
    try:
        jmod, p, tmod = _pair(4, 3, 2, True, frames=2)
        with pltpu.force_tpu_interpret_mode():
            _check(jmod.replace(use_pallas=True), p, tmod, 31, seed=3)
    finally:
        K._VJP_CACHE.clear()
