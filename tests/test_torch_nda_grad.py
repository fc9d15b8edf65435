"""Port parity for the Sparse3DNA backward: the autograd function around the
kernels (on the CPU, their plain versions) against autograd and JAX.

  * the plain query-side and key-side backward (``sparse_3dna_bwd_q_plain``,
    ``sparse_3dna_bwd_kv_plain``, run through ``sparse_3dna``) against
    ``torch.autograd`` of ``sparse_3dna_fwd_plain``, fp64 inputs (the plain
    versions compute in fp32): atol 1e-5;
  * ``Sparse3DNA``'s gradients for x and every parameter (projections, the
    axial rel-pos tables, talking heads) against ``jax.grad`` of the JAX
    module's dense path, fp32: within 1e-5 of each gradient's max abs (sums
    taken in another order);
  * one case against the Pallas backward in interpret mode (fmap 4, 2 frames)
    with the kernel's score cache widened to fp32, as
    tests/test_pallas_nda.py pins it: the same tolerance.
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
from nuwa_tpu_torch.nda import Sparse3DNA

torch.set_num_threads(1)
REL = 1e-5
DIM, HEADS, DIM_HEAD = 16, 2, 8


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


# (fmap, kernel, dilation, t, bias): ragged frames, one token, anisotropic
@pytest.mark.parametrize("fmap,kernel,dilation,t,bias", [
    ((4, 4), (3, 3, 3), (1, 1, 1), 47, True),
    ((3, 4), (5, 3, 3), (2, 1, 2), 60, False),
    ((4, 4), (3, 5, 3), (1, 2, 1), 1, True),
    ((2, 3), (3, 3, 3), (2, 2, 1), 13, True),
])
def test_plain_backward_matches_autograd(fmap, kernel, dilation, t, bias):
    b, h, d, kn = 2, 3, 5, kernel[0] * kernel[1] * kernel[2]
    ins = [torch.tensor(_rnd(b, h, t, d, seed=i), requires_grad=True) for i in range(3)]
    ins += [torch.tensor(_rnd(b, h, 1, d, seed=3 + i), requires_grad=True) for i in range(2)]
    ins.append(torch.tensor(_rnd(h, h, seed=5), requires_grad=True))
    rel = torch.tensor(_rnd(h, kn, seed=6), requires_grad=True) if bias else None
    geo = dict(fmap=fmap, kernel=kernel, dilation=dilation)
    grad = torch.tensor(_rnd(b, h, t, d, seed=7))
    leaves = ins + ([rel] if bias else [])
    out, _ = knda.sparse_3dna_fwd_plain(*ins, rel, **geo)
    want = torch.autograd.grad(out, leaves, grad)
    got = torch.autograd.grad(knda.sparse_3dna(*ins, rel, **geo), leaves, grad)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def _pair(fmap, kernel, dilation, bias, frames=3, seed=0):
    kw = dict(dim=DIM, video_shape=(frames, fmap, fmap), kernel_size=kernel,
              dilation=dilation, heads=HEADS, dim_head=DIM_HEAD, rel_pos_bias=bias)
    jmod = JSparse3DNA(causal=True, **kw)
    p = jmod.init(jax.random.PRNGKey(seed))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    tmod = load_jax_params(Sparse3DNA(causal=True, **kw), jax.tree.map(np.asarray, p))
    return jmod, p, tmod


def _assert_grads_match(tmod, x, gx, jgrads, jgx):
    """Port gradients (x and every parameter, by JAX path) against JAX's,
    each within REL of the reference's max abs."""
    want = flatten_params(jax.tree.map(np.asarray, jgrads))
    got = {jax_path(tmod, n): p.grad.numpy() for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in [("x", np.asarray(jgx)), *want.items()]:
        g = gx if name == "x" else got[name]
        np.testing.assert_allclose(g, w, atol=REL * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=name)


def _port_grads(tmod, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    (tmod(xt) * torch.from_numpy(w)).sum().backward()
    return xt.grad.numpy()


# (fmap, kernel, dilation, t, bias): a ragged last frame, t = 1, full frames
DENSE_CASES = [
    (4, 3, 1, 47, True),
    (4, (5, 3, 3), 2, 40, False),
    (8, 3, 2, 1, True),
    (8, (5, 3, 3), 1, 128, True),
]


@pytest.fixture(scope="module")
def dense_refs():
    """Every case's module pair, inputs and JAX gradients, the references
    taken by one jitted ``jax.grad`` over the sum of the cases' losses (one
    trace and one compile for the file)."""
    cases = []
    for fmap, kernel, dilation, t, bias in DENSE_CASES:
        jmod, p, tmod = _pair(fmap, kernel, dilation, bias)
        x = _rnd(2, 1 + t, DIM, seed=1).astype(np.float32)
        w = _rnd(2, 1 + t, DIM, seed=2).astype(np.float32)
        cases.append((jmod, p, tmod, x, w))

    def loss(ps, xs):
        return sum(jnp.sum(jmod(p, x) * w)
                   for (jmod, *_, w), p, x in zip(cases, ps, xs))

    jgrads, jgxs = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        [c[1] for c in cases], [jnp.asarray(c[3]) for c in cases]
    )
    return {case: (tmod, x, w, jg, jgx)
            for case, (_, _, tmod, x, w), jg, jgx in zip(DENSE_CASES, cases, jgrads, jgxs)}


@pytest.mark.parametrize("fmap,kernel,dilation,t,bias", DENSE_CASES)
def test_sparse3dna_grads_match_jax_dense(dense_refs, fmap, kernel, dilation, t, bias):
    tmod, x, w, jgrads, jgx = dense_refs[fmap, kernel, dilation, t, bias]
    gx = _port_grads(tmod, x, w)
    _assert_grads_match(tmod, x, gx, jgrads, jgx)


def test_sparse3dna_grads_match_pallas_interpret(monkeypatch):
    import nuwa_tpu.kernels.nda_pallas as K

    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    K._VJP_CACHE.clear()
    try:
        jmod, p, tmod = _pair(4, 3, 2, True, frames=2)
        jmod = jmod.replace(use_pallas=True)
        t = 29  # a ragged second frame
        x, w = _rnd(1, 1 + t, DIM, seed=3).astype(np.float32), _rnd(1, 1 + t, DIM, seed=4).astype(np.float32)
        loss = jax.jit(jax.grad(lambda p, x: jnp.sum(jmod(p, x) * w), argnums=(0, 1)))
        with pltpu.force_tpu_interpret_mode():
            jgrads, jgx = loss(p, jnp.asarray(x))
        gx = _port_grads(tmod, x, w)
        _assert_grads_match(tmod, x, gx, jgrads, jgx)
    finally:
        K._VJP_CACHE.clear()


def test_launch_counts_stay_zero_on_the_cpu():
    """The CPU path runs the plain versions: no kernel is counted."""
    before = (knda.sparse_3dna_fwd.launches, knda.sparse_3dna_bwd_q.launches,
              knda.sparse_3dna_bwd_kv.launches)
    _, _, tmod = _pair(4, 3, 1, True)
    x = _rnd(1, 1 + 20, DIM).astype(np.float32)
    _port_grads(tmod, x, x)
    assert (knda.sparse_3dna_fwd.launches, knda.sparse_3dna_bwd_q.launches,
            knda.sparse_3dna_bwd_kv.launches) == before


def test_backward_wrappers_refuse_other_devices():
    """No quiet fallback: a tensor on neither the CPU nor CUDA raises."""
    q = torch.empty(1, 2, 4, 8, device="meta")
    kb = torch.empty(1, 2, 1, 8, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    ds = torch.empty(1, 2, 4, 28, device="meta")
    geo = dict(fmap=(2, 2), kernel=(3, 3, 3), dilation=(1, 1, 1))
    with pytest.raises(ValueError):
        knda.sparse_3dna_bwd_q(q, q, q, kb, kb, torch.eye(2), None, q, lse, **geo)
    with pytest.raises(ValueError):
        knda.sparse_3dna_bwd_kv(q, q, ds, ds, **geo)
