"""Port parity for the SparseCross2DNA backward: the autograd function
around the kernels (on the CPU, their plain versions) against autograd and
JAX.

  * the plain backward (``sparse_cross_2dna_bwd_plain``: the query side and
    then the key side) against ``torch.autograd`` of
    ``sparse_cross_2dna_fwd_plain``, fp64 inputs (the plain versions compute
    in fp32): within 1e-5 of each gradient's max abs;
  * ``SparseCross2DNA``'s gradients for x, the context and every parameter
    (projections, null key and value, talking heads) against ``jax.grad`` of
    the JAX module on three paths, fp32, each within 1e-5 of the reference's
    max abs (sums taken in another order): the gather path; the fused
    Pallas backward ``_xfused_bwd_kernel`` in interpret mode with the score
    cache widened to fp32, at one and two context frames; and the per-frame
    fallback ``_cross_core_op`` with ``xfused_ok`` patched to refuse.
Every case has a context mask with some tokens of row 0 masked and all of
row 1 (the unconditional half of a CFG batch), and a ragged last query
frame. The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nuwa_tpu.nda import SparseCross2DNA as JSparseCross2DNA
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.kernels import cross as kcross
from nuwa_tpu_torch.nda import SparseCross2DNA

torch.set_num_threads(1)
REL = 1e-5
DIM, HEADS, DIM_HEAD, FMAP = 16, 2, 8, 4
HW = FMAP * FMAP


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("frames,t,fmap,dilation", [
    (1, 37, 4, 1), (2, 48, 4, 2), (3, 20, 3, 1), (2, 1, 4, 1),
])
def test_plain_backward_matches_autograd(frames, t, fmap, dilation):
    b, h, d, lc = 2, 3, 5, frames * fmap * fmap
    ins = [torch.tensor(_rnd(b, h, t, d, seed=0), requires_grad=True)]
    ins += [torch.tensor(_rnd(b, h, lc, d, seed=1 + i), requires_grad=True) for i in range(2)]
    ins += [torch.tensor(_rnd(b, h, 1, d, seed=3 + i), requires_grad=True) for i in range(2)]
    ins.append(torch.tensor(_rnd(h, h, seed=5), requires_grad=True))
    mask = torch.from_numpy(np.stack([np.random.default_rng(6).random(lc) < 0.6,
                                      np.zeros(lc, bool)]))
    grad = torch.tensor(_rnd(b, h, t, d, seed=7))
    geo = dict(fmap=fmap, kernel_size=3, dilation=dilation)
    out, lse = kcross.sparse_cross_2dna_fwd_plain(*ins, mask, **geo)
    want = torch.autograd.grad(out, ins, grad)
    got = kcross.sparse_cross_2dna_bwd_plain(*(x.detach() for x in ins), mask, grad,
                                             lse.detach(), **geo)
    for g, w in zip(got, want):  # dnull_k, dnull_v and dth come back in fp32
        assert g.shape == w.shape
        torch.testing.assert_close(g.to(w.dtype), w, atol=REL * max(1.0, w.abs().max().item()),
                                   rtol=0)


def _pair(dilation, seed=0):
    kw = dict(dim=DIM, image_size=FMAP, heads=HEADS, dim_head=DIM_HEAD, kernel_size=3,
              dilation=dilation)
    jmod = JSparseCross2DNA(backend="gather", **kw)
    p = jmod.init(jax.random.PRNGKey(seed))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    p = jax.tree.map(np.asarray, p)
    return jmod, p, load_jax_params(SparseCross2DNA(**kw), p)


def _inputs(t, frames, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1 + t, DIM)).astype(np.float32)
    ctx = rng.standard_normal((2, frames * HW, DIM)).astype(np.float32)
    mask = np.stack([rng.random(frames * HW) < 0.6, np.zeros(frames * HW, bool)])
    w = rng.standard_normal((2, 1 + t, DIM)).astype(np.float32)
    return x, ctx, mask, w


def _jax_grads(jmod, p, x, ctx, mask, w):
    def loss(p, x, c):
        return jnp.sum(jmod(p, x, context=c, context_mask=mask) * w)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(p, jnp.asarray(x), jnp.asarray(ctx))


def _assert_grads_match(tmod, x, ctx, mask, w, want):
    """The port's gradients of x, the context and every parameter (by JAX
    path) against JAX's, each within REL of the reference's max abs."""
    jgrads, jgx, jgctx = want
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, ctx))
    tmod.zero_grad(set_to_none=True)
    out = tmod(xt, context=ct, context_mask=torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    ref = flatten_params(jax.tree.map(np.asarray, jgrads))
    got = {jax_path(tmod, n): p.grad.numpy() for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, g, r in [("x", xt.grad.numpy(), jgx), ("context", ct.grad.numpy(), jgctx),
                       *((n, got[n], r) for n, r in ref.items())]:
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, atol=REL * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=name)


# (context frames, video tokens, dilation): ragged last frames, full frames
CASES = [(1, 37, 1), (2, 37, 2), (2, 48, 1)]


@pytest.mark.parametrize("frames,t,dilation", CASES)
def test_cross_grads_match_jax_gather(frames, t, dilation):
    jmod, p, tmod = _pair(dilation)
    x, ctx, mask, w = _inputs(t, frames)
    _assert_grads_match(tmod, x, ctx, mask, w, _jax_grads(jmod, p, x, ctx, mask, w))


@pytest.mark.parametrize("frames,t,dilation", CASES[:2])
@pytest.mark.parametrize("fused", [True, False], ids=["xfused", "per_frame"])
def test_cross_grads_match_pallas_interpret(monkeypatch, frames, t, dilation, fused):
    import nuwa_tpu.kernels.nda_pallas as K

    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    if not fused:
        monkeypatch.setattr(K, "xfused_ok", lambda *a: False)
    K._VJP_CACHE.clear()
    try:
        jmod, p, tmod = _pair(dilation)
        x, ctx, mask, w = _inputs(t, frames, seed=2)
        with pltpu.force_tpu_interpret_mode():
            want = _jax_grads(jmod.replace(use_pallas=True), p, x, ctx, mask, w)
        _assert_grads_match(tmod, x, ctx, mask, w, want)
    finally:
        K._VJP_CACHE.clear()


def test_launch_counts_stay_zero_on_the_cpu():
    """The CPU path runs the plain versions: no kernel is counted."""
    fns = (kcross.sparse_cross_2dna_fwd, kcross.sparse_cross_2dna_bwd_q,
           kcross.sparse_cross_2dna_bwd_kv)
    before = [fn.launches for fn in fns]
    _, _, tmod = _pair(1)
    x, ctx, mask, w = _inputs(20, 2, seed=3)
    out = tmod(torch.from_numpy(x), context=torch.from_numpy(ctx).requires_grad_(),
               context_mask=torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    assert [fn.launches for fn in fns] == before


def test_backward_wrappers_refuse_other_devices():
    """No quiet fallback: a tensor on neither the CPU nor CUDA raises."""
    q = torch.empty(1, 2, 4, 8, device="meta")
    kv = torch.empty(1, 2, 16, 8, device="meta")
    nk = torch.empty(1, 2, 1, 8, device="meta")
    lse = torch.empty(1, 2, 4, device="meta")
    ds = torch.empty(1, 2, 4, 10, device="meta")
    geo = dict(fmap=4, kernel_size=3, dilation=1)
    with pytest.raises(ValueError):
        kcross.sparse_cross_2dna_bwd_q(q, kv, kv, nk, nk, torch.eye(2), None, q, lse, **geo)
    with pytest.raises(ValueError):
        kcross.sparse_cross_2dna_bwd_kv(q, q, ds, ds, **geo)
