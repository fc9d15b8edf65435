"""Port parity for attention dropout in the SparseCross2DNA kernels'
functions, against nuwa_tpu on the CPU, fp32, the same numpy inputs and
parameters.

  * ``kernels.cross.sparse_cross_2dna`` with ``dropout=(rate, seed)`` against
    the fused Pallas kernels (``sparse_cross_2dna_pallas_vjp`` with
    ``seed=[s]``: ``_xfused1_kernel`` at one context frame, ``_xfused_kernel``
    at two, ``_xfused_bwd_kernel`` for the gradients) in interpret mode, the
    kernels' score cache widened to fp32: output and the gradients of q, k,
    v, the null key and value and the talking heads. Every case has a ragged
    last query frame and a context mask that leaves some tokens of row 0 out
    and all of row 1; one case runs the backward in more than one chunk of
    query frames (``CF = max(1, 1024 // (HW * Fc))`` at nda_pallas.py:3115
    is 2 at fmap 16 and two context frames, against three query frames), so
    its query ids are offset per chunk; one case drops at rate 0.5;
  * ``SparseCross2DNA(dropout=0.1).forward(seed=s)`` against the JAX module
    on its fused path (``use_pallas=True``) with a key whose ``randint``
    draws s, as the module draws its seed (nuwa_tpu/nda.py:1087-1090): the
    output and the gradients of x, the context and every parameter (the
    bos query's attention is not dropped in either);
  * a rate of 0, or no seed, is the output without dropout bit for bit;
  * the share of the valid pairs' mixed probabilities that the mask drops is
    within 3 binomial standard deviations of the rate.
The JAX module's CPU gather path draws ``jax.random`` bits instead
(nuwa_tpu/nda.py:1154), which no other path reproduces (ROADMAP.md C3).
Tolerances: within 1e-5 of each reference's max abs (at least 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nuwa_tpu.kernels.nda_pallas as K
from nuwa_tpu.nda import SparseCross2DNA as JSparseCross2DNA
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.kernels import cross as kcross
from nuwa_tpu_torch.nda import SparseCross2DNA

torch.set_num_threads(1)
REL, RATE, SEED = 1e-5, 0.1, 987654321
DIM, HEADS, DIM_HEAD = 16, 2, 8
TH = np.array([[0.3, 1.2], [-0.8, 0.5]], np.float32)  # couples the heads


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, err_msg=name,
                               atol=REL * max(1.0, np.abs(want).max()))


def _mask(lc, seed):
    """Row 0 leaves out some context tokens, row 1 all of them."""
    return np.stack([np.random.default_rng(seed).random(lc) < 0.7, np.zeros(lc, bool)])


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels in interpret mode with an fp32 score cache."""
    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    K._VJP_CACHE.clear()
    with pltpu.force_tpu_interpret_mode():
        yield
    K._VJP_CACHE.clear()


# (context frames, fmap, video queries, dilation, rate): Fc = 1 and 2, each
# ragged; the last one runs the fused backward in two chunks of query frames
OP_CASES = [(1, 4, 37, 1, RATE), (2, 4, 37, 2, 0.5), (2, 16, 612, 1, RATE)]


@pytest.mark.parametrize("frames,fmap,t,dilation,rate", OP_CASES)
def test_op_matches_fused_pallas_kernels(interpret, frames, fmap, t, dilation, rate):
    b, h, d, lc = 2, HEADS, DIM_HEAD, frames * fmap * fmap
    ins = [_rnd(b, h, t, d, seed=0) * d**-0.5, _rnd(b, h, lc, d, seed=1),
           _rnd(b, h, lc, d, seed=2), _rnd(b, h, 1, d, seed=3), _rnd(b, h, 1, d, seed=4)]
    mask, g = _mask(lc, 5), _rnd(b, h, t, d, seed=6)
    jmod = JSparseCross2DNA(dim=DIM, image_size=fmap, heads=h, dim_head=d, dropout=rate,
                            kernel_size=3, dilation=dilation)
    op = K.sparse_cross_2dna_pallas_vjp(jmod, t, lc)
    seed = jnp.array([SEED], jnp.int32)

    def run(th, q, k, v, nk, nv):
        return op({"talking_heads": th}, q, k, v, nk, nv, cmask=jnp.asarray(mask), seed=seed)

    want, vjp = jax.jit(lambda *a: jax.vjp(run, *a))(TH, *ins)
    want_grads = vjp(jnp.asarray(g))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (TH, *ins)]
    out = kcross.sparse_cross_2dna(*leaves[1:], leaves[0], torch.from_numpy(mask),
                                   fmap=fmap, kernel_size=3, dilation=dilation,
                                   dropout=(rate, SEED))
    _close(out.detach().numpy(), want, "out")
    out.backward(torch.from_numpy(g))
    for name, leaf, w in zip(("dth", "dq", "dk", "dv", "dnull_k", "dnull_v"), leaves,
                             want_grads):
        _close(leaf.grad.numpy(), w, name)


def _seed_of(key):
    """The int seed the JAX SparseCross2DNA module draws from ``key``."""
    return int(jax.random.randint(key, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])


def test_module_matches_jax_fused_path(interpret):
    """Two context frames, dilation 2, a ragged last query frame."""
    fmap, frames, t = 4, 2, 37
    kw = dict(dim=DIM, image_size=fmap, heads=HEADS, dim_head=DIM_HEAD, kernel_size=3,
              dilation=2, dropout=RATE)
    jmod = JSparseCross2DNA(use_pallas=True, **kw)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    params["talking_heads"] = TH
    tmod = load_jax_params(SparseCross2DNA(**kw), params)
    lc = frames * fmap * fmap
    x, ctx, w = _rnd(2, 1 + t, DIM, seed=1), _rnd(2, lc, DIM, seed=2), _rnd(2, 1 + t, DIM, seed=3)
    mask, key = _mask(lc, 4), jax.random.PRNGKey(7)

    def loss(p, x, c):
        out = jmod(p, x, context=c, context_mask=jnp.asarray(mask), key=key)
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, x, ctx)
    xt, ct = torch.from_numpy(x).requires_grad_(), torch.from_numpy(ctx).requires_grad_()
    out = tmod(xt, context=ct, context_mask=torch.from_numpy(mask), seed=_seed_of(key))
    _close(out.detach().numpy(), want, "out")
    (out * torch.from_numpy(w)).sum().backward()
    jgrads, jgx, jgc = grads
    _close(xt.grad.numpy(), jgx, "x")
    _close(ct.grad.numpy(), jgc, "context")
    ref = flatten_params(jax.tree.map(np.asarray, jgrads))
    got = {jax_path(tmod, n): p.grad.numpy() for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        _close(got[name], r, name)


def _op_inputs(b=2, h=4, t=5 * 64 - 3, frames=2, fmap=8):
    lc = frames * fmap * fmap
    ins = [torch.from_numpy(_rnd(b, h, n, DIM_HEAD, seed=i)) for i, n in
           enumerate((t, lc, lc, 1, 1))]
    th = torch.from_numpy(_rnd(h, h, seed=5))
    return ins, th, torch.from_numpy(_mask(lc, 6)), dict(fmap=fmap, kernel_size=3, dilation=1)


def test_rate_zero_and_no_seed_are_no_dropout():
    ins, th, mask, geo = _op_inputs()
    want = kcross.sparse_cross_2dna(*ins, th, mask, **geo)
    for drop in ((0.0, SEED), (RATE, None), None):
        assert torch.equal(kcross.sparse_cross_2dna(*ins, th, mask, dropout=drop, **geo), want)
    assert not torch.equal(kcross.sparse_cross_2dna(*ins, th, mask, dropout=(RATE, SEED), **geo),
                           want)


def test_dropped_share_is_the_rate():
    """Of the mixed probabilities the backward returns (the null column's
    and every slot's a mask allows), the share that dropout zeroes."""
    ins, th, mask, geo = _op_inputs()
    out, lse = kcross.sparse_cross_2dna_fwd(*ins, th, mask, **geo)
    g = torch.ones_like(out)
    mix = kcross.sparse_cross_2dna_bwd_q(*ins, th, mask, g, lse, **geo)[2]
    dropped = kcross.sparse_cross_2dna_bwd_q(*ins, th, mask, g, lse, dropout=(RATE, SEED),
                                             **geo)[2]
    valid = mix != 0
    n = valid.sum().item()
    share = ((dropped == 0) & valid).sum().item() / n
    assert abs(share - RATE) <= 3 * (RATE * (1 - RATE) / n) ** 0.5, (share, n)
    kept = valid & (dropped != 0)
    torch.testing.assert_close(dropped[kept], mix[kept] / (1 - RATE), rtol=1e-6, atol=0)
