"""Port parity for attention dropout in the Sparse3DNA kernels' functions,
against nuwa_tpu on the CPU, fp32, the same numpy inputs and parameters.

  * ``kernels.nda.keep_mask`` equals ``nuwa_tpu.nda._coord_keep_mask`` bit
    for bit: seeds up to 2**31 - 2, rates 0.05, 0.1, 0.5 and 0.9, 3 batch
    rows, 4 heads, the bos sentinel -2 and negative phantom ids, and one
    row and head with key 0 (the feed-forward's mask);
  * ``Sparse3DNA(dropout=0.1)`` with a seed against the JAX module with a
    key, the seed drawn from that key as the JAX module draws it
    (``nuwa_tpu/nda.py:730``): on the CPU the JAX module then runs its
    gather path with the coordinate-keyed mask. Output and the gradients of
    x and of every parameter, causal at fmap 4, centered with a phantom
    token, and causal at fmap 18 (past the 256 tokens a frame at which the
    JAX package turns to its row-blocked kernels), each with a ragged last
    frame; one jitted ``jax.value_and_grad`` gives every case's references;
  * the same against the row-blocked Pallas kernels (TPU kernels 4-6,
    ``_keep_mask_abs``) in interpret mode, 8 x 8 frames with
    ``row_block=4`` and the kernels' score cache widened to fp32: the same
    bits, since those kernels key their mask by the same absolute ids;
  * the audio geometry (SparseCausal2DNA's core) at H = 1, 3 and 4 against
    ``nuwa_tpu.nda._nda_attend`` with ``drop_ids`` over the indices
    ``build_nda_indices`` gives the JAX module (the JAX module's own gather
    path draws ``jax.random`` bits), output and every gradient;
  * a rate of 0, or no seed, is the output without dropout bit for bit;
    the dense attention's and the feed-forward's masks (which JAX draws
    from ``jax.random.bernoulli``) drop a share within 3 binomial standard
    deviations of the rate, and a recompute draws the same mask.
Tolerances: within 1e-5 of each reference's max abs (at least 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nuwa_tpu.nda import Sparse3DNA as JSparse3DNA
from nuwa_tpu.nda import _coord_keep_mask, _nda_attend, build_nda_indices
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.core.layers import dropout, init_weights_
from nuwa_tpu_torch.kernels import nda as knda
from nuwa_tpu_torch.nda import Sparse3DNA
from nuwa_tpu_torch.ops.attention import Attention
from nuwa_tpu_torch.ops.feedforward import FeedForward

torch.set_num_threads(1)
REL, RATE = 1e-5, 0.1
DIM, HEADS, DIM_HEAD = 16, 2, 8


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, err_msg=name,
                               atol=REL * max(1.0, np.abs(want).max()))


def _seed_of(key):
    """The int seed the JAX Sparse3DNA module draws from ``key``."""
    return int(jax.random.randint(key, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.5, 0.9])
def test_keep_mask_matches_coord_keep_mask(rate):
    rng = np.random.default_rng(0)
    for seed in (0, 1, 987654321, 2**31 - 2):
        q = rng.integers(0, 5000, 29)
        k = rng.integers(-7, 5000, (29, 12))
        k[:, 0] = -2  # the bos column
        want = np.asarray(_coord_keep_mask(jnp.int32(seed), 1.0 - rate, 3, 4,
                                           jnp.asarray(q), jnp.asarray(k)))
        got = knda.keep_mask(seed, rate, 3, 4, torch.from_numpy(q), torch.from_numpy(k))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        # one batch row and head, key 0 (the feed-forward's flat-index mask)
        want = np.asarray(_coord_keep_mask(jnp.int32(seed), 1.0 - rate, 1, 1, jnp.asarray(q),
                                           jnp.zeros((29, 1), jnp.int32)))
        got = knda.keep_mask(seed, rate, 1, 1, torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), want)


# (video shape, dilation, causal, tokens short of whole frames, batch)
CASES = {
    "fmap 4 causal": ((3, 4, 4), 1, True, 1, 2),
    "fmap 4 centered phantom": ((3, 4, 4), (1, 2, 1), False, 1, 2),
    "fmap 18 causal": ((2, 18, 18), 2, True, 5, 1),
}
KEY = jax.random.PRNGKey(7)


def _pair(shape, dilation, causal, **jax_options):
    kw = dict(dim=DIM, video_shape=shape, kernel_size=3, dilation=dilation, heads=HEADS,
              dim_head=DIM_HEAD, causal=causal, rel_pos_bias=True, dropout=RATE)
    jmod = JSparse3DNA(**kw).replace(**jax_options)
    p = jmod.init(jax.random.PRNGKey(0))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    return jmod, p, load_jax_params(Sparse3DNA(**kw), jax.tree.map(np.asarray, p))


def _inputs(shape, short, b):
    t = shape[0] * shape[1] * shape[2] - short
    return _rnd(b, 1 + t, DIM, seed=1), _rnd(b, 1 + t, DIM, seed=2)


@pytest.fixture(scope="module")
def gather_refs():
    """Every case's port module, inputs and JAX output and gradients, from
    one jitted ``jax.value_and_grad`` over the sum of the cases' losses."""
    cases = [(*_pair(*spec[:3]), *_inputs(spec[0], *spec[3:])) for spec in CASES.values()]

    def loss(ps, xs):
        outs = [jmod(p, x, key=KEY) for (jmod, *_), p, x in zip(cases, ps, xs)]
        return sum(jnp.sum(o * c[4]) for o, c in zip(outs, cases)), outs

    (_, outs), (jgrads, jgxs) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        [c[1] for c in cases], [jnp.asarray(c[3]) for c in cases])
    return {name: (c[2], c[3], c[4], o, g, gx)
            for name, c, o, g, gx in zip(CASES, cases, outs, jgrads, jgxs)}


def _check_module(tmod, x, w, want, jgrads, jgx):
    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(xt, seed=_seed_of(KEY))
    _close(out.detach().numpy(), want, "out")
    (out * torch.from_numpy(w)).sum().backward()
    _close(xt.grad.numpy(), jgx, "x")
    want = flatten_params(jax.tree.map(np.asarray, jgrads))
    got = {jax_path(tmod, n): p.grad.numpy() for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        _close(g, want[name], name)


@pytest.mark.parametrize("case", list(CASES))
def test_sparse3dna_dropout_matches_jax_gather_path(gather_refs, case):
    _check_module(*gather_refs[case])


def test_sparse3dna_dropout_matches_row_blocked_kernels(monkeypatch):
    """TPU kernels 4-6 in interpret mode key their mask by absolute (head,
    query, key) ids, as the port does: the same bits, 2 batch rows, a
    ragged last frame."""
    import nuwa_tpu.kernels.nda_pallas as K

    shape = (2, 8, 8)
    jmod, p, tmod = _pair(shape, 1, True, use_pallas=True, row_block=4)
    x, w = _inputs(shape, 3, 2)
    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    K._VJP_CACHE.clear()
    try:
        def loss(p, x):
            out = jmod(p, x, key=KEY)
            return jnp.sum(out * w), out

        run = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
        with pltpu.force_tpu_interpret_mode():
            (_, want), (jgrads, jgx) = run(p, jnp.asarray(x))
    finally:
        K._VJP_CACHE.clear()
    _check_module(tmod, x, w, want, jgrads, jgx)


HEIGHTS = (1, 3, 4)  # audio tokens a timestep
AUDIO_K, AUDIO_DIL, AUDIO_T = 3, 2, 13  # a ragged last timestep at H = 3 and 4


def _audio_case(height, seed):
    t, kn = AUDIO_T, AUDIO_K * height
    q, k, v = (_rnd(2, HEADS, t, DIM_HEAD, seed=seed + i) for i in range(3))
    kb, vb = (_rnd(2, HEADS, 1, DIM_HEAD, seed=seed + 3 + i) for i in range(2))
    th, bias = _rnd(HEADS, HEADS, seed=seed + 5), _rnd(HEADS, kn, seed=seed + 6)
    return (q * DIM_HEAD**-0.5, k, v, kb, vb, th, bias), _rnd(2, HEADS, t, DIM_HEAD,
                                                                 seed=seed + 7)


def _jax_audio(height, seed, args):
    """SparseCausal2DNA's attention as the JAX module computes it on its
    gather path (``nuwa_tpu/nda.py:925-950``), with the coordinate-keyed
    mask of ``drop_ids`` in place of its ``jax.random`` draw."""
    t = AUDIO_T
    timesteps = -(-t // height)
    idx, valid = build_nda_indices((timesteps, height), (AUDIO_K, height), (AUDIO_DIL, 1),
                                   ("causal", "full"))
    idx, valid = idx[:t], valid[:t] & (idx[:t] < t)
    q, k, v, kb, vb, th, bias = args
    return _nda_attend(q, k[:, :, idx], v[:, :, idx], jnp.asarray(valid), kb, vb, bias, th,
                       RATE, None, drop_ids=(seed, jnp.arange(t), jnp.asarray(idx)))


@pytest.fixture(scope="module")
def audio_refs():
    cases = [_audio_case(height, 10 * height) for height in HEIGHTS]

    def refs(args, gs):
        outs = []
        for h, a, g in zip(HEIGHTS, args, gs):
            out, vjp = jax.vjp(lambda *a, h=h: _jax_audio(h, 1000 + h, a), *a)
            outs.append((out, vjp(g)))
        return outs

    got = jax.jit(refs)([c[0] for c in cases], [c[1] for c in cases])
    return {h: (c, r) for h, c, r in zip(HEIGHTS, cases, got)}


@pytest.mark.parametrize("height", HEIGHTS)
def test_audio_dropout_matches_nda_attend_with_drop_ids(audio_refs, height):
    (args, g), (want, jgrads) = audio_refs[height]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    geo = dict(fmap=(1, height), kernel=(AUDIO_K, 1, height), dilation=(AUDIO_DIL, 1, 1),
               mode="audio")
    out = knda.sparse_3dna(*leaves, dropout=(RATE, 1000 + height), **geo)
    _close(out.detach().numpy(), want, "out")
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, got, ref in zip(("q", "k", "v", "k_bos", "v_bos", "th", "bias"), grads, jgrads):
        _close(got.numpy(), ref, name)


def test_rate_zero_or_no_seed_is_no_dropout():
    """The kernels' functions, forward and backward, and the modules give the
    output without dropout bit for bit at a rate of 0 or without a seed."""
    args, g = _audio_case(3, 0)
    args = [torch.from_numpy(a) for a in args]
    g = torch.from_numpy(g)
    geo = dict(fmap=(4, 4), kernel=(3, 3, 3), dilation=(1, 1, 1))
    base = knda.sparse_3dna_fwd(*args[:6], None, **geo)
    base_bwd = knda.sparse_3dna_bwd_q(*args[:6], None, g, base[1], **geo)
    for off in ((0.0, 5), (RATE, None), None):
        again = knda.sparse_3dna_fwd(*args[:6], None, dropout=off, **geo)
        for a, b in zip(again, base):
            assert torch.equal(a, b)
        bwd = knda.sparse_3dna_bwd_q(*args[:6], None, g, base[1], dropout=off, **geo)
        for a, b in zip(bwd, base_bwd):
            assert (a is None and b is None) or torch.equal(a, b)
    _, _, tmod = _pair((3, 4, 4), 1, True)
    x = torch.from_numpy(_rnd(2, 40, DIM, seed=3))
    plain = Sparse3DNA(dim=DIM, video_shape=(3, 4, 4), kernel_size=3, heads=HEADS,
                       dim_head=DIM_HEAD, causal=True, rel_pos_bias=True)
    plain.load_state_dict(tmod.state_dict())
    assert torch.equal(tmod(x), plain(x))
    assert torch.equal(tmod(x, seed=None), plain(x, seed=3))
    assert not torch.equal(tmod(x, seed=3), plain(x))


def _share_dropped(kept, rate):
    """Assert the dropped share of ``kept`` lies within 3 binomial standard
    deviations of ``rate``."""
    n = kept.numel()
    dropped = n - int(kept.sum())
    assert abs(dropped - rate * n) <= 3 * (n * rate * (1 - rate)) ** 0.5, (dropped, n)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dense_and_feed_forward_masks(rate):
    """The dense attention's mask (b, h, query, key ids, the null column's
    -1) and the feed-forward's (the flat element index) drop a share of
    about the rate and scale what they keep by 1 / keep; the same seed draws
    the same mask again (a recompute), another seed another one."""
    x = torch.ones(3, 4, 50, 61)
    ids = (torch.arange(50), torch.arange(-1, 60)[None])
    y = dropout(x, rate, 11, ids=ids)
    _share_dropped(y != 0, rate)
    assert torch.equal(y.unique(), torch.tensor([0.0, 1.0 / (1.0 - rate)]))
    assert torch.equal(y, dropout(x, rate, 11, ids=ids))
    assert not torch.equal(y, dropout(x, rate, 12, ids=ids))
    z = dropout(torch.ones(4, 37, 85), rate, 5)
    _share_dropped(z != 0, rate)
    assert torch.equal(z, dropout(torch.ones(4, 37, 85), rate, 5))

    attn = init_weights_(Attention(DIM, heads=HEADS, dim_head=DIM_HEAD, dropout=rate), 0)
    ff = init_weights_(FeedForward(DIM), 1)
    xs = torch.from_numpy(_rnd(2, 9, DIM, seed=4))
    assert torch.equal(attn(xs), attn(xs, seed=None))
    assert not torch.equal(attn(xs), attn(xs, seed=3))
    assert torch.equal(attn(xs, seed=3), attn(xs, seed=3))
    ff_drop = FeedForward(DIM, dropout=rate)
    ff_drop.load_state_dict(ff.state_dict())
    assert torch.equal(ff(xs, seed=3), ff_drop(xs))
    assert not torch.equal(ff(xs), ff_drop(xs, seed=3))
