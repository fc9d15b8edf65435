"""Port parity for causal dense self-attention: ``Attention(causal=True)``,
the dense causal decoder of BASELINE config 2 (``Transformer(causal=True,
cross_attend=True)`` without Sparse3DNA, plain and reversible) and its
cached decoder (``decode._DenseSelfStep``), against nuwa_tpu with the same
weights (the port's, seeded, written into the JAX tree that
``jax.eval_shape`` of the JAX init gives), fp32 on the CPU.

Tolerances: outputs within 1e-5 of the reference's max abs; the causality
check at position 10 (tests/test_baseline_configs.py:55-61) within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.decode import TransformerDecoder as JDecoder
from nuwa_tpu.ops.attention import Attention as JAttention
from nuwa_tpu.transformer import ReversibleTransformer as JReversible
from nuwa_tpu.transformer import Transformer as JTransformer
from nuwa_tpu_torch.convert import load_jax_params
from nuwa_tpu_torch.core.layers import init_weights_
from nuwa_tpu_torch.decode import TransformerDecoder
from nuwa_tpu_torch.ops.attention import Attention
from nuwa_tpu_torch.transformer import ReversibleTransformer, Transformer
from test_torch_sketch import jax_params

torch.set_num_threads(1)
# BASELINE config 2 at tests/test_baseline_configs.py:47's size
CONFIG2 = dict(dim=32, depth=2, heads=2, dim_head=16, causal=True, cross_attend=True)
# tests/test_decode.py:66's size
DECODER = dict(dim=16, depth=2, heads=2, dim_head=8, causal=True, cross_attend=True)


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


def _pair(jcls, tcls, cfg, seed=0):
    tmodel = init_weights_(tcls(**cfg), seed)
    jmodel = jcls(**cfg)
    return jmodel, jax_params(jmodel, tmodel), tmodel


@pytest.mark.parametrize("masked", [False, True])
def test_causal_attention_matches_jax(masked):
    """tests/test_attention.py:19's module: dim 32, 2 heads of 8, 8 tokens,
    with and without a key mask; a later token does not reach earlier
    outputs."""
    cfg = dict(dim=32, heads=2, dim_head=8, causal=True)
    jmod, params, tmod = _pair(JAttention, Attention, cfg)
    x = _rnd(2, 8, 32, seed=1)
    mask = np.array([[True] * 8, [True] * 5 + [False] * 3]) if masked else None
    want = jax.jit(lambda p, x, m: jmod(p, x, mask=m))(params, x, mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), mask=tmask)
        x2 = x.copy()
        x2[:, 5] = _rnd(32, seed=7)
        got2 = tmod(torch.from_numpy(x2), mask=tmask)
    _close(got, want)
    np.testing.assert_allclose(got2[:, :5].numpy(), got[:, :5].numpy(), atol=1e-6, rtol=0)
    assert not np.allclose(got2[:, 5:].numpy(), got[:, 5:].numpy())


@pytest.mark.parametrize("reversible", [False, True])
def test_config2_decoder_matches_jax(reversible):
    """BASELINE config 2's dense causal decoder with cross-attention: the
    output against JAX, and causality end to end at position 10."""
    jcls, tcls = (JReversible, ReversibleTransformer) if reversible else (JTransformer,
                                                                          Transformer)
    jmod, params, tmod = _pair(jcls, tcls, CONFIG2, seed=2)
    x, ctx = _rnd(1, 17, 32, seed=3), _rnd(1, 8, 32, seed=4)
    want = jax.jit(lambda p, x, c: jmod(p, x, context=c))(params, x, ctx)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), context=torch.from_numpy(ctx))
        x2 = x.copy()
        x2[:, 10] = 3.0
        out2 = tmod(torch.from_numpy(x2), context=torch.from_numpy(ctx))
    assert out.shape == x.shape
    _close(out, want)
    np.testing.assert_allclose(out2[:, :10].numpy(), out[:, :10].numpy(), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def decoder():
    """tests/test_decode.py:66's decoder and inputs: b 2, 7 positions, a
    context of 5 whose second row masks its last two."""
    jmod, params, tmod = _pair(JTransformer, Transformer, DECODER, seed=5)
    x, ctx = _rnd(2, 7, 16, seed=6), _rnd(2, 5, 16, seed=7)
    cmask = np.array([[True] * 5, [True, True, True, False, False]])
    return jmod, params, tmod, x, ctx, cmask


def test_dense_decoder_steps_match_jax(decoder):
    """The port's cached steps against the JAX decoder's steps and the JAX
    full forward, and ``prefill`` leaving the caches of n steps."""
    jmod, params, tmod, x, ctx, cmask = decoder
    full = jax.jit(lambda p, x, c, m: jmod(p, x, context=c, context_mask=m))(
        params, x, ctx, cmask)
    jdec = JDecoder(jmod, total_in=7)

    @jax.jit
    def jax_steps(p, x, c, m):
        caches = jdec.init_cache(p, 2, c, m)
        outs = []
        for i in range(7):
            y, caches = jdec.step(p, caches, x[:, i], jnp.asarray(i))
            outs.append(y)
        return jnp.stack(outs, axis=1)

    want = jax_steps(params, x, ctx, cmask)
    xt, ct, mt = (torch.from_numpy(a) for a in (x, ctx, cmask))
    dec = TransformerDecoder(tmod, total_in=7)
    with torch.no_grad():
        stepped = dec.init_cache(2, ct, mt)
        got = torch.stack([dec.step(stepped, xt[:, i], i) for i in range(7)], dim=1)
        prefilled = dec.prefill(dec.init_cache(2, ct, mt), xt[:, :4])
        rest = torch.stack([dec.step(prefilled, xt[:, i], i) for i in range(4, 7)], dim=1)
    _close(got, want)
    _close(got, full)
    _close(rest, np.asarray(want)[:, 4:])
    for a, b in zip(stepped, prefilled):
        assert a.keys() == b.keys()
        for key in a:
            torch.testing.assert_close(a[key], b[key], atol=1e-5, rtol=0)


def test_params_tree_loads_every_leaf(decoder):
    """The dense causal decoder's JAX tree loads into a fresh port module,
    which then gives the same output."""
    jmod, params, tmod, x, ctx, _ = decoder
    fresh = load_jax_params(Transformer(**DECODER), params)
    with torch.no_grad():
        a = fresh(torch.from_numpy(x), context=torch.from_numpy(ctx))
        b = tmod(torch.from_numpy(x), context=torch.from_numpy(ctx))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
