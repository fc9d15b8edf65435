"""Port parity for attention and feed-forward dropout through the stacks and
NUWA, fp32 on the CPU.

  * A causal decoder stack of depth 2 with Sparse3DNA self-attention, token
    shift, rel-pos bias, ``attn_dropout=0.1``, ``ff_dropout=0`` and no
    cross block, plain (``Transformer``) and reversible
    (``ReversibleTransformer``, its recompute backward), against the JAX
    stacks run with a key: each layer's seed in the port is the one its
    Sparse3DNA draws from the key JAX splits off for that layer (one a menu
    entry, or ``key{i}f`` / ``key{i}g`` a couple), so the masks are the
    same and so are the output (atol 1e-5) and the gradients of x and of
    every parameter (within 1e-4 of each reference's max abs: the reversible
    backward rebuilds its activations by subtraction). The JAX references
    come from one jitted ``jax.value_and_grad`` over both stacks.
  * NUWA with ``attn_dropout = ff_dropout = 0.1`` in the text encoder and a
    reversible decoder: its recompute backward gives the loss and every
    gradient of the same model run under plain autograd (``reverse=False``)
    with the same seeds (one seed from the same generator), so it replays
    each mask; the loss differs from the loss without dropout.
  * ``generate`` of a NUWA with dropout configured gives the ids of the same
    weights without it: inference never drops.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.transformer import ReversibleTransformer as JReversibleTransformer
from nuwa_tpu.transformer import Transformer as JTransformer
from nuwa_tpu_torch import NUWA
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.transformer import ReversibleTransformer, Transformer

torch.set_num_threads(1)
REL = 1e-4
STACK = dict(dim=16, depth=2, heads=2, dim_head=8, causal=True, sparse_3dna_attn=True,
             sparse_3dna_video_shape=(2, 4, 4), sparse_3dna_kernel_size=(3, 3, 3),
             sparse_3dna_dilations=(1, 2), sparse_3dna_rel_pos_bias=True,
             shift_video_tokens=True, attn_dropout=0.1, ff_dropout=0.0)
KEY = jax.random.PRNGKey(3)


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _seeds(key, n):
    """The seed each of the n layers' Sparse3DNA draws from its split key."""
    return [int(jax.random.randint(k, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])
            for k in jax.random.split(key, n)]


@pytest.fixture(scope="module")
def stacks():
    jplain, jrev = JTransformer(**STACK), JReversibleTransformer(**STACK)
    params = [jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(i)))
              for i, m in enumerate((jplain, jrev))]
    x, w = _rnd(2, 1 + 31, 16, seed=1), _rnd(2, 1 + 31, 16, seed=2)  # a ragged frame

    def loss(ps, x):
        outs = [m(p, x, key=KEY) for m, p in zip((jplain, jrev), ps)]
        return sum(jnp.sum(o * w) for o in outs), outs

    (_, outs), (jgrads, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    ports = (load_jax_params(Transformer(**STACK), params[0]),
             load_jax_params(ReversibleTransformer(**STACK), params[1]))
    return ports, (x, w), outs, jgrads


@pytest.mark.parametrize("reversible", [False, True])
def test_dropout_stack_matches_jax(stacks, reversible):
    """Plain: one seed a menu entry (self, ff per depth); reversible: the f
    and g seeds of each (self, ff) couple, from the same split keys."""
    ports, (x, w), outs, jgrads = stacks
    tmod, want, jg = ports[reversible], outs[reversible], jgrads[reversible]
    n = len(tmod.layers) * (2 if reversible else 1)
    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(xt, seed=_seeds(KEY, n))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    want = flatten_params(jax.tree.map(np.asarray, jg))
    got = {jax_path(tmod, n): p.grad for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=0, err_msg=name,
                                   atol=REL * max(1.0, np.abs(ref).max()))
    # without a seed, nothing drops: another output
    assert not np.allclose(tmod(torch.from_numpy(x)).detach().numpy(), np.asarray(outs[reversible]))


CFG = dict(
    dim=32, image_size=4, num_image_tokens=64, max_video_frames=3,
    text_num_tokens=100, text_max_seq_len=8, text_enc_depth=1,
    text_enc_dim_head=16, text_enc_heads=2, dec_depth=2, dec_dim_head=16,
    dec_heads=2, sparse_3dna_kernel_size=(3, 3, 3), sparse_3dna_dilation=2,
    shift_video_tokens=True, sparse_3dna_rel_pos_bias=True, dec_reversible=True,
)
TEXT = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 0]])
VIDEO = np.random.default_rng(1).integers(0, 64, (2, 48))


def _loss_and_grads(model, **kw):
    model.zero_grad(set_to_none=True)
    loss = model(TEXT, VIDEO, return_loss=True, train=True, uncond=torch.tensor([False, True]),
                 generator=torch.Generator().manual_seed(5), **kw)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_reversible_nuwa_replays_its_dropout_masks(monkeypatch):
    model = NUWA(**CFG, attn_dropout=0.1, ff_dropout=0.1, device="cpu")
    loss, grads = _loss_and_grads(model)
    stack = model.video_transformer
    monkeypatch.setattr(stack, "forward", functools.partial(stack.forward, reverse=False))
    want, want_grads = _loss_and_grads(model)
    assert abs(loss - want) < 1e-5
    for name, ref in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), ref.numpy(), rtol=0, err_msg=name,
                                   atol=REL * max(1.0, ref.abs().max().item()))
    model.attn_dropout = model.ff_dropout = 0.0  # the model's forward draws no seed
    assert abs(_loss_and_grads(model)[0] - want) > 1e-3


@torch.no_grad()
def test_generate_never_drops():
    ids = [NUWA(**CFG, **drop, device="cpu").generate(
        TEXT, generator=torch.Generator().manual_seed(9), num_frames=2)
        for drop in ({}, dict(attn_dropout=0.1, ff_dropout=0.1))]
    assert torch.equal(*ids)
