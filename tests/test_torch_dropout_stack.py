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
  * The same with a SparseCross2DNA block a depth (a context of two frames,
    row 1 partly masked), the port's seeds again those of JAX's split keys
    (one a menu entry: self, cross, ff; or f and g of the (self, ff) and
    (cross, ff_cross) couples), and the gradient of the context too. The
    JAX cross modules are put on their fused Pallas kernels in interpret
    mode (fp32 score cache) by this test, whose keyed masks the port's
    match; on the CPU the JAX module would take its gather path, which
    draws ``jax.random`` bits instead. The JAX Sparse3DNA modules keep
    their gather path.
  * NUWA with ``attn_dropout = ff_dropout = 0.1`` in the text encoder and a
    reversible decoder: its recompute backward gives the loss and every
    gradient of the same model run under plain autograd (``reverse=False``)
    with the same seeds (one seed from the same generator), so it replays
    each mask; the loss differs from the loss without dropout.
  * ``generate`` of a NUWA with dropout configured gives the ids of the same
    weights without it: inference never drops.
  * NUWASketch with ``attn_dropout = ff_dropout = 0.1`` (a centered
    Sparse3DNA sketch encoder, a reversible decoder with SparseCross2DNA):
    its training forward gives a finite loss, its recompute backward the
    loss and gradients of ``reverse=False``, and its ``generate`` the ids of
    the same weights without dropout.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nuwa_tpu.kernels.nda_pallas as K
import nuwa_tpu.transformer as jtransformer
from nuwa_tpu.nda import SparseCross2DNA as JSparseCross2DNA
from nuwa_tpu.transformer import ReversibleTransformer as JReversibleTransformer
from nuwa_tpu.transformer import Transformer as JTransformer
from nuwa_tpu_torch import NUWA, NUWASketch, VQGanVAE
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.transformer import ReversibleTransformer, Transformer

torch.set_num_threads(1)
REL = 1e-4
STACK = dict(dim=16, depth=2, heads=2, dim_head=8, causal=True, sparse_3dna_attn=True,
             sparse_3dna_video_shape=(2, 4, 4), sparse_3dna_kernel_size=(3, 3, 3),
             sparse_3dna_dilations=(1, 2), sparse_3dna_rel_pos_bias=True,
             shift_video_tokens=True, attn_dropout=0.1, ff_dropout=0.0)
CROSS_STACK = dict(STACK, cross_attend=True, cross_2dna_attn=True, cross_2dna_image_size=4,
                   cross_2dna_kernel_size=3, cross_2dna_dilations=(1, 2))
CONTEXT_MASK = np.ones((2, 32), bool)
CONTEXT_MASK[1, 20:] = False
KEY = jax.random.PRNGKey(3)


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _seeds(key, n):
    """The seed each of the n layers' Sparse3DNA draws from its split key."""
    return [int(jax.random.randint(k, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])
            for k in jax.random.split(key, n)]


def _stacks(cfg, cross):
    """The port's plain and reversible stacks loaded with the JAX stacks'
    params, the inputs, and JAX's outputs and gradients (x's and, with a
    cross block, the context's) under KEY."""
    x, w = _rnd(2, 1 + 31, 16, seed=1), _rnd(2, 1 + 31, 16, seed=2)  # a ragged frame
    kw = dict(context=_rnd(2, 32, 16, seed=3), context_mask=CONTEXT_MASK) if cross else {}
    with contextlib.ExitStack() as scope:
        if cross:  # the JAX cross modules on their fused kernels, in interpret mode
            mp = scope.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(K, "_CACHE_DTYPE", jnp.float32)
            mp.setattr(jtransformer, "SparseCross2DNA",
                       functools.partial(JSparseCross2DNA, use_pallas=True))
            scope.enter_context(pltpu.force_tpu_interpret_mode())
            scope.callback(K._VJP_CACHE.clear)
            K._VJP_CACHE.clear()
        jplain, jrev = JTransformer(**cfg), JReversibleTransformer(**cfg)
        params = [jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(i)))
                  for i, m in enumerate((jplain, jrev))]

        def loss(ps, x, ctxs):  # a context of each stack's own, for its gradient
            outs = [m(p, x, key=KEY, **dict(kw, context=c) if cross else {})
                    for m, p, c in zip((jplain, jrev), ps, ctxs)]
            return sum(jnp.sum(o * w) for o in outs), outs

        ctx = jnp.asarray(kw.get("context", 0.0))
        (_, outs), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            params, jnp.asarray(x), (ctx, ctx))
    ports = (load_jax_params(Transformer(**cfg), params[0]),
             load_jax_params(ReversibleTransformer(**cfg), params[1]))
    return ports, (x, w, kw), outs, grads


@pytest.fixture(scope="module")
def stacks():
    return _stacks(STACK, cross=False)


@pytest.fixture(scope="module")
def cross_stacks():
    return _stacks(CROSS_STACK, cross=True)


def _check_stack(stacks, reversible):
    """The port's stack given the seeds of JAX's split keys: its output and
    the gradients of every parameter and input against JAX's."""
    ports, (x, w, kw), outs, (jgrads, _, jgctx) = stacks
    tmod, want, jg = ports[reversible], outs[reversible], jgrads[reversible]
    tmod.zero_grad(set_to_none=True)
    n = len(tmod.layers) * (2 if reversible else 1)
    xt = torch.from_numpy(x).requires_grad_()
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    if "context" in tkw:
        tkw["context"].requires_grad_()
    out = tmod(xt, seed=_seeds(KEY, n), **tkw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    want = flatten_params(jax.tree.map(np.asarray, jg))
    got = {jax_path(tmod, n): p.grad for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(want)
    if "context" in tkw:
        got["context"] = tkw["context"].grad
        want["context"] = np.asarray(jgctx[reversible])
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=0, err_msg=name,
                                   atol=REL * max(1.0, np.abs(ref).max()))
    # without a seed, nothing drops: another output
    kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    assert not np.allclose(tmod(torch.from_numpy(x), **kw).detach().numpy(),
                           np.asarray(outs[reversible]))


@pytest.mark.parametrize("reversible", [False, True])
def test_dropout_stack_matches_jax(stacks, reversible):
    """Plain: one seed a menu entry (self, ff per depth); reversible: the f
    and g seeds of each (self, ff) couple, from the same split keys."""
    _check_stack(stacks, reversible)


@pytest.mark.parametrize("reversible", [False, True])
def test_cross_dropout_stack_matches_jax(cross_stacks, reversible):
    """Plain: one seed a menu entry (self, cross, ff per depth); reversible:
    the f and g seeds of each (self, ff) and (cross, ff_cross) couple."""
    _check_stack(cross_stacks, reversible)


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


SKETCH_VAE = dict(dim=8, image_size=8, num_layers=1, vq_codebook_size=16, vq_codebook_dim=8,
                  resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
                  num_resnet_blocks=0)
SKETCH_CFG = dict(dim=16, image_size=8, max_video_frames=2, sketch_max_video_frames=2,
                  sketch_enc_depth=2, sketch_enc_dim_head=8, sketch_enc_heads=2,
                  sketch_enc_use_sparse_3dna=True, dec_depth=2, dec_dim_head=8, dec_heads=2,
                  dec_reversible=True, cross_2dna_kernel_size=3, cross_2dna_dilation=2,
                  sparse_3dna_kernel_size=3, sparse_3dna_dilation=2)
SKETCH = np.random.default_rng(3).uniform(0, 1, (2, 2, 5, 8, 8)).astype(np.float32)
SKETCH_VIDEO = np.random.default_rng(4).uniform(0, 1, (2, 2, 3, 8, 8)).astype(np.float32)
SKETCH_MASK = np.array([[True, True], [True, False]])


def _sketch_model(**drop):
    return NUWASketch(vae=VQGanVAE(**SKETCH_VAE, device="cpu"),
                      sketch_vae=VQGanVAE(**SKETCH_VAE, channels=5, device="cpu"),
                      **SKETCH_CFG, **drop, device="cpu")


def _sketch_loss_and_grads(model):
    model.zero_grad(set_to_none=True)
    loss = model(SKETCH, SKETCH_VIDEO, sketch_mask=SKETCH_MASK, return_loss=True, train=True,
                 uncond=torch.tensor([False, True]), generator=torch.Generator().manual_seed(5))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def test_reversible_sketch_replays_its_dropout_masks(monkeypatch):
    model = _sketch_model(attn_dropout=0.1, ff_dropout=0.1)
    loss, grads = _sketch_loss_and_grads(model)
    assert np.isfinite(loss)
    stack = model.video_transformer
    monkeypatch.setattr(stack, "forward", functools.partial(stack.forward, reverse=False))
    want, want_grads = _sketch_loss_and_grads(model)
    assert abs(loss - want) < 1e-5
    assert sorted(grads) == sorted(want_grads)
    for name, ref in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), ref.numpy(), rtol=0, err_msg=name,
                                   atol=REL * max(1.0, ref.abs().max().item()))
    # without dropout (the model's forward then draws no seed) the gradients
    # move: at these widths the loss is close to log(vocab) either way
    model.attn_dropout = model.ff_dropout = 0.0
    plain = _sketch_loss_and_grads(model)[1]
    assert max((plain[n] - g).abs().max().item() / max(1.0, g.abs().max().item())
               for n, g in want_grads.items()) > 1e-2


@torch.no_grad()
def test_sketch_generate_never_drops():
    ids = [_sketch_model(**drop).generate(
        SKETCH, sketch_mask=SKETCH_MASK, generator=torch.Generator().manual_seed(9),
        num_frames=1, decode_video=False)
        for drop in ({}, dict(attn_dropout=0.1, ff_dropout=0.1))]
    assert torch.equal(*ids)
