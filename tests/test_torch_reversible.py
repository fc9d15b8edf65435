"""Port parity for the training path's model: ``ReversibleTransformer`` and
the NUWA loss, against nuwa_tpu with the same params (loaded through
nuwa_tpu_torch.convert) and the same numpy inputs, fp32 on the CPU.

Outputs and losses: atol 1e-5 (1e-4 for the NUWA loss, 2 + 1 layers deep).
Gradients: each within 1e-4 of its reference's max abs; the reversible
backward rebuilds its activations by subtraction, so its sums differ from
JAX's by more than a plain backward's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.ops.sampling import prob_mask_like as jprob_mask_like
from nuwa_tpu.transformer import ReversibleTransformer as JReversibleTransformer
from nuwa_tpu_torch import NUWA
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.transformer import ReversibleTransformer

torch.set_num_threads(1)
REL = 1e-4


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_grads_match(tmod, jgrads, rel=REL):
    want = flatten_params(jax.tree.map(np.asarray, jgrads))
    got = {jax_path(tmod, n): p.grad for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name] is not None, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, err_msg=name,
                                   atol=rel * max(1.0, np.abs(w).max()))


STACK = dict(dim=16, depth=2, heads=2, dim_head=8, cross_attend=True,
             sparse_3dna_attn=True, sparse_3dna_video_shape=(2, 4, 4),
             sparse_3dna_kernel_size=(3, 3, 3), sparse_3dna_dilations=(1, 2),
             sparse_3dna_rel_pos_bias=True, shift_video_tokens=True)


@pytest.fixture(scope="module")
def stack():
    jmod = JReversibleTransformer(causal=True, **STACK)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    tmod = load_jax_params(ReversibleTransformer(causal=True, **STACK), params)
    n = 1 + 31  # bos and a ragged second frame
    x, ctx, w = _rnd(2, n, 16, seed=1), _rnd(2, 5, 16, seed=2), _rnd(2, n, 16, seed=3)
    cmask = np.array([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0]], bool)  # row 1: uncond

    def loss(p, x, ctx):
        out = jmod(p, x, context=ctx, context_mask=jnp.asarray(cmask), reverse=True)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(ctx)
    )
    return tmod, (x, ctx, cmask, w), out, grads


@pytest.mark.parametrize("reverse", [True, False])
def test_reversible_transformer_matches_jax(stack, reverse):
    """Output and the gradients of x, the context and every parameter against
    JAX's reverse=True; the port's reverse=False (plain autograd) too."""
    tmod, (x, ctx, cmask, w), want, (jgrads, jgx, jgctx) = stack
    tmod.zero_grad(set_to_none=True)
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, ctx))
    out = tmod(xt, context=ct, context_mask=torch.from_numpy(cmask), reverse=reverse)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in ((xt.grad, jgx), (ct.grad, jgctx)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=REL * max(1.0, np.abs(ref).max()))
    _assert_grads_match(tmod, jgrads)


CFG = dict(
    dim=32, image_size=4, num_image_tokens=64, max_video_frames=3,
    text_num_tokens=100, text_max_seq_len=8, text_enc_depth=1,
    text_enc_dim_head=16, text_enc_heads=2, dec_depth=2, dec_dim_head=16,
    dec_heads=2, sparse_3dna_kernel_size=(3, 3, 3), sparse_3dna_dilation=2,
    shift_video_tokens=True, sparse_3dna_rel_pos_bias=True, embed_gradient_frac=0.2,
)
TEXT = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 0]], np.int32)


@pytest.mark.parametrize("reversible", [True, False])
def test_nuwa_loss_and_grads_match_jax(reversible):
    """forward(return_loss=True, train=True): the teacher-forced loss with
    fractional embedding gradients and condition dropout, the JAX draw of
    the dropout mask injected into the port."""
    cfg = dict(CFG, dec_reversible=reversible, enc_reversible=reversible)
    jmodel = JNUWA(**cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = load_jax_params(NUWA(**cfg, device="cpu"), params)
    video = np.random.default_rng(1).integers(0, 64, (2, 48)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    uncond = np.array(jprob_mask_like(jax.random.split(key, 3)[2], (2,), 0.5))

    def loss(p):
        return jmodel.forward(p, text=jnp.asarray(TEXT), video=jnp.asarray(video),
                              return_loss=True, cond_dropout_prob=0.5, key=key, train=True)

    want, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    got = tmodel(TEXT, video, return_loss=True, cond_dropout_prob=0.5, train=True,
                 uncond=torch.from_numpy(uncond))
    assert abs(got.item() - float(want)) < 1e-4
    got.backward()
    _assert_grads_match(tmodel, jgrads)


@torch.no_grad()
def test_cached_reversible_steps_match_full_forward():
    """The cached decoder runs a reversible stack as two-stream couples:
    teacher-forced steps give the full forward's logits (atol 1e-4), and a
    prefill leaves the caches that as many steps leave (atol 1e-5)."""
    from nuwa_tpu_torch.decode import TransformerDecoder

    model = NUWA(**dict(CFG, dec_reversible=True), device="cpu", seed=2)
    text = torch.from_numpy(TEXT).long()
    mask = text != 0
    ctx = model.embed_text(text, mask)
    video = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (2, 47)))
    full = model._decode_logits(video, ctx, mask)
    dec = TransformerDecoder(model.video_transformer, total_in=48)
    caches = dec.init_cache(2, ctx, mask)
    pos_emb = model.video_pos_emb()
    rows, inputs = [], []
    for i in range(48):
        x_i = (model.video_bos.expand(2, -1) if i == 0
               else model.image_embedding.table[video[:, i - 1]] + pos_emb[i - 1])
        inputs.append(x_i)
        rows.append(dec.step(caches, x_i, i) @ model.to_logits)
    torch.testing.assert_close(torch.stack(rows, dim=1), full, atol=1e-4, rtol=0)
    prefilled = dec.prefill(dec.init_cache(2, ctx, mask), torch.stack(inputs[:20], dim=1))
    stepped = dec.init_cache(2, ctx, mask)
    for i in range(20):
        dec.step(stepped, inputs[i], i)
    for a, b in zip(stepped, prefilled):
        for key in a:
            torch.testing.assert_close(a[key], b[key], atol=1e-5, rtol=0)
