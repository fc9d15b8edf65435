"""Port parity for the rest of the models' surface, against nuwa_tpu with
the same weights, fp32 on the CPU (outputs within 1e-5 of the reference's
max abs, losses within 1e-4):

* NUWA with absolute text positions (``text_rotary_pos_emb=False``, the
  ``text_abs_pos_emb`` table), NUWAVideoAudio with the rotary and the
  reversible text encoders, each with ``ff_chunk_size`` set, as the JAX
  models run them;
* ``FeedForward(chunk_size=...)``: chunked equal to unchunked and to the
  JAX module at dropout rate 0; with dropout, a chunk's mask keyed by its
  elements' indices in the whole tensor, so a chunked training step drops
  what the unchunked one drops (the same loss and gradients);
* ``Dense(dtype=...)``, the compute dtype override.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_video_audio as va_base
from nuwa_tpu.core.layers import Dense as JDense
from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.models import NUWAVideoAudio as JNUWAVideoAudio
from nuwa_tpu.ops.feedforward import FeedForward as JFeedForward
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import NUWA, NUWAVideoAudio, VQGanVAE
from nuwa_tpu_torch.core.layers import Dense, init_weights_
from nuwa_tpu_torch.ops.feedforward import FeedForward
from test_torch_full_generate import NUWA_CFG, TEXT
from test_torch_sketch import jax_params

torch.set_num_threads(1)


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


def test_nuwa_absolute_text_positions_match_jax():
    """The JAX tree's ``text_abs_pos_emb`` loads into the port; logits and
    loss of a decoder whose feed-forwards run 3 positions at a time."""
    cfg = dict(NUWA_CFG, text_rotary_pos_emb=False, ff_chunk_size=3)
    tmodel = NUWA(**cfg, device="cpu", seed=4)
    assert not hasattr(NUWA(**NUWA_CFG, device="cpu"), "text_abs_pos_emb")
    jmodel = JNUWA(**cfg)
    params = jax_params(jmodel, tmodel)
    assert params["text_abs_pos_emb"]["table"].shape == (256, 16)
    video = np.random.default_rng(2).integers(0, 16, (2, 8)).astype(np.int32)
    run = jax.jit(lambda p: (jmodel.forward(p, text=TEXT, video=video),
                             jmodel.forward(p, text=TEXT, video=video, return_loss=True)))
    want, want_loss = run(params)
    with torch.no_grad():
        got = tmodel(TEXT, video)
        loss = tmodel(TEXT, video, return_loss=True)
    _close(got, want)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-4, rtol=0)


@pytest.mark.parametrize("encoder", [dict(text_rotary_pos_emb=True),
                                     dict(text_rotary_pos_emb=True, enc_reversible=True)])
def test_video_audio_text_encoders_match_jax(encoder):
    """NUWAVideoAudio's rotary text encoder, plain and reversible (no
    absolute table then), with chunked feed-forwards in the decoder: both
    logits and the loss."""
    cfg = dict(va_base.CFG, **va_base.CONFIGS["h1"], **encoder, ff_chunk_size=3)
    tmodel = NUWAVideoAudio(vae=VQGanVAE(**va_base.VAE, device="cpu", seed=1), **cfg,
                            device="cpu", seed=6)
    assert not hasattr(tmodel, "text_abs_pos_emb")
    jmodel = JNUWAVideoAudio(vae=JVQGanVAE(**va_base.VAE), **cfg)
    params = jax_params(jmodel, tmodel)
    ids = np.random.default_rng(3).integers(0, 16, (2, 8))
    run = jax.jit(lambda p: (
        jmodel.forward(p, text=va_base.TEXT, video=ids, audio=va_base.AUDIO),
        jmodel.forward(p, text=va_base.TEXT, video=ids, audio=va_base.AUDIO,
                       return_loss=True)))
    (want_v, want_a), want_loss = run(params)
    with torch.no_grad():
        got_v, got_a = tmodel(va_base.TEXT, ids, va_base.AUDIO)
        loss = tmodel(va_base.TEXT, ids, va_base.AUDIO, return_loss=True)
    _close(got_v, want_v)
    _close(got_a, want_a)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [7, 9])
def test_chunked_feedforward_matches_unchunked_and_jax(n):
    """9 positions in chunks of 4: a short last chunk (7 and 9 both ragged
    at 4; 7 also below 2 chunks' worth)."""
    tff = init_weights_(FeedForward(16, chunk_size=4), 1)
    jff = JFeedForward(dim=16, chunk_size=4)
    params = jax_params(jff, tff)
    x = _rnd(2, n, 16, seed=n)
    want = jax.jit(lambda p, x: jff(p, x))(params, x)
    with torch.no_grad():
        got = tff(torch.from_numpy(x))
        tff.chunk_size = None
        plain = tff(torch.from_numpy(x))
    _close(got, want)
    torch.testing.assert_close(got, plain, atol=1e-6, rtol=0)


def test_chunked_dropout_draws_the_unchunked_bits():
    """One FeedForward at rate 0.5 with a seed, chunked by 3 and not: the
    same output and the same gradients, so the same elements dropped."""
    ff = init_weights_(FeedForward(16, dropout=0.5), 2)
    x = torch.from_numpy(_rnd(2, 8, 16, seed=3)).requires_grad_()
    outs, grads = [], []
    for chunk in (None, 3):
        ff.chunk_size = chunk
        ff.zero_grad()
        x.grad = None
        out = ff(x, seed=1234)
        (out * torch.from_numpy(_rnd(2, 8, 16, seed=4))).sum().backward()
        outs.append(out.detach())
        grads.append([x.grad.clone()] + [p.grad.clone() for p in ff.parameters()])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-6, rtol=0)
    assert not torch.equal(outs[0], ff.net(x.detach()))  # dropout acted
    for a, b in zip(*grads):  # the weights' sums over rows, in chunks or not
        _close(a, b, rel=1e-6)


def test_chunked_training_step_matches_unchunked():
    """NUWA with ff_dropout = 0.1 trained one forward and backward with one
    generator seed, its decoder's feed-forwards chunked by 5 or not: the
    same loss and gradients."""
    results = []
    for chunk in (None, 5):
        model = NUWA(**dict(NUWA_CFG, ff_dropout=0.1, attn_dropout=0.1, ff_chunk_size=chunk),
                     device="cpu", seed=8)
        video = np.random.default_rng(5).integers(0, 16, (2, 8))
        loss = model(TEXT, video, return_loss=True, train=True,
                     generator=torch.Generator().manual_seed(11), uncond=[False, True])
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert abs(loss_a - loss_b) <= 1e-6
    for a, b in zip(grads_a, grads_b):
        _close(a, b, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_dtype_override_matches_jax(dtype):
    """``Dense(dtype=...)`` computes in that dtype whatever the input's:
    a bf16 input through an fp32 Dense and an fp32 input through a bf16
    one, against the JAX ``Dense(dtype=...)``."""
    tmod = init_weights_(Dense(16, 8, use_bias=True, dtype=dtype), 3)
    jmod = JDense(16, 8, use_bias=True, dtype=jnp.dtype(dtype))
    params = jax_params(jmod, tmod)
    x = _rnd(4, 16, seed=5)
    x_in = x.astype(jnp.bfloat16) if dtype == "float32" else x
    want = np.asarray(jax.jit(lambda p, x: jmod(p, x))(params, x_in).astype(jnp.float32))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = tmod(xt.bfloat16() if dtype == "float32" else xt)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float(), want, rel=1e-5 if dtype == "float32" else 1e-2)
