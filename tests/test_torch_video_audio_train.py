"""Port parity for NUWAVideoAudio training: ``forward(return_loss=True,
train=True)``, the loss's gradient in every trained parameter, and one
clip-and-AdamW step, against nuwa_tpu with the same params and numpy inputs,
fp32 on the CPU.

The tiny configuration of test_torch_video_audio.py (a two-layer codec on
8-pixel frames, dim 16, 2 heads of 8, 2 frames of 4 video tokens and 3
audio tokens, a text encoder of depth 1, a decoder of depth 2 with
cross-modality attention every 2 depths, so one ``xmod`` block, and
SparseCausal2DNA kernel 3), from token ids. Here H = 1 and the plain
decoder, no rel-pos bias; the JAX forward gets no key, so no condition
dropout, and the port ``cond_dropout_prob=0``. The same checks hold the
reversible decoder in test_torch_video_audio_train_reversible.py and the
plain one with ``dec_remat`` in test_torch_video_audio_train_remat.py, one
model a file to keep each file's time small. The weights are the port's,
made from a seed and written into the JAX params tree that
``jax.eval_shape`` of the JAX init gives (test_torch_sketch.jax_params).

Tolerances: the loss within 1e-5; each gradient within 1e-4 of its
reference's max abs (at least 1): sums in another order, and the reversible
backward rebuilds its activations by subtraction. The step of the port's
``clip_by_global_norm_`` and ``get_optimizer`` against the JAX package's
optax chain (``get_optimizer(lr, wd=0.01, max_grad_norm=0.5)``), fed JAX's
gradients on both sides so that Adam's first, sign-like step cannot magnify
their rounding: every parameter within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWAVideoAudio as JNUWAVideoAudio
from nuwa_tpu.ops.sampling import prob_mask_like as jprob_mask_like
from nuwa_tpu.train import optimizer as jopt
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE
from nuwa_tpu_torch.convert import flatten_params, jax_path
from nuwa_tpu_torch.train import clip_by_global_norm_, get_optimizer
from test_torch_sketch import jax_params

import test_torch_video_audio as base

torch.set_num_threads(1)
REL, LOSS_ATOL, STEP_ATOL, PROB, STEP_LR = 1e-4, 1e-5, 1e-5, 0.5, 1e-2
VIDEO = np.random.default_rng(3).integers(0, 16, (2, 2 * 4))


def dropout_key():
    """A key whose condition-dropout draw masks one row of two, and that mask."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        uncond = np.asarray(jprob_mask_like(jax.random.split(key, 3)[2], (2,), PROB))
        if uncond.sum() == 1:
            return key, uncond
    raise AssertionError("no key masks exactly one row")


def jax_loss_and_grads(name, dropout, **options):
    """The port's model ``name`` of test_torch_video_audio.py (with
    ``options``), its weights as the JAX params tree, JAX's loss and
    gradients, the condition-dropout mask (None without dropout), and the
    params after one step of the JAX package's optax chain (clip 0.5, AdamW
    at STEP_LR, weight decay 0.01) from those gradients: the loss, its
    gradients and the step in one jitted call."""
    cfg = dict(base.CFG, **base.CONFIGS[name], **options)
    tmodel = NUWAVideoAudio(vae=VQGanVAE(**base.VAE, device="cpu", seed=1), **cfg,
                            device="cpu", seed=0)
    jmodel = JNUWAVideoAudio(vae=JVQGanVAE(**base.VAE), **cfg)
    params = jax_params(jmodel, tmodel)
    key, uncond = dropout_key() if dropout else (None, None)

    def loss(p):
        return jmodel.forward(p, text=base.TEXT, video=VIDEO, audio=base.AUDIO,
                              return_loss=True, cond_dropout_prob=PROB, key=key, train=True)

    tx = jopt.get_optimizer(lr=STEP_LR, wd=0.01, params=params, max_grad_norm=0.5)

    def loss_grads_and_step(p):
        value, grads = jax.value_and_grad(loss)(p)
        return value, grads, jax.tree.map(jnp.add, p, tx.update(grads, tx.init(p), p)[0])

    value, grads, stepped = jax.jit(loss_grads_and_step)(params)
    return tmodel, stepped, uncond, float(value), grads


def trainable(tmodel):
    """{JAX path: parameter} of the parameters that train (not the codec)."""
    return {jax_path(tmodel, n): p for n, p in tmodel.named_parameters() if p.requires_grad}


def check_loss_and_grads(case):
    tmodel, _, uncond, want, grads = case
    jgrads = flatten_params(jax.tree.map(np.asarray, grads))
    tmodel.zero_grad(set_to_none=True)
    kw = dict(uncond=torch.tensor(uncond)) if uncond is not None else dict(cond_dropout_prob=0)
    got = tmodel(base.TEXT, VIDEO, base.AUDIO, return_loss=True, train=True, **kw)
    assert abs(got.item() - want) <= LOSS_ATOL
    got.backward()
    params = trainable(tmodel)
    # every leaf of the JAX tree is a trained port parameter or the frozen codec's
    assert set(jgrads) - set(params) == {n for n in jgrads if n.startswith("vae.")}
    for name, p in params.items():
        assert p.grad is not None, name
        ref = jgrads[name]
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, err_msg=name,
                                   atol=REL * max(1.0, np.abs(ref).max()))


def check_step(case):
    """One step of the port's global-norm clip (0.5) and AdamW (weight decay
    0.01 on parameters of ndim >= 2, the frozen codec left out) against the
    JAX package's optax chain, from JAX's gradients of the loss."""
    tmodel, stepped, _, _, grads = case
    jgrads = flatten_params(jax.tree.map(np.asarray, grads))
    kw = dict(lr=STEP_LR, wd=0.01)
    want = flatten_params(jax.tree.map(np.asarray, stepped))
    trained = trainable(tmodel)
    before = {n: p.detach().clone() for n, p in trained.items()}
    try:
        for name, p in trained.items():
            p.grad = torch.from_numpy(jgrads[name].copy())
        clip_by_global_norm_(list(trained.values()), 0.5)
        get_optimizer(list(tmodel.parameters()), **kw).step()
        for name, p in trained.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=STEP_ATOL,
                                       rtol=0, err_msg=name)
    finally:
        with torch.no_grad():
            for name, p in trained.items():
                p.copy_(before[name])


@pytest.fixture(scope="module")
def case():
    return jax_loss_and_grads("h1", dropout=False)


def test_loss_and_grads_match_jax(case):
    assert not case[0].video_audio_transformer.remat
    check_loss_and_grads(case)


def test_clip_and_adamw_step_matches_optax(case):
    check_step(case)
