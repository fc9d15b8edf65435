"""Port parity for NUWASketch training: ``forward(return_loss=True,
train=True)`` and its gradients, and one AdamW step, against nuwa_tpu with
the same params and numpy inputs, fp32 on the CPU.

The tiny configuration of test_torch_sketch.py (BASELINE config 4's shape:
a 5-channel sketch VAE, fmap 4, 2 video and 2 sketch frames, dim 16, 2 heads
of 8, decoder depth 2 with dilations (1, 2), token shift) in two models: a
dense sketch encoder before a plain decoder, given one sketch frame; and a
centered Sparse3DNA encoder of depth 2 (``sketch_enc_use_sparse_3dna``,
token shift on the sketch grid, the first sketch token its bos) before a
reversible decoder, given two sketch frames, the second padded in row 1.
Condition dropout masks one row's sketch: the JAX package draws the mask
from its key, so the test draws it from the same key and injects it into
the port (``uncond``). The weights are the port's, made from a seed and
written into the JAX params tree (whose shape ``jax.eval_shape`` gives
without a compile); ``load_jax_params`` then reads that tree back, every
leaf once.

Tolerances: the loss within 1e-4 (three stacks deep); each gradient within
1e-4 of its reference's max abs (the reversible backward rebuilds its
activations by subtraction); the AdamW step, fed the same gradients on both
sides so that Adam's first, sign-like step cannot magnify their rounding,
within 1e-6 (steps of size lr = 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWASketch as JNUWASketch
from nuwa_tpu.ops.sampling import prob_mask_like as jprob_mask_like
from nuwa_tpu.train import optimizer as jopt
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.train import clip_by_global_norm_, get_optimizer

import test_torch_sketch as base

torch.set_num_threads(1)
REL, LOSS_ATOL, PROB = 1e-4, 1e-4, 0.5
# (model options, sketch frames)
MODELS = {
    "dense_encoder-plain_decoder": (dict(sketch_enc_use_sparse_3dna=False,
                                         dec_reversible=False), 1),
    "centered_encoder-reversible_decoder": (dict(sketch_enc_use_sparse_3dna=True,
                                                 sketch_enc_depth=2, dec_reversible=True), 2),
}


def _dropout_key():
    """A key whose condition-dropout draw masks one row of two, and that mask."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        uncond = np.asarray(jprob_mask_like(jax.random.split(key, 3)[2], (2,), PROB))
        if uncond.sum() == 1:
            return key, uncond
    raise AssertionError("no key masks exactly one row")


@pytest.fixture(scope="module", params=list(MODELS))
def case(request):
    """The model pair, and the JAX loss and gradients at its sketch frames."""
    options, frames = MODELS[request.param]
    cfg = dict(base.CFG, **options)
    jmodel = JNUWASketch(vae=JVQGanVAE(**base.VAE), sketch_vae=JVQGanVAE(**base.VAE, channels=5),
                         **cfg)
    tmodel = base._port(cfg)
    params = base.jax_params(jmodel, tmodel)
    load_jax_params(tmodel, params)  # reads every leaf once
    sketch = base.SKETCH if frames == 2 else base.SKETCH[:, 0]
    mask = base.SKETCH_MASK if frames == 2 else None
    key, uncond = _dropout_key()

    def loss(p):
        return jmodel.forward(p, sketch=sketch, video=base.VIDEO, sketch_mask=mask,
                              return_loss=True, cond_dropout_prob=PROB, key=key, train=True)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return tmodel, params, (sketch, mask, uncond), float(value), grads


def _trainable(tmodel):
    """{JAX path: parameter} of the parameters that train (not the VAEs)."""
    return {jax_path(tmodel, n): p for n, p in tmodel.named_parameters() if p.requires_grad}


def test_loss_and_grads_match_jax(case):
    tmodel, _, (sketch, mask, uncond), want, grads = case
    jgrads = flatten_params(jax.tree.map(np.asarray, grads))
    tmodel.zero_grad(set_to_none=True)
    got = tmodel(sketch, base.VIDEO, sketch_mask=mask, return_loss=True, train=True,
                 uncond=torch.tensor(uncond))
    assert abs(got.item() - want) <= LOSS_ATOL
    got.backward()
    trainable = _trainable(tmodel)
    # every leaf of the JAX tree is a trainable port parameter or a frozen VAE's
    assert set(jgrads) - set(trainable) == {
        n for n in jgrads if n.split(".")[0] in ("vae", "sketch_vae")}
    for name, p in trainable.items():
        assert p.grad is not None, name
        ref = jgrads[name]
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, err_msg=name,
                                   atol=REL * max(1.0, np.abs(ref).max()))


def test_adamw_step_matches_optax(case):
    """One step of the port's AdamW (weight decay on parameters of ndim >= 2,
    the frozen VAEs left out, global-norm clipping) against the JAX
    package's optax chain, from JAX's gradients of the loss."""
    tmodel, params, _, _, grads = case
    jgrads = flatten_params(jax.tree.map(np.asarray, grads))
    kw = dict(lr=1e-2, wd=0.1)
    tx = jopt.get_optimizer(**kw, params=params, max_grad_norm=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    updates, _ = tx.update(grads, tx.init(jp), jp)
    want = flatten_params(jax.tree.map(lambda a, b: np.asarray(a + b), jp, updates))
    trainable = _trainable(tmodel)
    before = {n: p.detach().clone() for n, p in trainable.items()}
    try:
        for name, p in trainable.items():
            p.grad = torch.from_numpy(jgrads[name].copy())
        clip_by_global_norm_(list(trainable.values()), 0.5)
        get_optimizer(list(tmodel.parameters()), **kw).step()
        for name, p in trainable.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=0,
                                       err_msg=name)
    finally:
        with torch.no_grad():
            for name, p in trainable.items():
                p.copy_(before[name])
