"""Port parity for NUWA from text and pixels: ``NUWA(vae=...)`` in nuwa_tpu
and in nuwa_tpu_torch with the same weights (the port's, seeded, written
into the JAX params tree that ``jax.eval_shape`` of the JAX init gives:
test_torch_sketch.jax_params).

A tiny model: a one-layer codec on 8-pixel frames (fmap 4), dim 16, 2 heads
of 8, a plain decoder of depth 2 with dilations (1, 2), rel-pos bias and
token shift, 2 frames, captions from the port's tokenizer (vocab 49,408).
fp32 on the CPU.

  * the codec's token ids equal; the loss from pixels within 1e-5 and every
    gradient within 1e-4 of its reference's max abs; the codec gets none in
    the port (no ``grad``) and zeros in JAX (its stop_gradient);
  * the same loss and gradient checks with a one-layer codec on 36-pixel
    frames, fmap 18 (HW 324): the whole path past 256 tokens a frame.
Sampling to pixels and the trainer: test_torch_nuwa_vae_sample.py, with the
same model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import NUWA, VQGanVAE, tokenizer
from nuwa_tpu_torch.convert import _tensors, flatten_params, load_jax_params, load_nuwa_vae
from test_torch_sketch import jax_params

torch.set_num_threads(1)
VAE = dict(dim=8, image_size=8, num_layers=1, vq_codebook_size=16, vq_codebook_dim=8,
           resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
           num_resnet_blocks=0)
CFG = dict(dim=16, max_video_frames=2, text_num_tokens=49408, text_max_seq_len=8,
           text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2, dec_depth=2,
           dec_dim_head=8, dec_heads=2, sparse_3dna_kernel_size=3, sparse_3dna_dilation=2,
           sparse_3dna_rel_pos_bias=True, shift_video_tokens=True)
CAPTIONS = ["a red square moves right", "a blue square falls"]
TEXT = tokenizer.tokenize(CAPTIONS, CFG["text_max_seq_len"], truncate_text=True)


def _pixels(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _models(vae=VAE, seed=0, **cfg):
    cfg = dict(CFG, **cfg)
    tmodel = NUWA(vae=VQGanVAE(**vae, device="cpu", seed=seed + 1), **cfg, device="cpu",
                  seed=seed)
    jmodel = JNUWA(vae=JVQGanVAE(**vae), **cfg)
    return jmodel, jax_params(jmodel, tmodel), tmodel


@pytest.fixture(scope="module")
def pair():
    return _models()


def test_convert_loads_a_jax_tree_with_its_codec(pair):
    """Every leaf once, the codec's under "vae" (params and codebook state);
    ``load_nuwa_vae`` loads the codec alone."""
    _, params, tmodel = pair
    n = len(list(tmodel.parameters())) + len(list(tmodel.buffers()))
    assert len(flatten_params(params)) == n
    other = load_jax_params(NUWA(vae=VQGanVAE(**VAE, device="cpu", seed=7), **CFG,
                                 device="cpu", seed=5), params)
    for (name, a), b in zip(tmodel.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), name
    fresh = NUWA(vae=VQGanVAE(**VAE, device="cpu", seed=7), **CFG, device="cpu", seed=5)
    load_nuwa_vae(fresh, params)
    for a, b in zip(tmodel.vae.state_dict().values(), fresh.vae.state_dict().values()):
        assert torch.equal(a, b)
    assert not torch.equal(fresh.to_logits, tmodel.to_logits)


def test_exactly_one_of_vae_and_image_size():
    with pytest.raises(ValueError):
        NUWA(vae=VQGanVAE(**VAE, device="cpu"), image_size=4, num_image_tokens=16, **CFG,
             device="cpu")
    with pytest.raises(ValueError):
        NUWA(**CFG, device="cpu")


def check_ids_loss_and_grads(jmodel, params, tmodel, video):
    """Codec ids equal; the loss from pixels and every gradient against
    jax.value_and_grad; no codec gradient in the port, zeros in JAX."""
    jvae = jmodel.vae

    def loss(p):
        return jmodel.forward(p, text=TEXT, video=video, return_loss=True, train=True)

    run = jax.jit(lambda p: (jvae.get_video_indices(p["vae"]["params"], p["vae"]["state"],
                                                    video), jax.value_and_grad(loss)(p)))
    ids, (want_loss, jgrads) = run(params)
    np.testing.assert_array_equal(
        tmodel.vae.get_video_indices(torch.from_numpy(video)).numpy(), np.asarray(ids))
    got_loss = tmodel(TEXT, video, return_loss=True, train=True, cond_dropout_prob=0.0)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=1e-5, rtol=0)
    ref = flatten_params(jax.tree.map(np.asarray, jgrads))
    names = dict(_tensors(tmodel))
    for path, r in ref.items():
        tensor = names[path][0]
        if path.startswith("vae."):
            assert tensor.grad is None and not tensor.requires_grad, path
            assert not np.any(r), path
            continue
        np.testing.assert_allclose(tensor.grad.numpy(), r, rtol=0, err_msg=path,
                                   atol=1e-4 * max(np.abs(r).max(), 1e-30))


def test_codec_ids_loss_and_grads_match_jax(pair):
    check_ids_loss_and_grads(*pair, _pixels((2, 2, 3, 8, 8), 1))


def test_loss_and_grads_past_256_tokens_a_frame():
    """A one-layer codec on 36-pixel frames: fmap 18, 324 tokens a frame,
    where the JAX package leaves its whole-frame kernels."""
    vae = dict(VAE, image_size=36)
    jmodel, params, tmodel = _models(vae=vae, seed=3)
    assert tmodel.tokens_per_frame == 324
    check_ids_loss_and_grads(jmodel, params, tmodel, _pixels((2, 2, 3, 36, 36), 2))
