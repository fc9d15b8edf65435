"""Port parity for NUWAVideoAudio serving: the model in nuwa_tpu and in
nuwa_tpu_torch with the same weights (the port's, seeded, written into the
JAX params tree that ``jax.eval_shape`` of the JAX init gives:
test_torch_sketch.jax_params), fp32 on the CPU.

The size of tests/test_decode_va.py: a two-layer codec on 8-pixel frames
(fmap 2), dim 16, 2 heads of 8, 2 frames, 3 audio tokens a frame out of 12,
a text encoder of depth 1, a decoder of depth 2 with cross-modality
attention every 2 depths, SparseCausal2DNA kernel 3. Two configurations:
  * H = 1 (one audio token a timestep), the plain decoder, no rel-pos bias;
  * H = 2 (a ragged last timestep in every frame), the reversible decoder,
    both rel-pos biases, Sparse3DNA dilations (1, 2).
Checks: the logits and the loss within 1e-5, from token ids and from pixels
through the codec. Sampling: test_torch_video_audio_sample.py, with the same
models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWAVideoAudio as JNUWAVideoAudio
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE
from test_torch_sketch import jax_params

torch.set_num_threads(1)
VAE = dict(dim=8, image_size=8, num_layers=2, vq_codebook_size=16, vq_codebook_dim=8,
           resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
           num_resnet_blocks=0)
CFG = dict(dim=16, image_size=8, num_audio_tokens=12, num_audio_tokens_per_video_frame=3,
           max_video_frames=2, text_num_tokens=32, text_enc_depth=1, text_enc_dim_head=8,
           text_enc_heads=2, dec_depth=2, dec_dim_head=8, dec_heads=2,
           cross_modality_attn_every=2, sparse_2dna_kernel_size=3)
CONFIGS = {
    "h1": dict(audio_tokens_per_timestep=1, dec_reversible=False,
               sparse_3dna_rel_pos_bias=False, sparse_2dna_rel_pos_bias=False),
    "h2": dict(audio_tokens_per_timestep=2, dec_reversible=True, sparse_3dna_dilation=(1, 2)),
}
TEXT = np.array([[1, 2, 3, 0], [5, 6, 0, 0]])


def _models(name, seed=0):
    cfg = dict(CFG, **CONFIGS[name])
    tmodel = NUWAVideoAudio(vae=VQGanVAE(**VAE, device="cpu", seed=seed + 1), **cfg,
                            device="cpu", seed=seed)
    jmodel = JNUWAVideoAudio(vae=JVQGanVAE(**VAE), **cfg)
    return jmodel, jax_params(jmodel, tmodel), tmodel


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _models(request.param)


def _pixels(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


VIDEO = _pixels((2, 2, 3, 8, 8), 1)
AUDIO = np.random.default_rng(2).integers(0, 12, (2, 6))


def test_logits_and_loss_match_jax_from_ids_and_pixels(pair):
    jmodel, params, tmodel = pair
    ids = np.asarray(jax.jit(lambda p, v: jmodel.vae.get_video_indices(
        p["vae"]["params"], p["vae"]["state"], v))(params, VIDEO)).reshape(2, -1)
    fwd = jax.jit(lambda p, v, a: (jmodel.forward(p, text=TEXT, video=v, audio=a),
                                   jmodel.forward(p, text=TEXT, video=v, audio=a,
                                                  return_loss=True)))
    for video in (ids, VIDEO):
        (want_v, want_a), want_loss = fwd(params, video, AUDIO)
        with torch.no_grad():
            got_v, got_a = tmodel(TEXT, video, AUDIO)
            got_loss = tmodel(TEXT, video, AUDIO, return_loss=True).item()
        assert got_v.shape == want_v.shape == (2, 2 * 4 + 1, 16)
        assert got_a.shape == want_a.shape == (2, 6 + 1, 12)
        for got, want in ((got_v, want_v), (got_a, want_a)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got_loss, float(want_loss), atol=1e-5, rtol=0)
