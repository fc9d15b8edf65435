"""Port parity for the NUWASketch serving slice: a tiny NUWASketch in
nuwa_tpu and in nuwa_tpu_torch with the same params, plain decoder (the
reversible decoder runs the same checks in test_torch_sketch_reversible.py).

The shape of BASELINE config 4 (tests/test_baseline_configs.py:40) with a
one-layer VAE, so that frames are 4 x 4 tokens (fmap >= 4): 8-pixel frames,
a 5-channel sketch VAE, 2 video frames, 2 sketch frames, dim 16, 2 heads of
8, decoder depth 2 with Sparse3DNA and SparseCross2DNA dilations (1, 2) by
layer, token shift, a dense sketch encoder of depth 1.

fp32 on the CPU. Logits and sketch embeddings: atol 1e-4, the loss 1e-5
(sums in another order through the VAE, the encoder and two decoder
layers). Greedy ids (top-k with k = 1, so the sampling noise cannot change
the argmax and the two frameworks' random streams need not agree): equal;
the pixels decoded from them: atol 1e-5. The JAX reference is built once per
module and its entry points are jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWASketch as JNUWASketch
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import NUWASketch, VQGanVAE
from nuwa_tpu_torch.convert import _tensors, flatten_params, load_jax_params
from nuwa_tpu_torch.core.layers import Conv2d

torch.set_num_threads(1)
VAE = dict(dim=8, image_size=8, num_layers=1, vq_codebook_size=16, vq_codebook_dim=8,
           resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
           num_resnet_blocks=0)
CFG = dict(dim=16, image_size=8, max_video_frames=2, sketch_max_video_frames=2,
           sketch_enc_depth=1, sketch_enc_dim_head=8, sketch_enc_heads=2, dec_depth=2,
           dec_dim_head=8, dec_heads=2, shift_video_tokens=True, cross_2dna_kernel_size=3,
           cross_2dna_dilation=2, sparse_3dna_kernel_size=3, sparse_3dna_dilation=2)
GREEDY = 1 - 0.5 / VAE["vq_codebook_size"]  # k = max(int(0.5), 1) = 1
SKETCH_MASK = np.array([[True, True], [True, False]])  # row 1's second frame is padding


def _models(reversible):
    """The JAX model and the port's, the port's seeded weights written into
    the JAX params tree (``jax_params``, no JAX init compiled) and read
    back by ``load_jax_params``."""
    cfg = dict(CFG, dec_reversible=reversible)
    jmodel = JNUWASketch(vae=JVQGanVAE(**VAE), sketch_vae=JVQGanVAE(**VAE, channels=5), **cfg)
    tmodel = _port(cfg)
    params = jax_params(jmodel, tmodel)
    return jmodel, params, load_jax_params(tmodel, params)


def _port(cfg):
    return NUWASketch(vae=VQGanVAE(**VAE, device="cpu"),
                      sketch_vae=VQGanVAE(**VAE, channels=5, device="cpu"),
                      **cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _models(reversible=False)


def _pixels(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


SKETCH = _pixels((2, 2, 5, 8, 8), 1)
VIDEO = _pixels((2, 2, 3, 8, 8), 2)


def check_convert_uses_every_leaf_once(pair):
    _, params, tmodel = pair
    n = len(list(tmodel.parameters())) + len(list(tmodel.buffers()))
    assert len(flatten_params(params)) == n


@torch.no_grad()
def check_embed_sketch_matches_jax(pair):
    jmodel, params, tmodel = pair
    want = jax.jit(lambda p, s, m: jmodel.embed_sketch(p, s, m))(params, SKETCH, SKETCH_MASK)
    got = tmodel.embed_sketch(SKETCH, SKETCH_MASK)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def check_forward_logits_and_loss_match_jax(pair, frames):
    """Two sketch frames with a padded one in row 1, or one sketch frame
    given as (b, c, h, w)."""
    jmodel, params, tmodel = pair
    sketch = SKETCH if frames == 2 else SKETCH[:, 0]
    mask = SKETCH_MASK if frames == 2 else None
    fwd = jax.jit(lambda p, s, v, m: (
        jmodel.forward(p, sketch=s, video=v, sketch_mask=m),
        jmodel.forward(p, sketch=s, video=v, sketch_mask=m, return_loss=True),
    ))
    want, want_loss = fwd(params, sketch, VIDEO, mask)
    with torch.no_grad():
        got = tmodel(sketch, VIDEO, sketch_mask=mask).numpy()
        got_loss = tmodel(sketch, VIDEO, sketch_mask=mask, return_loss=True).item()
    assert got.shape == want.shape == (2, 2 * 16 + 1, 16)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_loss, float(want_loss), atol=1e-5, rtol=0)


def check_generate_ids_and_pixels_match_jax(pair):
    """Greedy cached generate with CFG: ids equal, the decoded video within
    1e-5."""
    jmodel, params, tmodel = pair
    kw = dict(filter_thres=GREEDY, cond_scale=2.0, num_frames=2)
    want = jmodel.generate(params, sketch=SKETCH, key=jax.random.PRNGKey(5),
                           sketch_mask=jnp.asarray(SKETCH_MASK), decode_video=False, **kw)
    video = tmodel.generate(SKETCH, sketch_mask=SKETCH_MASK, **kw)
    ids = tmodel.generate(SKETCH, sketch_mask=SKETCH_MASK, decode_video=False, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    pixels = jax.jit(lambda p, s, i: jmodel.vae.codebook_indices_to_video(p, s, i))(
        params["vae"]["params"], params["vae"]["state"], want)
    assert video.shape == (2, 2, 3, 8, 8)
    np.testing.assert_allclose(video.numpy(), np.asarray(pixels), atol=1e-5, rtol=0)


def check_generate_long_ids_match_jax(pair):
    """Greedy sliding-window rollout one frame past the window, CFG on,
    one sketch frame: the frame after the window comes from a prefill and
    cached steps."""
    jmodel, params, tmodel = pair
    kw = dict(filter_thres=GREEDY, cond_scale=2.0, num_frames=3)
    want = jmodel.generate_long(params, sketch=SKETCH[:1, :1], key=jax.random.PRNGKey(6),
                                decode_video=False, **kw)
    got = tmodel.generate_long(SKETCH[:1, :1], decode_video=False, **kw)
    assert got.shape == (1, 3 * 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_uses_every_leaf_once(pair):
    check_convert_uses_every_leaf_once(pair)


def test_embed_sketch_matches_jax(pair):
    check_embed_sketch_matches_jax(pair)


@pytest.mark.parametrize("frames", [2, 1])
def test_forward_logits_and_loss_match_jax(pair, frames):
    check_forward_logits_and_loss_match_jax(pair, frames)


def test_generate_ids_and_pixels_match_jax(pair):
    check_generate_ids_and_pixels_match_jax(pair)


def test_generate_long_ids_match_jax(pair):
    check_generate_long_ids_match_jax(pair)


def jax_params(jmodel, tmodel):
    """The port's weights as the JAX model's params tree, whose shape
    ``jax.eval_shape`` gives without compiling the JAX init; the JAX model
    (a NUWA or a NUWASketch) takes the params and state of each of its
    codecs."""
    key = jax.random.PRNGKey(0)

    def init():  # traced only: the codecs' inits give shapes, not values
        codecs = {}
        for name in ("vae", "sketch_vae"):
            vae = getattr(jmodel, name, None)
            if vae is not None:
                codecs.update({f"{name}_params": vae.init(key),
                               f"{name}_state": vae.init_state(key)})
        return jmodel.init(key, **codecs)

    shapes = jax.eval_shape(init)
    tensors = _tensors(tmodel)

    def leaf(path, shape):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        tensor, owner, attr = tensors[name]
        value = tensor.detach().numpy()
        if isinstance(owner, Conv2d) and attr == "w":
            value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        assert value.shape == shape.shape, name
        return value.astype(shape.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@torch.no_grad()
def test_unported_options_raise():
    """``sketch_enc_use_sparse_3dna``, the centered Sparse3DNA encoder
    (depth 2, dilations 1 and 2, token shift on the sketch grid), gives
    JAX's sketch embeddings and forward logits (atol 1e-4), its params tree
    loading every leaf once. ``method="full"`` raises."""
    cfg = dict(CFG, sketch_enc_use_sparse_3dna=True, sketch_enc_depth=2)
    jmodel = JNUWASketch(vae=JVQGanVAE(**VAE), sketch_vae=JVQGanVAE(**VAE, channels=5), **cfg)
    tmodel = _port(cfg)
    params = jax_params(jmodel, tmodel)
    load_jax_params(tmodel, params)
    check_convert_uses_every_leaf_once((jmodel, params, tmodel))
    run = jax.jit(lambda p, s, v, m: (jmodel.embed_sketch(p, s, m)[0],
                                      jmodel.forward(p, sketch=s, video=v, sketch_mask=m)))
    want_embeds, want = run(params, SKETCH, VIDEO, SKETCH_MASK)
    np.testing.assert_allclose(tmodel.embed_sketch(SKETCH, SKETCH_MASK)[0].numpy(),
                               np.asarray(want_embeds), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tmodel(SKETCH, VIDEO, sketch_mask=SKETCH_MASK).numpy(),
                               np.asarray(want), atol=1e-4, rtol=0)
    for call in (tmodel.generate, tmodel.generate_long):
        with pytest.raises(NotImplementedError):
            call(SKETCH, method="full", num_frames=3)
