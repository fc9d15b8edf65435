"""Port parity: nuwa_tpu_torch's VQGanVAE inference path (encode, the vector
quantizer, decode, codebook_indices_to_video) against nuwa_tpu's, and the
codec's leaf layers.

fp32 on the CPU, the same numpy inputs, the JAX-initialised params and state
loaded through ``convert.load_vqgan_vae``. A tiny VAE with everything on (a
res block and attention in both layers, GroupNorm, a codebook projection),
with cosine and with euclidean codes; and BASELINE config 1 at its full
size. Tolerances: feature maps, pixels and the commit loss within 1e-5
absolute (sums in another order through a few convolutions); indices equal.
The JAX references are jitted once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.core import layers as jl
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import VQGanVAE
from nuwa_tpu_torch.convert import load_vqgan_vae
from nuwa_tpu_torch.core import layers as tl

torch.set_num_threads(1)
ATOL = 1e-5
TINY = dict(
    dim=8, image_size=16, num_layers=2, num_resnet_blocks=(1, 1), use_attn=(True, True),
    attn_heads=2, attn_dim_head=4, resnet_groups=4, vq_codebook_size=16,
    vq_codebook_dim=4, vq_kmeans_init=False, use_vgg_and_gan=False,
)
# BASELINE.json config 1 (tests/test_baseline_configs.py:23)
BASELINE1 = dict(
    dim=64, image_size=64, num_layers=2, vq_codebook_size=512, use_vgg_and_gan=False,
    vq_kmeans_init=True, resnet_groups=16, use_attn=False, num_resnet_blocks=1,
)


def _pair(cfg, seed=0):
    jvae = JVQGanVAE(**cfg)
    params = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(seed)))
    state = jax.tree.map(np.asarray, jvae.init_state(jax.random.PRNGKey(seed + 1)))
    tvae = load_vqgan_vae(VQGanVAE(**cfg, device="cpu"), params, state)
    enc = jax.jit(lambda p, s, x: jvae.encode(p, s, x)[:3])
    dec = jax.jit(jvae.decode)
    to_video = jax.jit(lambda p, s, i: jvae.codebook_indices_to_video(p, s, i, decode_chunks=2))
    return (enc, dec, to_video), params, state, tvae


@pytest.fixture(scope="module", params=[True, False], ids=["cosine", "euclidean"])
def tiny(request):
    return _pair(dict(TINY, vq_use_cosine_sim=request.param))


def _images(b, cfg, seed=2):
    shape = (b, 3, cfg["image_size"], cfg["image_size"])
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@torch.no_grad()
def test_encode_matches_jax(tiny):
    (enc, _, _), params, state, tvae = tiny
    img = _images(3, TINY)
    want = [np.asarray(x) for x in enc(params, state, img)]
    fmap, indices, commit = tvae.encode(torch.from_numpy(img))
    assert fmap.shape == want[0].shape == (3, 16, 4, 4)
    np.testing.assert_allclose(fmap.numpy(), want[0], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(indices.numpy(), want[1])
    np.testing.assert_allclose(commit.item(), float(want[2]), atol=ATOL, rtol=0)


@torch.no_grad()
def test_decode_and_indices_to_video_match_jax(tiny):
    (enc, dec, to_video), params, state, tvae = tiny
    fmap = np.random.default_rng(3).standard_normal((2, 16, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(tvae.decode(torch.from_numpy(fmap)).numpy(),
                               np.asarray(dec(params, fmap)), atol=ATOL, rtol=0)
    ids = np.random.default_rng(4).integers(0, 16, (2, 3 * 16)).astype(np.int32)
    got = tvae.codebook_indices_to_video(torch.from_numpy(ids).long(), decode_chunks=2)
    want = np.asarray(to_video(params, state, ids))
    assert got.shape == want.shape == (2, 3, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@torch.no_grad()
def test_get_video_indices_match_jax(tiny):
    (enc, _, _), params, state, tvae = tiny
    video = _images(4, TINY, seed=5).reshape(2, 2, 3, 16, 16)
    want = np.asarray(enc(params, state, video.reshape(4, 3, 16, 16))[1]).reshape(2, 2, -1)
    np.testing.assert_array_equal(tvae.get_video_indices(torch.from_numpy(video)).numpy(), want)


@torch.no_grad()
def test_baseline_config1_encodes_and_decodes_as_jax():
    (enc, dec, _), params, state, tvae = _pair(BASELINE1)
    img = _images(1, BASELINE1, seed=6)
    fmap, indices, commit = tvae.encode(torch.from_numpy(img))
    want = [np.asarray(x) for x in enc(params, state, img)]
    assert indices.shape == (1, 16 * 16)
    np.testing.assert_allclose(fmap.numpy(), want[0], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(indices.numpy(), want[1])
    np.testing.assert_allclose(commit.item(), float(want[2]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tvae.decode(fmap).numpy(), np.asarray(dec(params, want[0])),
                               atol=ATOL, rtol=0)


def test_convert_uses_every_leaf_of_params_and_state(tiny):
    _, params, state, _ = tiny
    with pytest.raises(ValueError, match="missing"):
        load_vqgan_vae(VQGanVAE(**TINY, device="cpu"), params,
                       {"vq": {k: v for k, v in state["vq"].items() if k != "embed"}})
    with pytest.raises(ValueError, match="unused"):
        load_vqgan_vae(VQGanVAE(**TINY, device="cpu"), dict(params, spare=np.zeros(2)), state)


def test_upsample_bilinear_matches_jax_resize_at_the_borders():
    """jax.image.resize's bilinear upsample (half-pixel centres, weights
    renormalised at the edge) against F.interpolate(align_corners=False),
    on a map with odd sides, borders included."""
    x = np.random.default_rng(7).standard_normal((2, 3, 5, 7)).astype(np.float32)
    want = np.asarray(jl.upsample_nearest_or_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = tl.upsample_bilinear(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()


@pytest.mark.parametrize("stride,padding", [((1, 1), "SAME"), ((2, 2), ((1, 1), (1, 1))),
                                            ((1, 1), ((0, 1), (1, 0))), ((2, 2), "SAME")])
def test_conv_norms_and_leaky_relu_match_jax(stride, padding):
    """Conv2d (HWIO weights loaded as OIHW), GroupNorm, LayerNormChan and the
    0.1-slope leaky ReLU, each against the JAX layer on the same input."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 9, 9)).astype(np.float32)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    jconv = jl.Conv2d(8, 4, (4, 4) if stride == (2, 2) else (3, 3), stride=stride,
                      padding=padding)
    p = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(9)))
    tconv = tl.Conv2d(8, 4, jconv.kernel_size, stride=stride, padding=padding)
    from nuwa_tpu_torch.convert import load_jax_params

    load_jax_params(tconv, p)
    want = np.asarray(jconv(p, xh))
    got = tconv(torch.from_numpy(x)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for jmod, tmod in ((jl.GroupNorm(8, 4), tl.GroupNorm(8, 4)),
                       (jl.LayerNormChan(8), tl.LayerNormChan(8))):
        pn = {"g": rng.standard_normal(8).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
        load_jax_params(tmod, pn)
        want = np.asarray(jmod(pn, xh))
        got = tmod(torch.from_numpy(x)).detach().numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.leaky_relu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.leaky_relu(jnp.asarray(x))), atol=0, rtol=0)
