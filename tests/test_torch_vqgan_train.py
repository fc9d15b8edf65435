"""Port parity: the codec's training half (``VQGanVAE.forward`` in every
mode, the GAN losses, the gradient penalty, the adaptive weight, the
discriminator and the perceptual net) against nuwa_tpu's, fp32 on the CPU.

The port's seeded weights (the codec's and ``gan_parts()``'s) are written
into the JAX params tree that ``jax.eval_shape`` of the JAX init gives, so
no JAX init is compiled. Tolerances: losses within 1e-5 relative; every
gradient within 1e-4 of its leaf's max abs (or of 1e-3 of the largest,
for a leaf that is zero but for rounding); the codebook state after the update within
1e-5; VGG features within 1e-5 of their max abs; bf16 compute within the
JAX package's own test tolerance, 5e-2 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu import perceptual as jperc
from nuwa_tpu import vqgan_vae as jvq
from nuwa_tpu_torch import VQGanVAE
from nuwa_tpu_torch import perceptual as tperc
from nuwa_tpu_torch import vqgan_vae as tvq
from nuwa_tpu_torch.convert import _tensors, export_jax_params, jax_layout, load_vqgan_vae_train
from nuwa_tpu_torch.core.layers import Conv2d

torch.set_num_threads(1)
RTOL, GRAD_TOL = 1e-5, 1e-4
TINY = dict(dim=8, image_size=16, num_layers=2, num_resnet_blocks=(0, 1),
            use_attn=(False, True), attn_heads=2, attn_dim_head=4, resnet_groups=4,
            vq_codebook_size=16, vq_codebook_dim=4, vq_kmeans_init=False)
CASES = {
    "hinge_no_perceptual": dict(perceptual="none"),
    "bce_l2_no_perceptual": dict(perceptual="none", use_hinge_loss=False, l2_recon_loss=True),
    "random_vgg": dict(perceptual="random_vgg", image_size=32),
    "vgg": dict(perceptual="vgg", image_size=32, use_hinge_loss=False),
    "grayscale_random_vgg": dict(perceptual="random_vgg", image_size=32, channels=1),
    "no_gan": dict(use_vgg_and_gan=False),
}


def jax_tree(jvae, tvae, gan):
    """(params, state) of the JAX codec holding the port's weights."""
    shapes = jax.eval_shape(lambda: jvae.init(jax.random.PRNGKey(0)))
    ours = {k[len("params."):]: v for k, v in export_jax_params(tvae).items()
            if k.startswith("params.")}
    if gan is not None:
        ours.update(export_jax_params(gan))

    def leaf(path, shape):
        value = ours.pop(".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                  for k in path)).numpy()
        assert value.shape == shape.shape
        return value

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    assert not ours, sorted(ours)
    return params, _state(tvae)


def _state(tvae):
    return {"vq": {k: v.numpy().copy() for k, v in tvae.vq.named_buffers()}}


def _models(seed=0, **over):
    cfg = dict(TINY, **over)
    jvae = jvq.VQGanVAE(**cfg)
    tvae = VQGanVAE(**cfg, device="cpu", seed=seed)
    gan = tvae.gan_parts(seed=seed + 1)
    params, state = jax_tree(jvae, tvae, gan)
    return jvae, params, state, tvae, gan


def _images(cfg, b=2, seed=3):
    c, s = cfg.get("channels", 3), cfg["image_size"]
    return np.random.default_rng(seed).uniform(0, 1, (b, c, s, s)).astype(np.float32)


def _grads(tvae, gan):
    """{JAX params path: port gradient in the JAX layout}, zero where none."""
    out = {}
    for module, prefix in ((tvae, ""), (gan, "params.")):
        if module is None:
            continue
        for path, (t, owner, leaf) in _tensors(module).items():
            if isinstance(t, torch.nn.Parameter):
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                out[(prefix + path)[len("params."):]] = jax_layout(owner, leaf, g).numpy()
    return out


def _check_grads(got, want_tree):
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
    assert set(got) == set(want)
    # a leaf whose gradient is zero but for rounding (the position bias's
    # last bias, which the softmax cancels) is held at the tree's scale
    floor = 1e-3 * max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(got[name], g, atol=GRAD_TOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_generator_loss_gradients_and_codebook_match_jax(case):
    """``return_loss``: the loss, every gradient (codec, quantizer
    projection, discriminator, VGG) and the updated codebook state."""
    jvae, params, state, tvae, gan = _models(**CASES[case])
    img = _images(dict(TINY, **CASES[case]))

    def loss_fn(p):
        loss, new = jvae.forward(p, state, img, return_loss=True)
        return loss, new

    (want, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss = tvae(torch.from_numpy(img), gan=gan, return_loss=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL, atol=0)
    _check_grads(_grads(tvae, gan), grads)
    for name, value in _state(tvae)["vq"].items():
        np.testing.assert_allclose(value, np.asarray(new["vq"][name]), atol=1e-5, rtol=0)
    if gan is not None and case != "hinge_no_perceptual" and "perceptual" in CASES[case]:
        assert any(g.abs().sum() > 0 for g in gan.discr.parameters() if g.grad is not None)


@pytest.fixture(scope="module")
def tiny_gan():
    return _models(perceptual="none")


@pytest.mark.parametrize("hinge", [True, False], ids=["hinge", "bce"])
@pytest.mark.parametrize("gp", [False, True], ids=["plain", "grad_penalty"])
def test_discriminator_loss_and_gradients_match_jax(tiny_gan, hinge, gp):
    """``return_discr_loss`` with and without the gradient penalty: the
    loss, every discriminator gradient, and none for the codec (its
    reconstruction is held constant)."""
    jvae, params, state, tvae, gan = tiny_gan
    jvae = jvq.VQGanVAE(**dict(TINY, perceptual="none", use_hinge_loss=hinge))
    tvae.use_hinge_loss = hinge
    img = _images(TINY, seed=4)
    want, grads = jax.value_and_grad(
        lambda p: jvae.forward(p, state, img, return_discr_loss=True, apply_grad_penalty=gp)
    )(params)
    tvae.zero_grad(set_to_none=True)
    gan.zero_grad(set_to_none=True)
    loss = tvae(torch.from_numpy(img), gan=gan, return_discr_loss=True, apply_grad_penalty=gp)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL, atol=0)
    assert all(p.grad is None for p in tvae.parameters())
    _check_grads(_grads(tvae, gan), grads)
    assert all(np.abs(np.asarray(g)).max() == 0 for g in jax.tree.leaves(grads["dec"]))
    tvae.use_hinge_loss = True


def test_reconstruction_modes_match_jax(tiny_gan):
    jvae, params, state, tvae, gan = tiny_gan
    img = _images(TINY, seed=5)
    with torch.no_grad():
        recon = tvae(torch.from_numpy(img))
        loss, recon2 = tvae(torch.from_numpy(img), gan=gan, return_discr_loss=True,
                            return_recons=True)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jvae.forward(params, state, img)),
                               atol=1e-5, rtol=0)
    assert torch.equal(recon, recon2) and recon.dtype == torch.float32
    buffers = _state(tvae)
    tvae(torch.from_numpy(img), return_loss=True, update_vq=False)
    assert all(np.array_equal(v, buffers["vq"][k]) for k, v in _state(tvae)["vq"].items())


def test_adaptive_weight_matches_jax_formula():
    """The weight itself: the two gradient norms through the last conv's
    weight alone, as the JAX package forms them, and its cap."""
    jvae, params, state, tvae, gan = _models(perceptual="random_vgg", image_size=32)
    img = _images(dict(TINY, image_size=32), seed=6)
    x = jnp.asarray(img.transpose(0, 2, 3, 1))
    quant = jvae.vq(params["vq"], state["vq"], jvae._encode_fmap(params, x))[0]
    trunk = jvae._decode_trunk(params, quant)

    def head(w, fn):
        return fn(jvae._decode_head(w, trunk).astype(jnp.float32))

    vgg = jperc.VGG16Features()
    g_perc = jax.grad(head)(params["dec"]["last"], lambda r: jperc.random_perceptual_loss(
        params["vgg"], vgg, x, r))["w"]
    g_gen = jax.grad(head)(params["dec"]["last"], lambda r: jvq.hinge_gen_loss(
        jvae.discriminator(params["discr"], r)))["w"]
    want = float(jnp.linalg.norm(g_perc) / (jnp.linalg.norm(g_gen) + 1e-6))
    with torch.no_grad():
        tq = tvae._quantize(torch.from_numpy(img), False, None)[0]
        ttrunk = tvae._decode_trunk(tq)
    got = tvae._adaptive_weight(gan, torch.from_numpy(img), ttrunk, tvq.hinge_gen_loss)
    assert got.item() == pytest.approx(want, rel=1e-4)
    tvae.adaptive_weight_cap = want / 2
    assert tvae._adaptive_weight(gan, torch.from_numpy(img), ttrunk,
                                 tvq.hinge_gen_loss).item() == pytest.approx(want / 2)


def test_bf16_compute_dtype_within_jax_tolerance():
    """compute_dtype="bfloat16": the generator and discriminator (with the
    penalty) losses within the JAX test's 5e-2 of JAX's bf16 losses, fp32
    gradients."""
    over = dict(perceptual="none", compute_dtype="bfloat16")
    jvae, params, state, tvae, gan = _models(**over)
    img = _images(TINY, seed=7)
    want = float(jvae.forward(params, state, img, return_loss=True)[0])
    loss = tvae(torch.from_numpy(img), gan=gan, return_loss=True)
    np.testing.assert_allclose(loss.item(), want, rtol=5e-2)
    loss.backward()
    assert all(p.grad.dtype == torch.float32 for p in tvae.parameters() if p.grad is not None)
    state = _state(tvae)
    want = float(jvae.forward(params, state, img, return_discr_loss=True,
                              apply_grad_penalty=True))
    got = tvae(torch.from_numpy(img), gan=gan, return_discr_loss=True, apply_grad_penalty=True)
    np.testing.assert_allclose(got.item(), want, rtol=5e-2)
    assert tvae(torch.from_numpy(img)).dtype == torch.float32


def test_gradient_penalty_and_gan_losses_match_jax(b=3):
    jd = jvq.Discriminator(dims=(4, 8), channels=3, groups=2)
    td = tvq.Discriminator((4, 8), channels=3, groups=2)
    from nuwa_tpu_torch.core.layers import init_weights_

    init_weights_(td, 5)
    p = {k: v.numpy() for k, v in export_jax_params(td).items()}
    p = jax.tree_util.tree_map_with_path(
        lambda path, s: p[".".join(str(getattr(k, "key", k)) for k in path)],
        jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0))))
    x = np.random.default_rng(b).standard_normal((b, 3, 16, 16)).astype(np.float32)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    logits = td(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jd(p, xh)), atol=1e-5, rtol=0)
    want, grads = jax.value_and_grad(
        lambda p: jvq.gradient_penalty(xh, lambda im: jd(p, im)))(p)
    gp = tvq.gradient_penalty(torch.from_numpy(x), td)
    gp.backward()
    np.testing.assert_allclose(gp.item(), float(want), rtol=RTOL)
    _check_grads({k: jax_layout(o, l, t.grad if t.grad is not None else torch.zeros_like(t))
                  .numpy() for k, (t, o, l) in _tensors(td).items()}, grads)
    fake, real = logits.detach(), -logits.detach() + 0.3
    for tf, jf in ((tvq.hinge_gen_loss, jvq.hinge_gen_loss), (tvq.bce_gen_loss, jvq.bce_gen_loss)):
        assert tf(fake).item() == pytest.approx(float(jf(jnp.asarray(fake.numpy()))), rel=1e-6)
    for tf, jf in ((tvq.hinge_discr_loss, jvq.hinge_discr_loss),
                   (tvq.bce_discr_loss, jvq.bce_discr_loss)):
        want = float(jf(jnp.asarray(fake.numpy()), jnp.asarray(real.numpy())))
        assert tf(fake, real).item() == pytest.approx(want, rel=1e-6)


def _torchvision_state(seed=0):
    """A torchvision-layout vgg16 state dict of random numpy weights."""
    rng = np.random.default_rng(seed)
    out, cin, k = {}, 3, 0
    for spec in tperc._VGG16_PLAN:
        if spec == "M":
            k += 1
            continue
        out[f"features.{k}.weight"] = rng.standard_normal((spec, cin, 3, 3)).astype(
            np.float32) * np.sqrt(2.0 / (9 * cin))
        out[f"features.{k}.bias"] = rng.standard_normal(spec).astype(np.float32) * 0.01
        cin, k = spec, k + 2
    for j, (din, dout) in ((0, (25088, 4096)), (3, (4096, 4096)), (6, (4096, 1000))):
        out[f"classifier.{j}.weight"] = (rng.standard_normal((dout, din)) / np.sqrt(din)).astype(
            np.float32)
        out[f"classifier.{j}.bias"] = np.zeros(dout, np.float32)
    return out


@pytest.fixture(scope="module")
def vgg_pair():
    sd = _torchvision_state()
    tv = tperc.VGG16Features()
    tv.load_state_dict(tperc.load_torch_vgg16_state_dict(sd))
    return jperc.VGG16Features(), jperc.load_torch_vgg16_state_dict(sd), tv


@pytest.mark.parametrize("size", [64, 256], ids=["grow_2_to_7", "shrink_8_to_7"])
def test_vgg16_features_at_both_resize_directions(vgg_pair, size):
    """The fc features through the 7 x 7 pool: grown from 2 x 2 at 64 px (no
    anti-aliasing), shrunk from 8 x 8 at 256 px (anti-aliased), weights
    from one torchvision-layout state dict through each package's loader."""
    jv, jp, tv = vgg_pair
    x = np.random.default_rng(size).uniform(0, 1, (1, 3, size, size)).astype(np.float32)
    want = np.asarray(jv(jp, jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = tv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 4096)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_vgg16_multiscale_features_and_random_perceptual_loss(vgg_pair):
    jv, jp, tv = vgg_pair
    rng = np.random.default_rng(9)
    a, b = (rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32) for _ in range(2))
    ja, jb = (jnp.asarray(t.transpose(0, 2, 3, 1)) for t in (a, b))
    with torch.no_grad():
        feats = tv.features_multiscale(torch.from_numpy(a))
        got = tperc.random_perceptual_loss(tv, torch.from_numpy(a), torch.from_numpy(b))
    for f, w in zip(feats, jv.features_multiscale(jp, ja)):
        np.testing.assert_allclose(f.numpy().transpose(0, 2, 3, 1), np.asarray(w),
                                   atol=1e-5 * float(jnp.abs(w).max()), rtol=0)
    assert len(feats) == 5
    want = float(jperc.random_perceptual_loss(jp, jv, ja, jb))
    assert got.item() == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("size_in", [1, 2, 3, 8, 9, 14])
def test_resize_linear_matches_jax_image_resize(size_in):
    x = np.random.default_rng(size_in).standard_normal((2, 3, size_in, size_in + 1)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 7, 7), method="linear"))
    got = tperc.resize_linear(torch.from_numpy(x), 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_attention_dropout_is_the_dense_dropout():
    """``VQGanAttention(dropout=...)``: no seed (the codec passes none, as the
    JAX codec passes no key) or rate 0 drops nothing; a seed drops about the
    rate's share of the attention weights. A codec with attn_dropout gives
    the JAX codec's loss."""
    attn = tvq.VQGanAttention(8, dim_head=4, heads=2, dropout=0.5)
    from nuwa_tpu_torch.core.layers import init_weights_

    init_weights_(attn, 0)
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    seen = []
    orig = tvq.dropout
    tvq.dropout = lambda a, rate, seed: seen.append(orig(a, rate, seed)) or seen[-1]
    try:
        out = attn(x)
        dropped = attn(x, seed=7)
    finally:
        tvq.dropout = orig
    assert (seen[0] > 0).all()  # no seed: the softmax as it is
    share = (seen[1] == 0).float().mean().item()
    assert abs(share - 0.5) < 4 * np.sqrt(0.25 / seen[1].numel())
    assert not torch.equal(out, dropped)
    attn.dropout = 0.0
    assert torch.equal(attn(x, seed=7), out)
    jvae, params, state, tvae, gan = _models(perceptual="none", attn_dropout=0.1)
    img = _images(TINY, seed=8)
    want = float(jvae.forward(params, state, img, return_loss=True)[0])
    assert tvae(torch.from_numpy(img), gan=gan, return_loss=True).item() == pytest.approx(
        want, rel=RTOL)


def test_codec_holds_no_gan_whatever_use_vgg_and_gan():
    """The models embed codecs with use_vgg_and_gan=True (the default): the
    codec's tree is the JAX eval_params, the same as with it off."""
    on = VQGanVAE(**TINY, device="cpu")
    off = VQGanVAE(**dict(TINY, use_vgg_and_gan=False), device="cpu")
    assert list(export_jax_params(on)) == list(export_jax_params(off))
    assert not any(k.startswith(("params.discr", "params.vgg")) for k in export_jax_params(on))
    assert off.gan_parts() is None
    assert on.gan_parts().vgg is not None
    assert VQGanVAE(**dict(TINY, perceptual="none"), device="cpu").gan_parts().vgg is None
    assert set(on.eval_params()) == {n for n, _ in on.named_parameters()}


def test_forward_refuses_bad_calls(tiny_gan):
    _, _, _, tvae, gan = tiny_gan
    img = torch.from_numpy(_images(TINY))
    with pytest.raises(ValueError, match="discriminator"):
        tvae(img, return_discr_loss=True)
    with pytest.raises(ValueError, match="exclude"):
        tvae(img, gan=gan, return_loss=True, return_discr_loss=True)
    with pytest.raises(ValueError, match="expected"):
        tvae(img[:, :, :8, :8])
    with pytest.raises(ValueError, match="perceptual"):
        VQGanVAE(**dict(TINY, perceptual="lpips"), device="cpu")


def test_convert_loads_the_training_codec_and_uses_every_leaf(tiny_gan):
    jvae, params, state, tvae, gan = tiny_gan
    fresh = VQGanVAE(**dict(TINY, perceptual="none"), device="cpu", seed=9)
    fresh_gan = fresh.gan_parts(seed=9)
    load_vqgan_vae_train(fresh, fresh_gan, params, state)
    for a, b in zip(list(fresh.parameters()) + list(fresh_gan.parameters()),
                    list(tvae.parameters()) + list(gan.parameters())):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unused"):
        load_vqgan_vae_train(fresh, fresh_gan, dict(params, vgg={"w": np.zeros(2)}), state)
    with pytest.raises(ValueError, match="missing"):
        load_vqgan_vae_train(fresh, fresh_gan, {k: v for k, v in params.items()
                                                if k != "discr"}, state)
    assert isinstance(fresh_gan.discr.first, Conv2d)
