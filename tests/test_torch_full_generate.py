"""Port parity for ``method="full"``, the per-token re-forward that the JAX
package keeps as the oracle of every cached decoder: greedy ``generate``
and ``generate_long`` of NUWA, NUWASketch and NUWAVideoAudio (H = 1 and
H = 4) against the JAX models' ``method="full"`` with the same weights, fp32
on the CPU, classifier-free guidance 2.0; and, in the port, full equal to
cached where the JAX package holds them equal (tests/test_decode.py:111,
test_decode_sketch.py:36, test_decode_va.py:38, test_generate_long.py:48).

Greedy: top-k with k = 1, so the two frameworks' random streams need not
agree. Ids: equal. The JAX models' weights are the port's, seeded
(test_torch_sketch.jax_params), so no JAX init is compiled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sketch as sketch_base
import test_torch_video_audio as va_base
from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.models import NUWAVideoAudio as JNUWAVideoAudio
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import NUWA, NUWAVideoAudio, VQGanVAE
from test_torch_sketch import jax_params

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
# tests/test_generate_long.py:38's NUWA: fmap 2, 2 frames, depth 2, token
# shift, rel-pos bias, dilations (1, 2)
NUWA_CFG = dict(dim=16, image_size=2, num_image_tokens=16, max_video_frames=2,
                text_num_tokens=32, text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2,
                dec_depth=2, dec_dim_head=8, dec_heads=2, shift_video_tokens=True,
                sparse_3dna_rel_pos_bias=True, sparse_3dna_dilation=(1, 2),
                sparse_3dna_kernel_size=3)
TEXT = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)


def greedy(vocab):
    return 1 - 0.5 / vocab  # top-k keeps k = max(int(0.5), 1) = 1


@pytest.fixture(scope="module")
def nuwa():
    tmodel = NUWA(**NUWA_CFG, device="cpu", seed=3)
    jmodel = JNUWA(**NUWA_CFG)
    return jmodel, jax_params(jmodel, tmodel), tmodel


def test_nuwa_full_generate_and_generate_long_match_jax(nuwa):
    """generate (2 frames) and generate_long (4 frames on a 2-frame window,
    two full re-forwards of the window a token) by method="full"."""
    jmodel, params, tmodel = nuwa
    kw = dict(filter_thres=greedy(16), cond_scale=2.0, decode_video=False)
    want = jmodel.generate(params, text=jnp.asarray(TEXT), key=KEY, method="full", **kw)
    got = tmodel.generate(TEXT, method="full", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jmodel.generate_long(params, text=jnp.asarray(TEXT), key=KEY, num_frames=4,
                                method="full", **kw)
    got = tmodel.generate_long(TEXT, num_frames=4, method="full", **kw)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_nuwa_full_equals_cached(nuwa, cond_scale):
    """In the port, full and cached give the same greedy ids, the sliding
    window 2.5 x max_video_frames long."""
    _, _, tmodel = nuwa
    kw = dict(filter_thres=greedy(16), cond_scale=cond_scale, num_frames=5)
    full = tmodel.generate_long(TEXT, method="full", **kw)
    cached = tmodel.generate_long(TEXT, method="cached", **kw)
    np.testing.assert_array_equal(full.numpy(), cached.numpy())


def test_nuwa_full_samples_from_a_generator(nuwa):
    _, _, tmodel = nuwa
    a = tmodel.generate(TEXT, method="full", generator=torch.Generator().manual_seed(4))
    b = tmodel.generate(TEXT, method="full", generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == (2, 8) and int(a.max()) < 16
    with pytest.raises(ValueError, match="method"):
        tmodel.generate(TEXT, method="fast")


def test_sketch_full_generate_matches_jax():
    """test_torch_sketch.py's plain-decoder NUWASketch (two sketch frames,
    the second padded in row 1): generate by method="full" against JAX and
    against the port's cached ids, and generate_long 3 frames on its
    2-frame window against JAX's full and the port's cached."""
    jmodel, params, tmodel = sketch_base._models(False)
    sketch, mask = sketch_base.SKETCH, sketch_base.SKETCH_MASK
    kw = dict(filter_thres=sketch_base.GREEDY, cond_scale=2.0, decode_video=False)
    want = jmodel.generate(params, sketch=jnp.asarray(sketch), sketch_mask=jnp.asarray(mask),
                           key=KEY, method="full", **kw)
    got = tmodel.generate(sketch, sketch_mask=mask, method="full", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cached = tmodel.generate(sketch, sketch_mask=mask, **kw)
    np.testing.assert_array_equal(got.numpy(), cached.numpy())
    want = jmodel.generate_long(params, sketch=jnp.asarray(sketch[:1]), key=KEY, num_frames=3,
                                method="full", **kw)
    full = tmodel.generate_long(sketch[:1], num_frames=3, method="full", **kw)
    np.testing.assert_array_equal(full.numpy(), np.asarray(want))
    cached = tmodel.generate_long(sketch[:1], num_frames=3, **kw)
    np.testing.assert_array_equal(full.numpy(), cached.numpy())


# H = 4: one audio timestep of 4 tokens a video frame, the plain decoder
VA_H4 = dict(va_base.CFG, num_audio_tokens=16, num_audio_tokens_per_video_frame=4,
             audio_tokens_per_timestep=4, dec_reversible=False,
             sparse_3dna_rel_pos_bias=False, sparse_2dna_rel_pos_bias=False)


def _va_h4():
    tmodel = NUWAVideoAudio(vae=VQGanVAE(**va_base.VAE, device="cpu", seed=1), **VA_H4,
                            device="cpu", seed=0)
    jmodel = JNUWAVideoAudio(vae=JVQGanVAE(**va_base.VAE), **VA_H4)
    return jmodel, jax_params(jmodel, tmodel), tmodel


@pytest.mark.parametrize("height", [1, 4])
def test_video_audio_full_generate_matches_jax(height):
    """Video and audio ids of method="full" against JAX at H = 1 (the plain
    decoder of test_torch_video_audio.py) and H = 4, where the full forward
    attends the later tokens of a query's own timestep, as the JAX one
    does (ROADMAP.md section C item 2). At H = 1 the port's full equals its
    cached, and generate_long (3 frames on a 2-frame window) equals JAX's
    full and the port's cached."""
    jmodel, params, tmodel = va_base._models("h1") if height == 1 else _va_h4()
    kw = dict(filter_thres=greedy(16), cond_scale=2.0, decode_video=False)
    want_v, want_a = jmodel.generate(params, text=jnp.asarray(va_base.TEXT), key=KEY,
                                     method="full", **kw)
    got_v, got_a = tmodel.generate(va_base.TEXT, method="full", **kw)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    if height == 1:
        cached_v, cached_a = tmodel.generate(va_base.TEXT, **kw)
        np.testing.assert_array_equal(got_v.numpy(), cached_v.numpy())
        np.testing.assert_array_equal(got_a.numpy(), cached_a.numpy())
        text = va_base.TEXT[:1]
        want = jmodel.generate_long(params, text=jnp.asarray(text), key=KEY, num_frames=3,
                                    method="full", **kw)
        full = tmodel.generate_long(text, num_frames=3, method="full", **kw)
        cached = tmodel.generate_long(text, num_frames=3, **kw)
        for a, b, w in zip(full, cached, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            np.testing.assert_array_equal(a.numpy(), b.numpy())
