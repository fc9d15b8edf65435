"""Port parity for NUWA from text and pixels, sampling: the tiny
``NUWA(vae=...)`` of test_torch_nuwa_vae.py (a one-layer codec on 8-pixel
frames, fmap 4, the JAX params tree from the port's seeded weights), fp32
on the CPU. Greedy ``generate`` (k = 1, so the samplers' noise cannot
change the argmax) and ``generate_long`` one frame past the window, to
pixels: ids equal, pixels within 1e-5. The trainer:
test_torch_nuwa_vae_train.py.
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_nuwa_vae as base

torch.set_num_threads(1)
GREEDY = 1 - 0.5 / base.VAE["vq_codebook_size"]  # k = max(int(0.5), 1) = 1


@pytest.fixture(scope="module")
def pair():
    return base._models()


def test_greedy_generate_and_generate_long_to_pixels_match_jax(pair):
    jmodel, params, tmodel = pair
    kw = dict(filter_thres=GREEDY, cond_scale=2.0, num_frames=2)
    key = jax.random.PRNGKey(5)
    want = jmodel.generate(params, text=base.TEXT, key=key, **kw)
    want_ids = jmodel.generate(params, text=base.TEXT, key=key, decode_video=False, **kw)
    got = tmodel.generate(base.TEXT, **kw)
    ids = tmodel.generate(base.TEXT, decode_video=False, **kw)
    assert got.shape == want.shape == (2, 2, 3, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert ids.shape == (2, 32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    kw = dict(kw, num_frames=3)
    want = jmodel.generate_long(params, text=base.TEXT[:1], key=jax.random.PRNGKey(6), **kw)
    got = tmodel.generate_long(base.TEXT[:1], **kw)
    assert got.shape == want.shape == (1, 3, 3, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
