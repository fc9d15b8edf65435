"""Port parity for NUWAVideoAudio sampling: the two models of
test_torch_video_audio.py (H = 1 with the plain decoder, H = 2 with the
reversible one), fp32 on the CPU. Greedy cached ``generate`` (top-k with
k = 1, so the two frameworks' random streams need not agree) and
``generate_long`` one frame past the window, with CFG: video and audio ids
equal, pixels within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_video_audio as base

torch.set_num_threads(1)
GREEDY = 1 - 0.5 / 16  # k = 1 over both vocabularies (16 video and 12 audio codes)
TEXT = base.TEXT


@pytest.fixture(scope="module", params=sorted(base.CONFIGS))
def pair(request):
    return base._models(request.param)


def test_greedy_generate_and_generate_long_match_jax(pair):
    jmodel, params, tmodel = pair
    kw = dict(filter_thres=GREEDY, cond_scale=2.0)
    want_v, want_a = jmodel.generate(params, text=TEXT, key=jax.random.PRNGKey(5),
                                     num_frames=2, decode_video=False, **kw)
    pixels, got_a = tmodel.generate(TEXT, num_frames=2, **kw)
    got_v, got_a2 = tmodel.generate(TEXT, num_frames=2, decode_video=False, **kw)
    assert got_v.shape == (2, 8) and got_a.shape == (2, 6)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_a2.numpy(), np.asarray(want_a))
    want_pixels = jax.jit(lambda p, i: jmodel.vae.codebook_indices_to_video(
        p["vae"]["params"], p["vae"]["state"], i))(params, want_v)
    assert pixels.shape == (2, 2, 3, 8, 8)
    np.testing.assert_allclose(pixels.numpy(), np.asarray(want_pixels), atol=1e-5, rtol=0)

    want_v, want_a = jmodel.generate_long(params, text=TEXT[:1], key=jax.random.PRNGKey(6),
                                          num_frames=3, **kw)
    got_v, got_a = tmodel.generate_long(TEXT[:1], num_frames=3, **kw)
    assert got_v.shape == want_v.shape == (1, 3, 3, 8, 8) and got_a.shape == (1, 9)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5, rtol=0)
