"""Port parity for the video token shift along time and space:
``ops.shift.shift_video_tokens`` at its four flag settings, a causal
Sparse3DNA stack whose ``ShiftVideo`` blocks take the flags (both packages'
``ShiftVideo`` built with them), its full forward, and its cached decoder
(``decode._ShiftVideoStep``) at every position, against the full forward
and against the JAX decoder's steps; a prefill then steps, as
``generate_long``'s sliding window re-primes its caches from position 0.
The same weights (the port's, seeded, written into the JAX tree that
``jax.eval_shape`` gives), fp32 on the CPU.

Tolerances: the shift is data movement, equal to 1e-7; stack outputs
within 1e-5 of the reference's max abs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuwa_tpu.transformer as jtransformer
import nuwa_tpu_torch.transformer as ttransformer
from nuwa_tpu.decode import TransformerDecoder as JDecoder
from nuwa_tpu.ops.shift import shift_video_tokens as jshift
from nuwa_tpu_torch.core.layers import init_weights_
from nuwa_tpu_torch.decode import TransformerDecoder
from nuwa_tpu_torch.ops.shift import shift_video_tokens
from test_torch_sketch import jax_params

torch.set_num_threads(1)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["none", "space", "time", "both"]
# 3 frames of fmap 3 (27 video tokens) after bos; dim 20 splits into 3
# uneven chunks (7, 7, 6)
STACK = dict(dim=20, depth=2, heads=2, dim_head=8, causal=True, sparse_3dna_attn=True,
             sparse_3dna_video_shape=(3, 3, 3), sparse_3dna_kernel_size=3,
             shift_video_tokens=True)
N = 1 + 27


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("flags", FLAGS, ids=IDS)
@pytest.mark.parametrize("n", [1 + 2 * 9 + 4, 1 + 9, 1])
def test_shift_video_tokens_matches_jax(flags, n):
    """n video tokens that a frame of 9 does not divide, whole frames, and
    bos alone; d = 11 gives uneven chunks (and an empty one of 5)."""
    x = _rnd(2, n, 11, seed=n)
    want = jshift(jnp.asarray(x), 3, *flags)
    got = shift_video_tokens(torch.from_numpy(x), 3, *flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(got[:, 0].numpy(), x[:, 0])  # bos passes unshifted


@pytest.fixture(scope="module", params=FLAGS, ids=IDS)
def stack(request):
    """The stack of both packages with ShiftVideo(shift_space, shift_time),
    and JAX's full forward and cached steps over one input."""
    space, time = request.param
    x = _rnd(2, N, STACK["dim"], seed=4)
    # the JAX stack builds its menu on every call: the patch stays on for them
    with pytest.MonkeyPatch.context() as mp:
        for module in (jtransformer, ttransformer):
            mp.setattr(module, "ShiftVideo", functools.partial(
                module.ShiftVideo, shift_space=space, shift_time=time))
        jmod = jtransformer.Transformer(**STACK)
        tmod = init_weights_(ttransformer.Transformer(**STACK), 3)
        params = jax_params(jmod, tmod)
        jdec = JDecoder(jmod, total_in=N)
        full = jax.jit(lambda p, x: jmod(p, x))(params, x)

        @jax.jit
        def jax_steps(p, x):
            def body(caches, inp):
                x_i, pos = inp
                y, caches = jdec.step(p, caches, x_i, pos)
                return caches, y

            caches = jdec.init_cache(p, 2, None, None)
            _, ys = jax.lax.scan(body, caches, (jnp.swapaxes(x, 0, 1), jnp.arange(N)))
            return jnp.swapaxes(ys, 0, 1)

        steps = jax_steps(params, x)
    shifts = [m for m in tmod.modules() if isinstance(m, ttransformer.ShiftVideo)]
    assert shifts and all((m.shift_space, m.shift_time) == (space, time) for m in shifts)
    return tmod, x, full, steps


def test_stack_forward_matches_jax(stack):
    tmod, x, full, _ = stack
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _close(got, full)


def test_cached_steps_match_full_forward_and_jax(stack):
    """A step at every position against the full forward and the JAX steps;
    a prefill of the first frame and a half, then steps, as the steps."""
    tmod, x, full, jax_steps = stack
    xt = torch.from_numpy(x)
    dec = TransformerDecoder(tmod, total_in=N)
    with torch.no_grad():
        caches = dec.init_cache(2, None, None)
        stepped = torch.stack([dec.step(caches, xt[:, i], i) for i in range(N)], dim=1)
        k = 1 + 9 + 5
        prefilled = dec.prefill(dec.init_cache(2, None, None), xt[:, :k])
        rest = torch.stack([dec.step(prefilled, xt[:, i], i) for i in range(k, N)], dim=1)
    _close(stepped, full)
    _close(stepped, jax_steps)
    _close(rest, np.asarray(full)[:, k:])
