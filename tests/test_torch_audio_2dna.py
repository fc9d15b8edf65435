"""Port parity for SparseCausal2DNA, the audio self-attention: the port's
module (its attention ``kernels.nda.sparse_3dna`` in the audio geometry, the
plain gather version on the CPU) against nuwa_tpu's, fp32.

  * the JAX gather path at heights 1, 2, 3, 5 and 9, a ragged last timestep
    where the height allows one, dilations 1 and 2, the rel-pos bias on and
    off: the output within 1e-5 of its max abs, and the gradients of x and
    of every parameter within 1e-5 of each reference's max abs;
  * the JAX module's Pallas kernels (``use_pallas=True``) in interpret mode,
    as tests/test_pallas_nda.py runs them, at heights 1 and 4: within that
    file's 2e-2 (the kernels' bf16 score cache); and the output and every
    gradient against their forward and backward kernels, the score cache in
    fp32, at height 4 (the whole-frame kernels) and 3 (the row-blocked
    ones): within 2e-2 too;
  * the reference's own-timestep finding, in both packages at height 2: the
    full forward's output at audio query 0 moves with audio token 1, which
    lies in the same timestep; the cached step's output at that query is the
    forward's over the tokens up to it, and does not see token 1.
  * ``kernels.nda.valid_pairs``, which the chip smoke test's bounds count
    with, in each geometry (causal, centered, audio) against a count of the
    pairs from each token's coordinates, and the wrappers' refusal of an
    unknown mode or of an audio geometry that is not (1, H) x (K, 1, H).
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nuwa_tpu.decode_dual import _SparseCausal2DNAStep as JStep
from nuwa_tpu.nda import SparseCausal2DNA as JSparseCausal2DNA
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.decode_dual import _SparseCausal2DNAStep
from nuwa_tpu_torch.kernels import nda as knda
from nuwa_tpu_torch.nda import SparseCausal2DNA

torch.set_num_threads(1)
REL = 1e-5
DIM, HEADS, DIM_HEAD = 16, 2, 8


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(height, kernel, dilation, bias, seed=0):
    kw = dict(dim=DIM, height=height, heads=HEADS, dim_head=DIM_HEAD, kernel_size=kernel,
              dilation=dilation, rel_pos_bias=bias)
    jmod = JSparseCausal2DNA(**kw)
    p = jmod.init(jax.random.PRNGKey(seed))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    tmod = load_jax_params(SparseCausal2DNA(**kw), jax.tree.map(np.asarray, p))
    return jmod, p, tmod


def _ragged_t(height, timesteps):
    """``timesteps`` whole timesteps and one token of the next, where the
    height leaves a token out."""
    return timesteps * height + (1 if height > 1 else 0)


# (height, kernel, dilation, bias): every height, both dilations, bias on and off
@pytest.mark.parametrize("height,kernel,dilation,bias", [
    (1, 5, 1, True), (2, 3, 2, False), (3, 5, 1, False), (5, 3, 2, True), (9, 3, 1, True),
])
def test_sparse_causal_2dna_matches_jax_gather(height, kernel, dilation, bias):
    jmod, p, tmod = _pair(height, kernel, dilation, bias)
    t = _ragged_t(height, 2 * kernel)
    x = _rnd(2, 1 + t, DIM, seed=1)
    w = _rnd(2, 1 + t, DIM, seed=2)
    _assert_grads_match(tmod, x, w, _jax_grads(jmod, p, x, w), REL)


def _jax_grads(jmod, p, x, w):
    """The JAX module's output on x, and the gradients of sum(out * w) in its
    params and in x."""
    run = jax.jit(jax.value_and_grad(lambda p, x: (jnp.sum(jmod(p, x) * w), jmod(p, x)),
                                     argnums=(0, 1), has_aux=True))
    (_, want), (jgrads, jgx) = run(p, jnp.asarray(x))
    return np.asarray(want), flatten_params(jax.tree.map(np.asarray, jgrads)), np.asarray(jgx)


def _assert_grads_match(tmod, x, w, want, rel):
    """The port's output and gradients against ``_jax_grads``' within ``rel``
    of each reference's max abs (at least 1 for the gradients)."""
    want, ref, jgx = want
    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(xt)
    np.testing.assert_allclose(out.detach().numpy(), want,
                               atol=rel * np.abs(want).max(), rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    got = {jax_path(tmod, n): q.grad.numpy() for n, q in tmod.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, g, r in [("x", xt.grad.numpy(), jgx), *((n, got[n], r) for n, r in ref.items())]:
        np.testing.assert_allclose(g, r, atol=rel * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("height,kernel,dilation", [(1, 3, 1), (4, 5, 2)])
def test_sparse_causal_2dna_matches_pallas_interpret(height, kernel, dilation):
    jmod, p, tmod = _pair(height, kernel, dilation, bias=True, seed=3)
    t = _ragged_t(height, 7)
    x = _rnd(2, 1 + t, DIM, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmod.replace(use_pallas=True)(p, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# (height, kernel, dilation): H = 4 runs the whole-frame kernels through
# _audio_core_op (TPU kernels 1-3), H = 3 the row-blocked ones through
# _audio_rb_core_op (kernels 4-6: lcm(H, 128) = 384 > 256)
@pytest.mark.parametrize("height,kernel,dilation", [(4, 5, 2), (3, 3, 1)])
def test_sparse_causal_2dna_grads_match_pallas_interpret(monkeypatch, height, kernel,
                                                         dilation):
    """The output and every gradient against the JAX module's Pallas
    forward and backward kernels in interpret mode, their score cache in
    fp32 (``_CACHE_DTYPE``, as tests/test_torch_cross_grad.py sets it), a
    ragged last timestep, the bias on: within 2e-2, the tolerance of the
    forward's check above."""
    import nuwa_tpu.kernels.nda_pallas as K

    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    K._VJP_CACHE.clear()
    try:
        jmod, p, tmod = _pair(height, kernel, dilation, bias=True, seed=8)
        t = _ragged_t(height, 6)
        x, w = _rnd(2, 1 + t, DIM, seed=9), _rnd(2, 1 + t, DIM, seed=10)
        with pltpu.force_tpu_interpret_mode():
            want = _jax_grads(jmod.replace(use_pallas=True), p, x, w)
        _assert_grads_match(tmod, x, w, want, 2e-2)
    finally:
        K._VJP_CACHE.clear()


def test_forward_attends_its_own_timestep_and_the_cached_step_does_not():
    """Height 2: audio tokens 0 and 1 share timestep 0. In each package the
    forward's output at query 0 (input row 1) changes when token 1 (row 2)
    changes; the cached step at that position gives the forward's output
    over [bos, token 0] alone, in both packages alike."""
    jmod, p, tmod = _pair(height=2, kernel=3, dilation=1, bias=True, seed=5)
    x = _rnd(1, 4, DIM, seed=6)  # bos and three audio tokens
    x2 = x.copy()
    x2[:, 2] += _rnd(1, DIM, seed=7)
    fwd = jax.jit(jmod.__call__)
    jq0 = [np.asarray(fwd(p, jnp.asarray(a)))[:, 1] for a in (x, x2)]
    with torch.no_grad():
        tq0 = [tmod(torch.from_numpy(a))[:, 1].numpy() for a in (x, x2)]
        prefix = tmod(torch.from_numpy(x[:, :2]))[:, 1].numpy()
    for a, b in (jq0, tq0):
        assert np.abs(a - b).max() > 1e-2  # the forward sees token 1
    np.testing.assert_allclose(tq0[0], jq0[0], atol=REL * np.abs(jq0[0]).max(), rtol=0)

    jstep, step = JStep(jmod, 3), _SparseCausal2DNAStep(tmod, 3)
    jcache, cache = jstep.init_cache(1, jnp.float32), step.init_cache(1, torch.float32)
    for pos in range(2):
        jy, jcache = jstep(p, jcache, jnp.asarray(x[:, pos]), jnp.asarray(pos))
        with torch.no_grad():
            y = step(cache, torch.from_numpy(x[:, pos]), pos).numpy()
    np.testing.assert_allclose(y, np.asarray(jy), atol=REL * np.abs(prefix).max(), rtol=0)
    np.testing.assert_allclose(y, prefix, atol=REL * np.abs(prefix).max(), rtol=0)
    assert np.abs(y - tq0[0]).max() > 1e-2


def _count_pairs(t, fmap, kernel, dilation, mode):
    """The valid (query, neighbour) pairs of a t-token sequence, from each
    token's coordinates: every axis in range and the neighbour's id below t.
    The audio geometry's window is whole timesteps: column c of slot c."""
    fh, fw = fmap
    count = 0
    for i in range(t):
        f, y, x = i // (fh * fw), i // fw % fh, i % fw
        for a, b, c in itertools.product(*(range(k) for k in kernel)):
            if mode == "audio":
                nf, ny, nx = f + (a - (kernel[0] - 1)) * dilation[0], 0, c
            else:
                offs = [(j - (k - 1 if mode == "causal" else (k - 1) // 2)) * d
                        for j, k, d in zip((a, b, c), kernel, dilation)]
                nf, ny, nx = f + offs[0], y + offs[1], x + offs[2]
            inside = nf >= 0 and 0 <= ny < fh and 0 <= nx < fw
            count += inside and (nf * fh + ny) * fw + nx < t
    return count


# (mode, t, fmap, kernel, dilation): whole and ragged last frames or timesteps
@pytest.mark.parametrize("mode,t,fmap,kernel,dilation", [
    ("causal", 47, (4, 4), (3, 3, 3), (1, 2, 1)),
    ("centered", 45, (4, 4), (3, 5, 3), (2, 1, 2)),
    ("audio", 35, (1, 4), (5, 1, 4), (2, 1, 1)),
    ("audio", 27, (1, 3), (7, 1, 3), (1, 1, 1)),
])
def test_valid_pairs_counts_each_geometry(mode, t, fmap, kernel, dilation):
    assert knda.valid_pairs(t, fmap, kernel, dilation, mode) == _count_pairs(
        t, fmap, kernel, dilation, mode)


def test_wrappers_refuse_an_unknown_mode_or_audio_geometry():
    x = torch.zeros(1, HEADS, 8, DIM_HEAD)
    args = (x, x, x, x[:, :, :1], x[:, :, :1], torch.eye(HEADS))
    with pytest.raises(ValueError, match="mode"):
        knda.sparse_3dna_fwd(*args, fmap=(1, 4), kernel=(3, 1, 4), dilation=(1, 1, 1),
                             mode="full")
    with pytest.raises(ValueError, match="audio geometry"):
        knda.sparse_3dna_fwd(*args, fmap=(1, 4), kernel=(3, 1, 2), dilation=(1, 1, 1),
                             mode="audio")
