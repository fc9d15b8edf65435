"""Port parity: nuwa_tpu_torch's Sparse3DNA (its kernel wrapper's plain
version on the CPU) against nuwa_tpu's Sparse3DNA.

Two references, same numpy inputs and JAX-initialised params, fp32:
  * JAX's dense path (backend='auto' on the CPU), atol 1e-5;
  * the Pallas kernel in interpret mode (use_pallas=True), with the
    in-kernel score cache widened to fp32 so it is exact (as
    tests/test_pallas_nda.py pins it), atol 1e-5. At fmap 4 and 8 JAX
    takes its lane-packed path; the port reads neighbours directly, so the
    packed path has no counterpart and these cases show that it is subsumed.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nuwa_tpu.nda import Sparse3DNA as JSparse3DNA
from nuwa_tpu_torch.convert import load_jax_params
from nuwa_tpu_torch.kernels import nda as knda
from nuwa_tpu_torch.nda import Sparse3DNA, build_nda_indices

torch.set_num_threads(1)
ATOL = 1e-5
DIM, HEADS, DIM_HEAD = 16, 2, 8


def _pair(fmap, dilation, rel_pos_bias, frames=3, seed=0):
    kw = dict(dim=DIM, video_shape=(frames, fmap, fmap), kernel_size=3,
              dilation=dilation, heads=HEADS, dim_head=DIM_HEAD,
              rel_pos_bias=rel_pos_bias)
    jmod = JSparse3DNA(causal=True, **kw)
    p = jmod.init(jax.random.PRNGKey(seed))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    tmod = load_jax_params(Sparse3DNA(causal=True, **kw), jax.tree.map(np.asarray, p))
    return jmod, p, tmod


def _x(b, t, seed=1):
    return np.random.default_rng(seed).standard_normal((b, 1 + t, DIM)).astype(np.float32)


# (fmap, dilation, t, rel_pos_bias): full frames, a ragged last frame,
# bos only (t = 0) and a single video token
CASES = [
    (4, 1, 48, False), (4, 2, 37, True), (4, 1, 0, False), (4, 2, 1, True),
    (8, 1, 192, True), (8, 2, 150, False),
]


@pytest.mark.parametrize("fmap,dilation,t,bias", CASES)
def test_sparse3dna_matches_jax_dense(fmap, dilation, t, bias):
    jmod, p, tmod = _pair(fmap, dilation, bias)
    x = _x(2, t)
    want = jax.jit(lambda p, x: jmod(p, x))(p, jnp.asarray(x))
    got = tmod(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("fmap,dilation,t,bias", [(4, 2, 37, True), (8, 1, 128, False)])
def test_sparse3dna_matches_pallas_interpret(monkeypatch, fmap, dilation, t, bias):
    import nuwa_tpu.kernels.nda_pallas as K

    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    K._VJP_CACHE.clear()
    try:
        jmod, p, tmod = _pair(fmap, dilation, bias, frames=2)
        x = _x(1, t, seed=2)
        with pltpu.force_tpu_interpret_mode():
            want = jmod.replace(use_pallas=True)(p, jnp.asarray(x))
        got = tmod(torch.from_numpy(x)).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    finally:
        K._VJP_CACHE.clear()


def test_build_nda_indices_is_a_copy():
    from nuwa_tpu.nda import build_nda_indices as jax_build

    args = ((3, 4, 5), (3, 3, 3), (2, 1, 2), ("causal",) * 3)
    for a, b in zip(build_nda_indices(*args), jax_build(*args)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_lse_matches_bruteforce():
    """The plain version's lse against a loop over coordinates."""
    rng = np.random.default_rng(3)
    b, h, t, d, fmap, dil = 1, 2, 11, 4, (2, 3), (1, 2, 1)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    kb, vb = (rng.standard_normal((b, h, 1, d)).astype(np.float32) for _ in range(2))
    th = rng.standard_normal((h, h)).astype(np.float32)
    out, lse = knda.sparse_3dna_fwd(
        *map(torch.from_numpy, (q, k, v, kb, vb, th)),
        fmap=fmap, kernel=(3, 3, 3), dilation=dil,
    )
    hw = fmap[0] * fmap[1]
    for i in range(t):
        f, y, x = i // hw, (i % hw) // fmap[1], i % fmap[1]
        toks = [
            (f - a * dil[0]) * hw + (y - bb * dil[1]) * fmap[1] + (x - c)
            for a in range(3) for bb in range(3) for c in range(3)
            if f - a * dil[0] >= 0 and y - bb * dil[1] >= 0 and x - c >= 0
        ]
        for hh in range(h):
            s = np.concatenate([q[0, hh, i] @ kb[0, hh].T, q[0, hh, i] @ k[0, hh, toks].T])
            want = np.log(np.exp(s - s.max()).sum()) + s.max()
            assert abs(lse[0, hh, i].item() - want) < 1e-5


def test_wrapper_refuses_other_devices():
    """No quiet fallback: a tensor on neither the CPU nor CUDA raises."""
    q = torch.empty(1, 2, 4, 8, device="meta")
    kb = torch.empty(1, 2, 1, 8, device="meta")
    with pytest.raises(ValueError):
        knda.sparse_3dna_fwd(q, q, q, kb, kb, torch.eye(2), fmap=(2, 2),
                             kernel=(3, 3, 3), dilation=(1, 1, 1))
