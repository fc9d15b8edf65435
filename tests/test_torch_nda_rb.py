"""Port parity for Sparse3DNA past 256 tokens a frame, where the JAX package
runs its row-blocked Pallas kernels (``_rb_kernel``, ``_rb_bwd_q_kernel``,
``_rb_bwd_kv_kernel``) and the port the same three kernels as at any other
frame size (on the CPU, their plain versions).

``nuwa_tpu_torch.nda.Sparse3DNA`` against the JAX module with
``use_pallas=True``, which on the CPU runs ``_rb_core_op`` in interpret mode
(as tests/test_pallas_nda.py runs it) with the kernels' score cache widened
to fp32: its output and the gradients of x and of every parameter (the
projections, the talking heads and the axial rel-pos tables, so the port's
(h, Kn) bias is pinned to the row-blocked kernels' ``_rb_bias_tensors``),
each within 1e-5 of its reference's max abs. 2 heads of 8, fp32. Here 32 x
9 frames (HW 288) causal with dilation 1 and (1, 2, 2), the second with a
ragged last frame; test_torch_nda_rb_modes.py runs the other cases of
``CASES``: centered windows, and 8 x 8 frames with the JAX ``row_block=4``
(the cheap case of the same kernels). The JAX reference is jitted once a
case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nuwa_tpu.nda import Sparse3DNA as JSparse3DNA
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params
from nuwa_tpu_torch.nda import Sparse3DNA

torch.set_num_threads(1)
REL = 1e-5
DIM, HEADS, DIM_HEAD = 16, 2, 8


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (video shape, dilation, causal, tokens short of whole frames, batch, row_block)
CASES = {
    "32x9 causal dil 1": ((2, 32, 9), 1, True, 0, 1, None),
    "32x9 causal dil (1,2,2) ragged": ((2, 32, 9), (1, 2, 2), True, 5, 1, None),
    "3x32x9 centered dil (1,2,2) phantom": ((3, 32, 9), (1, 2, 2), False, 1, 1, None),
    "8x8 causal row_block 4": ((2, 8, 8), 1, True, 0, 2, 4),
}


@pytest.mark.parametrize("case", [c for c, spec in CASES.items() if spec[0][1:] == (32, 9)
                                  and spec[2]])
def test_sparse3dna_matches_jax_row_blocked_kernels(case, monkeypatch):
    check_case(case, monkeypatch)


def check_case(case, monkeypatch):
    import nuwa_tpu.kernels.nda_pallas as K

    shape, dilation, causal, short, b, row_block = CASES[case]
    kw = dict(dim=DIM, video_shape=shape, kernel_size=3, dilation=dilation, heads=HEADS,
              dim_head=DIM_HEAD, causal=causal, rel_pos_bias=True)
    jmod = JSparse3DNA(**kw).replace(use_pallas=True, row_block=row_block)
    tmod = Sparse3DNA(**kw)
    p = jmod.init(jax.random.PRNGKey(0))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    load_jax_params(tmod, jax.tree.map(np.asarray, p))
    t = shape[0] * shape[1] * shape[2] - short
    assert shape[1] * shape[2] > 256 or row_block is not None
    x, w = _rnd(b, 1 + t, DIM, seed=1), _rnd(b, 1 + t, DIM, seed=2)

    def loss(p, x):
        out = jmod(p, x)
        return jnp.sum(out * w), out

    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    K._VJP_CACHE.clear()
    try:
        run = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
        with pltpu.force_tpu_interpret_mode():
            (_, want), (jgrads, jgx) = run(p, jnp.asarray(x))
    finally:
        K._VJP_CACHE.clear()

    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(xt)
    (out * torch.from_numpy(w)).sum().backward()
    ref = flatten_params(jax.tree.map(np.asarray, jgrads))
    got = {jax_path(tmod, n): q.grad.numpy() for n, q in tmod.named_parameters()}
    assert sorted(got) == sorted(ref)
    assert any("rel_pos_bias" in n for n in got)
    for name, g, r in [("out", out.detach().numpy(), np.asarray(want)),
                       ("x", xt.grad.numpy(), np.asarray(jgx)),
                       *((n, got[n], r) for n, r in ref.items())]:
        np.testing.assert_allclose(g, r, atol=REL * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=name)
