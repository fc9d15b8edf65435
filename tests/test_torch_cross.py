"""Port parity: nuwa_tpu_torch's SparseCross2DNA (its kernel wrapper's plain
version on the CPU) against nuwa_tpu's SparseCross2DNA on three paths.

Same numpy inputs and JAX-initialised params, fp32, each case at one and two
context frames, a full and a ragged last query frame, with a context mask
that masks some tokens of the first batch row and every token of the
second (the unconditional half of a CFG batch):
  * the gather path (backend="gather"), atol 1e-5;
  * the fused Pallas kernels 7 and 8 (``_xfused_kernel``, Fc >= 2, and
    ``_xfused1_kernel``, Fc = 1) in interpret mode (use_pallas=True), with
    the score cache widened to fp32 so they are exact, atol 1e-5;
  * the per-frame fallback ``_cross_core_op`` (Sparse3DNA's kernel in
    fixed-taps mode), which the JAX package takes when the fused kernels'
    score cache would not fit VMEM: ``xfused_ok`` is patched to refuse, atol
    1e-5. The Hopper kernel has no such limit, so these cases show that it
    subsumes that path.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nuwa_tpu.nda import SparseCross2DNA as JSparseCross2DNA
from nuwa_tpu_torch.convert import load_jax_params
from nuwa_tpu_torch.kernels import cross as kcross
from nuwa_tpu_torch.nda import SparseCross2DNA

torch.set_num_threads(1)
ATOL = 1e-5
DIM, HEADS, DIM_HEAD, FMAP = 16, 2, 8, 4
HW = FMAP * FMAP


def _pair(dilation, seed=0):
    kw = dict(dim=DIM, image_size=FMAP, heads=HEADS, dim_head=DIM_HEAD, kernel_size=3,
              dilation=dilation)
    jmod = JSparseCross2DNA(backend="gather", **kw)
    p = jmod.init(jax.random.PRNGKey(seed))
    # a talking-heads matrix far from the identity couples the heads
    p["talking_heads"] = jnp.asarray([[0.3, 1.2], [-0.8, 0.5]], jnp.float32)
    p = jax.tree.map(np.asarray, p)
    return jmod, p, load_jax_params(SparseCross2DNA(**kw), p)


def _inputs(t, frames, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1 + t, DIM)).astype(np.float32)
    ctx = rng.standard_normal((2, frames * HW, DIM)).astype(np.float32)
    mask = np.stack([rng.random(frames * HW) < 0.6, np.zeros(frames * HW, bool)])
    return x, ctx, mask


def _port(tmod, x, ctx, mask):
    with torch.no_grad():
        return tmod(torch.from_numpy(x), context=torch.from_numpy(ctx),
                    context_mask=torch.from_numpy(mask)).numpy()


# (context frames, video tokens, dilation): a ragged last frame, full frames
CASES = [(1, 37, 1), (2, 37, 2), (1, 48, 2), (2, 48, 1)]


@pytest.mark.parametrize("frames,t,dilation", CASES)
def test_cross_matches_jax_gather(frames, t, dilation):
    jmod, p, tmod = _pair(dilation)
    x, ctx, mask = _inputs(t, frames)
    want = jax.jit(lambda p, x, c, m: jmod(p, x, context=c, context_mask=m))(p, x, ctx, mask)
    np.testing.assert_allclose(_port(tmod, x, ctx, mask), np.asarray(want), atol=ATOL, rtol=0)


def _pallas(monkeypatch, jmod, p, x, ctx, mask, fused):
    import nuwa_tpu.kernels.nda_pallas as K

    monkeypatch.setattr(K, "_CACHE_DTYPE", jnp.float32)
    if not fused:
        monkeypatch.setattr(K, "xfused_ok", lambda *a: False)
    K._VJP_CACHE.clear()
    try:
        mod = jmod.replace(use_pallas=True)
        with pltpu.force_tpu_interpret_mode():
            run = jax.jit(lambda p, x, c, m: mod(p, x, context=c, context_mask=m))
            return np.asarray(run(p, x, ctx, mask))
    finally:
        K._VJP_CACHE.clear()


@pytest.mark.parametrize("frames,t,dilation", CASES[:2])
@pytest.mark.parametrize("fused", [True, False], ids=["xfused", "per_frame"])
def test_cross_matches_pallas_interpret(monkeypatch, frames, t, dilation, fused):
    jmod, p, tmod = _pair(dilation)
    x, ctx, mask = _inputs(t, frames, seed=2)
    want = _pallas(monkeypatch, jmod, p, x, ctx, mask, fused)
    np.testing.assert_allclose(_port(tmod, x, ctx, mask), want, atol=ATOL, rtol=0)


def test_cross_without_mask_and_bos_only_match_jax():
    """No context mask (all attended) and a bos-only input (t = 0)."""
    jmod, p, tmod = _pair(1)
    x, ctx, _ = _inputs(20, 2, seed=3)
    for xx in (x, x[:, :1]):
        want = jax.jit(lambda p, x, c: jmod(p, x, context=c))(p, xx, ctx)
        with torch.no_grad():
            got = tmod(torch.from_numpy(xx), context=torch.from_numpy(ctx)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_wrapper_matches_bruteforce_and_masked_rows_take_the_null():
    """The plain version's out and lse against a loop over coordinates; a
    row whose context is all masked gets the mixed null value."""
    rng = np.random.default_rng(4)
    b, h, t, d, fmap, k, dil, frames = 2, 2, 11, 4, 3, 3, 2, 2
    q = rng.standard_normal((b, h, t, d)).astype(np.float32)
    kk, vv = (rng.standard_normal((b, h, frames * 9, d)).astype(np.float32) for _ in range(2))
    nk, nv = (rng.standard_normal((b, h, 1, d)).astype(np.float32) for _ in range(2))
    th = rng.standard_normal((h, h)).astype(np.float32)
    mask = np.stack([rng.random(frames * 9) < 0.7, np.zeros(frames * 9, bool)])
    out, lse = kcross.sparse_cross_2dna_fwd(
        *map(torch.from_numpy, (q, kk, vv, nk, nv, th, mask)),
        fmap=fmap, kernel_size=k, dilation=dil,
    )
    for i in range(t):
        s = i % 9
        y, x = divmod(s, fmap)
        toks = [c * 9 + (y + a * dil) * fmap + (x + e * dil)
                for c in range(frames) for a in (-1, 0, 1) for e in (-1, 0, 1)
                if 0 <= y + a * dil < fmap and 0 <= x + e * dil < fmap]
        for bi in range(b):
            keep = [tok for tok in toks if mask[bi, tok]]
            p = []
            for hh in range(h):
                sc = np.concatenate([nk[bi, hh] @ q[bi, hh, i], kk[bi, hh, keep] @ q[bi, hh, i]])
                m = sc.max()
                assert abs(lse[bi, hh, i].item() - (m + np.log(np.exp(sc - m).sum()))) < 1e-5
                p.append(np.exp(sc - m) / np.exp(sc - m).sum())
            mixed = th @ np.stack(p)
            for hh in range(h):
                vals = np.concatenate([nv[bi, hh], vv[bi, hh, keep]])
                np.testing.assert_allclose(out[bi, hh, i].numpy(), mixed[hh] @ vals, atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(),
                               np.broadcast_to(th.sum(1)[:, None, None] * nv[1], (h, t, d)),
                               atol=1e-5)


def test_wrapper_refuses_other_devices():
    """No quiet fallback: a tensor on neither the CPU nor CUDA raises."""
    q = torch.empty(1, 2, 4, 8, device="meta")
    kv = torch.empty(1, 2, 16, 8, device="meta")
    nk = torch.empty(1, 2, 1, 8, device="meta")
    with pytest.raises(ValueError):
        kcross.sparse_cross_2dna_fwd(q, kv, kv, nk, nk, torch.eye(2), fmap=4, kernel_size=3,
                                     dilation=1)
