"""The port's context parallelism in one process, with no process group.

  * The Sparse3DNA plain versions over a query window: at context 2, 3 and
    4 (``parallel.context_parallel.shard_layout``, the frames not dividing
    the ranks, a ragged last frame, a lookback of several ranks' frames and
    a centered window's lookahead), each shard's outputs and gradients, its
    queries over its key buffer with ``q_lo`` and ``tok0``, reassembled (the
    halo gradients added back to their owners) equal the unsharded plain
    versions': fp32 within 1e-5 of each reference's max abs; with dropout
    0.1 the shards' masks (the zeros of the mixed probabilities) are the
    unsharded ones.
  * The port's CP step (``cp_step``) of every rank of a virtual axis (a
    comm whose halo slices the whole sequence's k and v and whose gather
    keeps the rank's rows) against JAX's ``context_parallel_sparse_3dna`` on
    a 2- and a 4-device CPU mesh, in the configurations of the JAX package's
    tests/test_parallel.py: frames that do not divide the mesh (and a ragged
    tail), a bos-only input, the centered encoder, the plain causal layer
    and a multi-hop halo, and 5 frames over 4 ranks, the last of which
    owns no frame and gives bos alone; atol 1e-5 of the output's max abs.
The exchange and the gather themselves run over gloo in
tests/test_torch_parallel_cp.py.
"""
import jax
import numpy as np
import pytest
import torch

from nuwa_tpu.nda import Sparse3DNA as JSparse3DNA
from nuwa_tpu.parallel import make_mesh as jax_make_mesh
from nuwa_tpu.parallel.context_parallel import (
    context_parallel_sparse_3dna as jax_context_parallel,
)
from nuwa_tpu_torch.convert import load_jax_params
from nuwa_tpu_torch.kernels import nda as knda
from nuwa_tpu_torch.nda import Sparse3DNA
from nuwa_tpu_torch.ops.attention import split_heads
from nuwa_tpu_torch.parallel.context_parallel import (
    AxisComm,
    cp_axes,
    cp_step,
    frame_reach,
    shard_layout,
)

torch.set_num_threads(1)
REL = 1e-5


def _rnd(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _reach(kernel, dilation, mode):
    lookback = (kernel[0] - 1) * dilation[0]
    if mode == "causal":
        return lookback, 0
    return lookback // 2, lookback - lookback // 2


# (fmap, kernel, dilation, mode, t): frames of 6 tokens, 7 frames less one
# token, so the last frame is ragged; dilation 2 looks 4 frames back, past
# the 2 frames of a rank at context 4
GEOMETRIES = [
    ((2, 3), (3, 3, 3), (2, 1, 1), "causal", 41),
    ((2, 3), (5, 3, 3), (1, 1, 2), "centered", 41),
]


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["causal", "centered"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_shards_reassemble_the_unsharded_plain_versions(size, geometry, rate):
    fmap, kernel, dilation, mode, t = geometry
    b, h, d, kn = 2, 3, 8, kernel[0] * kernel[1] * kernel[2]
    geo = dict(fmap=fmap, kernel=kernel, dilation=dilation, mode=mode,
               dropout=(rate, 1234) if rate else None)
    leaves = [_rnd(b, h, t, d, seed=i) for i in range(3)]
    leaves += [_rnd(b, h, 1, d, seed=3 + i) for i in range(2)]
    leaves += [_rnd(h, h, seed=5), _rnd(h, kn, seed=6)]
    for x in leaves:
        x.requires_grad_()
    q, k, v, k_bos, v_bos, th, bias = leaves
    cot = _rnd(b, h, t, d, seed=7)

    want = knda.sparse_3dna(*leaves, **geo)
    want_grads = torch.autograd.grad(want, leaves, cot)
    _, layout = shard_layout(t, fmap[0] * fmap[1], size, *_reach(kernel, dilation, mode))
    got, masks = [], []
    for (lo, hi), (k_lo, k_hi) in layout:
        win = dict(geo, q_lo=lo - k_lo, tok0=k_lo)
        got.append(knda.sparse_3dna(q[:, :, lo:hi], k[:, :, k_lo:k_hi], v[:, :, k_lo:k_hi],
                                    k_bos, v_bos, th, bias, **win))
        _, lse = knda.sparse_3dna_fwd_plain(q[:, :, lo:hi], k[:, :, k_lo:k_hi],
                                            v[:, :, k_lo:k_hi], k_bos, v_bos, th, bias, **win)
        masks.append(knda.sparse_3dna_bwd_q_plain(
            q[:, :, lo:hi], k[:, :, k_lo:k_hi], v[:, :, k_lo:k_hi], k_bos, v_bos, th, bias,
            cot[:, :, lo:hi], lse, **win)[2] != 0)
    got = torch.cat(got, dim=2)
    got_grads = torch.autograd.grad(got, leaves, cot)
    torch.testing.assert_close(got, want, atol=REL * want.abs().max().item(), rtol=0)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, atol=REL * w.abs().max().item(), rtol=0)
    _, lse = knda.sparse_3dna_fwd_plain(*leaves, **geo)
    mix = knda.sparse_3dna_bwd_q_plain(*leaves, cot, lse, **geo)[2]
    assert torch.equal(torch.cat(masks, dim=2), mix != 0)
    if rate:
        assert (mix == 0).any()


def test_windows_that_the_kernels_do_not_take_raise():
    q, k = _rnd(1, 2, 6, 8), _rnd(1, 2, 12, 8)
    th = _rnd(2, 2)
    geo = dict(fmap=(2, 3), kernel=(3, 3, 3), dilation=(1, 1, 1))
    with pytest.raises(ValueError, match="start a frame"):
        knda.sparse_3dna_fwd(q, k, k, k[:, :, :1], k[:, :, :1], th, q_lo=3, **geo)
    with pytest.raises(ValueError, match="lie in"):
        knda.sparse_3dna_fwd(q, k, k, k[:, :, :1], k[:, :, :1], th, q_lo=12, **geo)
    audio = dict(fmap=(1, 3), kernel=(3, 1, 3), dilation=(1, 1, 1), mode="audio")
    with pytest.raises(ValueError, match="audio"):
        knda.sparse_3dna_fwd(q, k, k, k[:, :, :1], k[:, :, :1], th, q_lo=6, **audio)
    with pytest.raises(ValueError, match="audio"):
        knda.sparse_3dna_bwd_kv(q, q, _rnd(1, 2, 6, 4), _rnd(1, 2, 6, 4), t=12, **audio)


def test_frame_axis_routing():
    class Mesh:  # the two attributes cp_axes reads
        def __init__(self, **sizes):
            self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())

    assert cp_axes(Mesh(data=4, model=1)) == ("data", None)
    assert cp_axes(Mesh(data=2, model=1, context=2)) == ("context", "data")
    assert cp_axes(Mesh(data=1, model=2, context=2)) == ("context", None)
    assert cp_axes(Mesh(data=4, model=1), ("context", "data")) == ("context", "data")
    assert shard_layout(37, 4, 4, 1, 0) == (12, [((0, 12), (0, 12)), ((12, 24), (8, 24)),
                                                 ((24, 36), (20, 36)), ((36, 37), (32, 37))])
    # frames past the sequence leave a rank empty: it needs no key
    assert shard_layout(9, 4, 4, 2, 1)[1][3] == ((9, 9), (9, 9))


class _Virtual(AxisComm):
    """Rank ``rank`` of an axis of virtual ranks in one process: the other
    ranks' k and v are slices of the whole sequence's (``whole``: the
    layer's own projection of every token); the gather keeps this rank's
    rows; nothing is summed."""

    def __init__(self, layout, per, rank, whole):
        super().__init__(None, len(layout), rank, layout, per)
        self.whole = whole

    def replicated(self, *xs):
        return xs

    def halo(self, k, v):
        (lo, hi), (k_lo, k_hi) = self.layout[self.rank]
        return tuple(torch.cat([w[:, :, k_lo:lo], own, w[:, :, hi:k_hi]], dim=2)
                     for w, own in zip(self.whole, (k, v)))

    def gather(self, out):
        return out


def _virtual_cp(mod, x, size):
    """Every virtual rank's ``cp_step`` on an axis of ``size`` ranks, its
    rows assembled: bos from rank 0, then each rank's own."""
    t = x.shape[1] - 1
    _, fh, fw = mod.video_shape
    whole = [split_heads(u, mod.heads)[:, :, 1:] for u in mod.to_kv(x).chunk(2, dim=-1)]
    per, layout = shard_layout(t, fh * fw, size, *frame_reach(mod))
    rows = [cp_step(mod, x, _Virtual(layout, per, r, whole)) for r in range(size)]
    # a rank that owns no frame gives bos alone
    assert all(r.shape[1] == 1 + hi - lo for r, ((lo, hi), _) in zip(rows, layout))
    return torch.cat([rows[0][:, :1]] + [r[:, 1:] for r in rows], dim=1)


# the JAX package's CP tests: (video shape, kernel, dilation, causal, bias, [(b, t)])
CONFIGS = {
    "nondivisible_frames": ((10, 2, 2), 3, 1, True, True, [(2, 40), (2, 37)]),
    "bos_only": ((8, 2, 2), 3, 1, True, False, [(2, 0)]),
    "centered_encoder": ((8, 2, 2), 3, 2, False, True, [(2, 32), (1, 29)]),
    "single_device_parity": ((8, 2, 2), 3, 1, True, True, [(2, 32)]),
    "multihop_halo": ((8, 2, 2), 3, 2, True, False, [(1, 32)]),
    # 5 frames leave the last of 4 ranks empty
    "empty_rank": ((5, 2, 2), 3, 1, True, True, [(2, 20), (2, 19)]),
}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cp_step_matches_jax_context_parallel(name, size):
    shape, kernel, dilation, causal, bias, inputs = CONFIGS[name]
    kw = dict(dim=16, video_shape=shape, kernel_size=kernel, dilation=dilation, heads=2,
              dim_head=8, causal=causal, rel_pos_bias=bias)
    jmod = JSparse3DNA(**kw)
    p = jmod.init(jax.random.PRNGKey(0))
    mod = load_jax_params(Sparse3DNA(**kw), jax.tree.map(np.asarray, p))
    mesh = jax_make_mesh(data=size, model=1, devices=jax.devices()[:size])
    for i, (b, t) in enumerate(inputs):
        x = np.random.default_rng(i).standard_normal((b, 1 + t, 16)).astype(np.float32)
        # a bos-only input takes the module's early return, which JAX's CP
        # function (a division by the frames) leaves to it
        want = np.asarray(jmod(p, x, cp_mesh=mesh) if t == 0 else jax.jit(
            lambda p, x: jax_context_parallel(jmod, p, x, mesh, axis="data"))(p, x))
        with torch.no_grad():
            got = (mod(torch.from_numpy(x)) if t == 0
                   else _virtual_cp(mod, torch.from_numpy(x), size)).numpy()
        np.testing.assert_allclose(got, want, atol=REL * np.abs(want).max(), rtol=0)
