"""The query tiles of the SparseCross2DNA query-side backward kernel, on the
CPU.

``kernels.cross.launch_plan`` plans the kernel's launch by the Sparse3DNA
kernels' rule (``kernels.nda.tile_plan`` with which = "cross_bwd_q") from
its own candidates (``kernels.cross.TILES``, 2 x 4 and then
``kernels.nda.TILES``): a
block owns a tile of query positions of one video frame with all heads, and
the wrapper's buffer of per-tile sums (dth, dnull_k, dnull_v) has one slot a
block of the plan's grid. These tests hold the plan against a twin of the
kernel's rule (``tile_view`` and ``tile_query`` of
``csrc/sparse3dna_tile.cuh``) written here with numpy: the grid's tiles
cover every video query exactly once at the repo's sketch shapes, and the
shared memory asked for fits the card. No JAX.
"""
import numpy as np
import pytest
import torch

from nuwa_tpu_torch.kernels import cross as kcross
from nuwa_tpu_torch.kernels import nda as knda

FMAP = 16  # the sketch models' frames: 64 px through a codec of two layers


def _queries(plan, t, fmap):
    """Each (block, query of its tile)'s video token, or -1 outside the
    frame or at or past t."""
    ty, tx, tiles_y, tiles_x = (plan[k] for k in ("ty", "tx", "tiles_y", "tiles_x"))
    blk, qi = np.meshgrid(np.arange(plan["blocks"]), np.arange(ty * tx), indexing="ij")
    f, ti = blk // (tiles_y * tiles_x), blk % (tiles_y * tiles_x)
    y, x = ti // tiles_x * ty + qi // tx, ti % tiles_x * tx + qi % tx
    tok = (f * fmap + y) * fmap + x
    return np.where((y < fmap) & (x < fmap) & (tok < t), tok, -1)


# (b, video queries, context frames): the sketch forward's 5 frames and the
# training step's 10 less bos (a ragged last frame), at one and two sketch
# frames, and one query
SHAPES = [(2, 1280, 1), (2, 1280, 2), (2, 2559, 1), (2, 2559, 2), (1, 1, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tiles", [None, ((2, 4, 0),), ((4, 4, 0),), ((1, 1, 0),)])
def test_cross_tiles_cover_every_query_once(dtype, tiles):
    """At each sketch shape, 8 heads of 64, the rule's tile (and each forced
    one) serves every video query exactly once, the grid (and with it the
    buffer of per-tile sums) has the plan's blocks, and the shared memory
    fits an H100's 232,448 bytes a block."""
    for b, t, frames in SHAPES:
        q = torch.empty(b, 8, t, 64, dtype=dtype)
        lc = frames * FMAP * FMAP
        plan = kcross.launch_plan(q, lc, fmap=FMAP, kernel_size=3, dilation=1, tiles=tiles)
        # the first candidate whose grid gives every SM FILL blocks, else the last
        fill = 0 if tiles else knda.FILL
        fits = [(ty, tx, st) for ty, tx, st in tiles or kcross.TILES
                if b * -(-t // FMAP**2) * -(-FMAP // ty) * -(-FMAP // tx) >= fill * knda.SMS]
        assert (plan["ty"], plan["tx"], plan["stage"]) == (fits or (tiles or kcross.TILES)[-1:])[0]
        assert plan["tiles_y"] == -(-FMAP // plan["ty"])
        assert plan["tiles_x"] == -(-FMAP // plan["tx"])
        assert plan["blocks"] == -(-t // FMAP**2) * plan["tiles_y"] * plan["tiles_x"]
        tok = _queries(plan, t, FMAP)
        assert np.array_equal(np.sort(tok[tok >= 0]), np.arange(t))
        assert plan["smem"] <= knda.SMEM_LIMIT and plan["threads"] % 32 == 0
        assert plan["off_bias"] == plan["off_lse"]  # no bias table
        slots = frames * 9 + 1
        assert plan["off_s2"] - plan["off_s"] >= 4 * 8 * plan["ty"] * plan["tx"] * slots


def test_cross_plan_refuses_a_staged_tile():
    """The cross query side reads its rows through L1 only."""
    q = torch.empty(2, 8, 1280, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kcross.launch_plan(q, 256, fmap=FMAP, kernel_size=3, dilation=1, tiles=((2, 2, 2),))
