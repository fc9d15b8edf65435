"""The tiles of the SparseCross2DNA kernels, on the CPU.

``kernels.cross.launch_plan`` plans each kernel's launch by the Sparse3DNA
kernels' rule (``kernels.nda.tile_plan``) from its own candidates. The
query side (which = "cross_bwd_q", ``kernels.cross.TILES``, 2 x 4 and then
``kernels.nda.TILES``): a block owns a tile of query positions of one video
frame with all heads, and the wrapper's buffer of per-tile sums (dth,
dnull_k, dnull_v) has one slot a block of the plan's grid. The forward
(which = "cross_fwd", ``kernels.cross.FWD_TILES``): a tile of query
positions of ``tf`` video frames with all heads. The key side (which =
"cross_bwd_kv", ``kernels.cross.KV_TILES``): a tile of keys of one context
frame with ``hs`` heads, each key walking its reflected window over every
query frame. These tests hold the plans against twins of the kernels' rules
(``tile_view`` and ``tile_query`` of ``csrc/sparse3dna_tile.cuh``,
``cross_tile_query``, ``cross_key_tile`` and the key side's pair walk of
``csrc/sparse_cross2dna_geometry.cuh`` and ``sparse_cross2dna_bwd_kv.cu``)
written here with numpy: the grid's tiles cover every video query, and every
(head, context key), exactly once, every valid (query, slot) pair lies in
its key's walk exactly once, and the shared memory asked for fits the card.
No JAX.
"""
import numpy as np
import pytest
import torch

from nuwa_tpu_torch.kernels import cross as kcross
from nuwa_tpu_torch.kernels import nda as knda

FMAP = 16  # the sketch models' frames: 64 px through a codec of two layers


def _queries(plan, t, fmap):
    """Each (block, query of its tile)'s video token, or -1 outside the
    frame or at or past t; a tile of tf frames numbers its queries frame by
    frame (``cross_tile_query``)."""
    ty, tx, tiles_y, tiles_x, tf = (plan[k] for k in ("ty", "tx", "tiles_y", "tiles_x", "tf"))
    blk, qi = np.meshgrid(np.arange(plan["blocks"]), np.arange(tf * ty * tx), indexing="ij")
    f = blk // (tiles_y * tiles_x) * tf + qi // (ty * tx)
    ti, r = blk % (tiles_y * tiles_x), qi % (ty * tx)
    y, x = ti // tiles_x * ty + r // tx, ti % tiles_x * tx + r % tx
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


def _check_plan(plan):
    assert plan["smem"] <= knda.SMEM_LIMIT and plan["threads"] % 32 == 0
    assert plan["threads"] <= 256 and plan["threads"] % plan["group"] == 0
    offsets = [plan[f] for f in knda.PLAN_FIELDS if f.startswith("off_")]
    assert offsets == sorted(offsets) and all(o % 16 == 0 for o in offsets)
    assert offsets[-1] <= plan["smem"]


# (b, video queries, context frames, fmap, dilation): the sketch shapes, one
# query, three context frames, dilation 2, a ragged last frame and frames
# narrower than a 2 x 4 tile (fmap 4) or ragged at its edge (fmap 5)
CASES = [*SHAPES, (2, 1280, 3, 16, 2), (1, 5 * 16 - 3, 2, 4, 1), (2, 37, 3, 4, 2),
         (1, 3 * 25 - 1, 1, 5, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tiles", [None, ((2, 4, 0, 1),), ((2, 4, 0, 2),), ((1, 2, 0, 3),),
                                   ((8, 8, 0, 2), (2, 2, 0)), ((1, 1, 0),)])
def test_cross_fwd_tiles_cover_every_query_once(dtype, tiles):
    """The forward's rule (and each forced tile, frame-spanning ones among
    them) serves every video query exactly once at the sketch shapes and at
    t = 1, Fc 1-3, dilations 1 and 2 and fmap 4 and 5; its query frames
    share one slot table; the shared memory fits. The rule takes the first
    of ``FWD_TILES`` whose grid gives every SM ``FWD_FILL`` blocks: 2 x 2
    positions of two query frames at the sketch training shape, of one at
    the forward shape."""
    for case in CASES:
        b, t, frames, fmap, dil = (*case, FMAP, 1)[:5] if len(case) == 3 else case
        q = torch.empty(b, 8, t, 64, dtype=dtype)
        plan = kcross.launch_plan(q, frames * fmap**2, fmap=fmap, kernel_size=3, dilation=dil,
                                  tiles=tiles, which="cross_fwd")
        fits = [tile for tile in tiles or kcross.FWD_TILES if tile[0] <= fmap and tile[1] <= fmap]
        frames_q = -(-t // fmap**2)
        if not tiles:  # the first that fills the card
            fits = [tile for tile in fits if b * -(-frames_q // tile[3]) * -(-fmap // tile[0])
                    * -(-fmap // tile[1]) >= kcross.FWD_FILL * knda.SMS]
        want = (fits or (tiles or kcross.FWD_TILES)[-1:])[0]  # else the last
        assert (plan["ty"], plan["tx"], plan["tf"]) == (*want[:2], (want[3:] or (1,))[0])
        if (b, t, fmap) == (2, 2559, FMAP) and not tiles:
            assert (plan["ty"], plan["tx"], plan["tf"]) == (2, 2, 2)
        assert plan["blocks"] == (-(-frames_q // plan["tf"]) * plan["tiles_y"]
                                  * plan["tiles_x"])
        tok = _queries(plan, t, fmap)
        assert np.array_equal(np.sort(tok[tok >= 0]), np.arange(t))
        _check_plan(plan)
        assert plan["hs"] == 8
        slots = frames * 9 + 1
        tq = plan["tf"] * plan["ty"] * plan["tx"]
        assert plan["off_nb"] - plan["off_s"] >= 4 * 8 * tq * slots
        assert plan["off_qtok"] - plan["off_nb"] >= 4 * plan["ty"] * plan["tx"] * (slots - 1)


def _reads(t, frames, fmap, dil, k=3):
    """{(key, query, slot)} of every valid pair, from the query side: the
    twin of ``cross_neighbour`` (no mask), slot j + 1 of the row."""
    half, hw = (k - 1) // 2, fmap * fmap
    tok = np.arange(t)
    y, x = tok % hw // fmap, tok % fmap
    out = []
    for j in range(frames * k * k):
        c, r = j // (k * k), j % (k * k)
        ny, nx = y + (r // k - half) * dil, x + (r % k - half) * dil
        ok = (ny >= 0) & (ny < fmap) & (nx >= 0) & (nx < fmap)
        key = (c * fmap + ny) * fmap + nx
        out += zip(key[ok].tolist(), tok[ok].tolist(), [j + 1] * int(ok.sum()))
    return out


def _walk(plan, h, t, lc, fmap, dil, k=3):
    """{(head, key): [(query, slot), ...]} of every group's walk, as the key
    side runs it: the tiles of the grid (``cross_key_tile``), each key's
    compacted reflected window, and group sub of the unit's gpu walking
    pairs m = sub, sub + gpu, ... of m = f * nj + n, (f, n) tracked without
    a division, kAxpyBatch pairs a batch; a pair at or past t is skipped."""
    ty, tx, tiles_y, tiles_x, hs = (plan[f] for f in ("ty", "tx", "tiles_y", "tiles_x", "hs"))
    hw, kk, half = fmap * fmap, k * k, (k - 1) // 2
    frames = -(-t // hw)
    tiles, hblocks = tiles_y * tiles_x, -(-h // hs)
    units = hs * ty * tx
    gpu = max(1, plan["threads"] // plan["group"] // units)
    walks = {}
    for blk in range(plan["blocks"]):
        hb, rest = blk % hblocks, blk // hblocks
        c, ti = rest // tiles, rest % tiles
        h0 = hb * hs
        for ki in range(ty * tx):
            y, x = ti // tiles_x * ty + ki // tx, ti % tiles_x * tx + ki % tx
            if y >= fmap or x >= fmap:
                continue
            table = []
            for j in range(kk):
                qy, qx = y - (j // k - half) * dil, x - (j % k - half) * dil
                if 0 <= qy < fmap and 0 <= qx < fmap:
                    table.append((qy * fmap + qx, 1 + c * kk + j))
            nj = len(table)
            key = (c * fmap + y) * fmap + x
            for a in range(h0, min(h, h0 + hs)):
                pairs = walks.setdefault((a, key), [])
                for sub in range(gpu):
                    f, n = 0, sub
                    while n >= nj:
                        n, f = n - nj, f + 1
                    while f < frames:
                        for _ in range(4):
                            if f < frames:
                                tk = f * hw + table[n][0]
                                if tk < t:
                                    pairs.append((tk, table[n][1]))
                                n += gpu
                                while n >= nj:
                                    n, f = n - nj, f + 1
    return walks


@pytest.mark.parametrize("tiles", [None, ((2, 4, 0, 1),), ((2, 4, 0, 2),), ((4, 4, 0, 3),),
                                   ((8, 8, 0, 1), (1, 4, 0, 8)), ((1, 1, 0),)])
def test_cross_bwd_kv_tiles_serve_every_key_once(tiles):
    """The key side's rule (and each forced tile and head split) serves
    every (head, context key) exactly once, and its walks hold every valid
    (query, slot) pair of the key exactly once, checked against the query
    side's window; at one and two context frames of fmap 4 and 5 (frames
    narrower than a tile, ragged tiles), t = 1, a ragged last frame, Fc 1-3,
    dilations 1 and 2 and 3 or 8 heads (a head split that leaves the last
    block fewer heads). The sketch shapes' plans in ``test_cross_bwd_kv_plans``."""
    for b, t, frames, fmap, dil, h in ((2, 1, 2, 4, 1, 8), (1, 5 * 16 - 3, 2, 4, 1, 3),
                                       (2, 37, 3, 4, 2, 8), (1, 3 * 25 - 1, 1, 5, 2, 3),
                                       (1, 2 * 25, 2, 5, 1, 8)):
        lc = frames * fmap**2
        q = torch.empty(b, h, t, 64, dtype=torch.bfloat16)
        plan = kcross.launch_plan(q, lc, fmap=fmap, kernel_size=3, dilation=dil, tiles=tiles,
                                  which="cross_bwd_kv")
        if tiles:
            fits = [tile for tile in tiles if tile[0] <= fmap and tile[1] <= fmap]
            want = (fits or tiles[-1:])[0]
            assert (plan["ty"], plan["tx"], plan["hs"]) == (*want[:2],
                                                            min(h, (want[3:] or (0,))[0] or h))
        _check_plan(plan)
        walks = _walk(plan, h, t, lc, fmap, dil)
        assert sorted(walks) == [(a, key) for a in range(h) for key in range(lc)]
        want = {}
        for key, query, slot in _reads(t, frames, fmap, dil):
            want.setdefault(key, []).append((query, slot))
        for (a, key), pairs in walks.items():
            assert sorted(pairs) == sorted(want.get(key, [])), (a, key)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_bwd_kv_plans(dtype):
    """At the sketch shapes the key side's rule splits the heads, one a
    block, and takes the first tile whose grid gives every SM FILL blocks
    (4 x 4 keys at two context frames, 2 x 4 at one); its grid serves every
    (head, context key) once; every valid (query, slot) pair of the window
    reflected over every query frame is counted once, in closed form: F * nj
    pairs a key less the ragged frame's."""
    for b, t, frames in SHAPES:
        lc = frames * FMAP**2
        q = torch.empty(b, 8, t, 64, dtype=dtype)
        plan = kcross.launch_plan(q, lc, fmap=FMAP, kernel_size=3, dilation=1,
                                  which="cross_bwd_kv")
        cands = [(ty, tx, hs) for ty, tx, _, hs in kcross.KV_TILES]
        fits = [(ty, tx, hs) for ty, tx, hs in cands
                if b * frames * -(-FMAP // ty) * -(-FMAP // tx) * 8 // hs >= knda.FILL * knda.SMS]
        assert (plan["ty"], plan["tx"], plan["hs"]) == (fits or cands[-1:])[0]
        if b == 2 and t > 1:
            assert plan["tx"] >= 3  # a query's dS and mix values shared along x
        _check_plan(plan)
        assert plan["blocks"] == frames * plan["tiles_y"] * plan["tiles_x"] * 8
        keys = _queries(dict(plan, tf=1, blocks=frames * plan["tiles_y"] * plan["tiles_x"]),
                        lc, FMAP)
        assert np.array_equal(np.sort(keys[keys >= 0]), np.arange(lc))
        # each key's pairs: its in-frame window positions in every query
        # frame, less those at or past t
        pos = np.arange(FMAP**2)
        y, x = pos // FMAP, pos % FMAP
        total = 0
        for j in range(9):
            qy, qx = y - (j // 3 - 1), x - (j % 3 - 1)
            ok = (qy >= 0) & (qy < FMAP) & (qx >= 0) & (qx < FMAP)
            qpos = (qy * FMAP + qx)[ok]
            total += sum(int((f * FMAP**2 + qpos < t).sum()) for f in range(-(-t // FMAP**2)))
        assert frames * total == len(_reads(t, frames, FMAP, 1))


@pytest.mark.parametrize("which,tile", [("cross_fwd", (2, 2, 2)), ("cross_bwd_kv", (2, 4, 3)),
                                        ("cross_bwd_q", (2, 4, 0, 2)),
                                        ("cross_fwd", (2, 4, 0, 2, 1))])
def test_cross_plans_refuse_what_their_kernels_do_not_take(which, tile):
    """No cross kernel stages a window union; only the forward takes query
    frames, and only the key side a head split."""
    q = torch.empty(2, 8, 1280, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kcross.launch_plan(q, 256, fmap=FMAP, kernel_size=3, dilation=1, tiles=(tile,),
                           which=which)
