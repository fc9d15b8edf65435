"""The tiles of the Sparse3DNA kernels, on the CPU: queries of the forward
and query-side kernels, keys of the key side.

``kernels.nda.tile_plan`` chooses each launch's tile, whether each head's
window union of key and value rows is staged in shared memory, and lays out
that memory; the kernels find a block's queries (or keys) and the union from
the plan (``csrc/sparse3dna_tile.cuh``: ``tile_view``, ``tile_query``,
``union_index``, ``union_token``), and the key side each key's pairs by
``reader`` and ``reader_slot`` (``csrc/sparse3dna_geometry.cuh``). These
tests hold the plan against twins of those rules written here with numpy:
the grid's tiles cover every query (or key) of the sequence exactly once,
the query-side kernel's buffer of per-tile sums has one slot a block, every
valid neighbour of every query lies in its tile's staged union, every valid
(query, slot) pair lies in its key's pair table exactly once, and the
shared memory asked for fits the card. No JAX.
"""
import itertools

import numpy as np
import pytest

from nuwa_tpu_torch.kernels import nda as knda

# (b, t, fmap, kernel, dilation, mode) of the repo's configurations: NUWA
# serving (fmap 8) and training (fmap 16, dilations 1, 2 and 4), NUWA at
# 128 px (fmap 32), the centered sketch encoder, NUWAVideoAudio's audio
# geometry (H = 4 and 1) and the frames of the card tests (fmap 4, 12, 20
# and 32 x 9, anisotropic dilations)
GEOMETRIES = (
    [(b, t, (8, 8), (3, 3, 3), (dl,) * 3, "causal")
     for (b, t), dl in itertools.product(((1, 256), (2, 191), (16, 191), (8, 16)), (1, 2))]
    + [(2, 2559, (16, 16), (5, 3, 3), (dl,) * 3, "causal") for dl in (1, 2, 4)]
    + [(2, 10239, (32, 32), (5, 3, 3), (2, 2, 2), "causal"),
       (2, 511, (16, 16), (5, 3, 3), (1, 1, 1), "centered"),
       (2, 511, (16, 16), (5, 3, 3), (2, 2, 2), "centered")]
    + [(b, t, (1, h), (7, 1, h), (dl, 1, 1), "audio")
       for b, t, h, dl in ((1, 128, 4, 1), (1, 127, 4, 2), (2, 96, 1, 1))]
    + [(2, 37, (4, 4), (3, 5, 3), (2, 1, 2), "causal"),
       (2, 2 * 144 - 1, (12, 12), (5, 3, 3), (4, 4, 4), "causal"),
       (2, 3 * 400 - 200, (20, 20), (5, 3, 3), (1, 2, 2), "causal"),
       (2, 3 * 288 - 1, (32, 9), (5, 3, 3), (1, 2, 2), "centered"),
       (2, 3 * 108 - 50, (12, 9), (3, 3, 3), (2, 1, 3), "centered")]
)


def _blocks(plan, t, fmap):
    """(frame, y, x, token or -1) of every (block, query of its tile) by the
    rule of tile_view and tile_query."""
    fh, fw = fmap
    ty, tx, tiles_y, tiles_x = (plan[k] for k in ("ty", "tx", "tiles_y", "tiles_x"))
    blk, qi = np.meshgrid(np.arange(plan["blocks"]), np.arange(ty * tx), indexing="ij")
    f, ti = blk // (tiles_y * tiles_x), blk % (tiles_y * tiles_x)
    y, x = ti // tiles_x * ty + qi // tx, ti % tiles_x * tx + qi % tx
    tok = (f * fh + y) * fw + x
    return f, y, x, np.where((y < fh) & (x < fw) & (tok < t), tok, -1)


def _check_tiles(plan, t, fmap):
    """Each token below t is one block's query exactly once, and the grid
    (and with it the query-side kernel's buffer of sums) has the plan's
    blocks."""
    fh, fw = fmap
    assert plan["tiles_y"] == -(-fh // plan["ty"]) and plan["tiles_x"] == -(-fw // plan["tx"])
    assert plan["blocks"] == -(-t // (fh * fw)) * plan["tiles_y"] * plan["tiles_x"]
    tok = _blocks(plan, t, fmap)[3]
    assert np.array_equal(np.sort(tok[tok >= 0]), np.arange(t))


def _centre(k, mode):
    return k - 1 if mode != "centered" else (k - 1) // 2


def _axis_index(pos, n, dl):
    return pos if n >= dl else pos // dl * n + pos % dl


def _axis_position(i, n, dl):
    return i if n >= dl else i // n * dl + i % n


def _check_union(plan, t, fmap, kernel, dilation, mode):
    """Where the plan stages: every valid neighbour of every query (the rule
    of ``neighbour``) has a union index (``union_index``) below the union's
    rows, and the union row there holds that neighbour (``union_token``)."""
    if not plan["stage"]:
        return
    fh, fw = fmap
    kf, kh, kw = kernel
    df, dh, dw = dilation
    ty, tx, uy, ux = (plan[k] for k in ("ty", "tx", "uy", "ux"))
    rows = kf * uy * ux
    f, y, x, tok = _blocks(plan, t, fmap)
    f0, y0, x0 = f[:, :1], y[:, :1], x[:, :1]  # each block's tile origin
    qi = np.arange(ty * tx)[None, :]
    for j in range(kf * kh * kw):
        a, r = j // (kh * kw), j % (kh * kw)
        nf = f + (a - _centre(kf, mode)) * df
        ny = y + (r // kw - _centre(kh, mode)) * dh
        nx = r % kw if mode == "audio" else x + (r % kw - _centre(kw, mode)) * dw
        ntok = (nf * fh + ny) * fw + nx
        valid = ((tok >= 0) & (nf >= 0) & (ny >= 0) & (ny < fh) & (nx >= 0) & (nx < fw)
                 & (ntok < t))
        cy = _axis_index(qi // tx + r // kw * dh, ty, dh)
        cx = r % kw if mode == "audio" else _axis_index(qi % tx + r % kw * dw, tx, dw)
        u = np.broadcast_to((a * uy + cy) * ux + cx, valid.shape)
        assert (u[valid] < rows).all() and (u >= 0).all()
        # union_token of u, from the tile's origin
        ua, ucy, ucx = u // (uy * ux), u // ux % uy, u % ux
        uf = f0 + (ua - _centre(kf, mode)) * df
        uyy = y0 + _axis_position(ucy, ty, dh) - _centre(kh, mode) * dh
        uxx = (ucx if mode == "audio"
               else x0 + _axis_position(ucx, tx, dw) - _centre(kw, mode) * dw)
        utok = np.broadcast_to((uf * fh + uyy) * fw + uxx, valid.shape)
        assert np.array_equal(utok[valid], ntok[valid])


def _neighbour(f, y, x, j, fmap, kernel, dilation, mode, t):
    """Token of the neighbour of (f, y, x) through window slot j, or -1: the
    rule of ``neighbour``."""
    (fh, fw), (kf, kh, kw), (df, dh, dw) = fmap, kernel, dilation
    a, r = j // (kh * kw), j % (kh * kw)
    nf = f + (a - _centre(kf, mode)) * df
    ny = y + (r // kw - _centre(kh, mode)) * dh
    nx = r % kw if mode == "audio" else x + (r % kw - _centre(kw, mode)) * dw
    tok = (nf * fh + ny) * fw + nx
    return np.where((nf >= 0) & (ny >= 0) & (ny < fh) & (nx >= 0) & (nx < fw) & (tok < t),
                    tok, -1)


def _reader(f, y, x, p, fmap, kernel, dilation, mode, t):
    """(query token or -1, slot) of pair p of the key (f, y, x): the rules of
    ``reader`` and ``reader_slot``."""
    (fh, fw), (kf, kh, kw), (df, dh, dw) = fmap, kernel, dilation
    a, r = p // (kh * kw), p % (kh * kw)
    qf = f - (a - _centre(kf, mode)) * df
    qy = y - (r // kw - _centre(kh, mode)) * dh
    qx = r % kw if mode == "audio" else x - (r % kw - _centre(kw, mode)) * dw
    tok = (qf * fh + qy) * fw + qx
    valid = (qf >= 0) & (qy >= 0) & (qy < fh) & (qx >= 0) & (qx < fw) & (tok < t)
    return np.where(valid, tok, -1), (p - p % kw + x) if mode == "audio" else p


def _check_pairs(plan, t, fmap, kernel, dilation, mode):
    """The key side's pair tables: each tile key's Kn pairs in reader order
    name a query that reads that key through the pair's slot, and the
    tables of all keys hold every valid (query, slot) pair of the sequence
    exactly once."""
    fh, fw = fmap
    kn = kernel[0] * kernel[1] * kernel[2]
    f, y, x, key = _blocks(plan, t, fmap)
    pairs = []
    for p in range(kn):
        query, slot = _reader(f, y, x, p, fmap, kernel, dilation, mode, t)
        query = np.where(key >= 0, query, -1)
        slot = np.broadcast_to(slot, query.shape)
        ok = query >= 0
        qf, qy, qx = query // (fh * fw), query // fw % fh, query % fw
        got = _neighbour(qf, qy, qx, slot, fmap, kernel, dilation, mode, t)
        assert np.array_equal(got[ok], key[ok])
        pairs.append(query[ok].astype(np.int64) * kn + slot[ok])
    pairs = np.concatenate(pairs)
    assert len(np.unique(pairs)) == len(pairs)
    assert len(pairs) == knda.valid_pairs(t, fmap, kernel, dilation, mode)


def _check_layout(plan, fits=True):
    assert plan["smem"] <= knda.SMEM_LIMIT or not fits
    assert plan["threads"] <= 512 and plan["threads"] % 32 == 0
    assert plan["threads"] % plan["group"] == 0 and plan["group"] & (plan["group"] - 1) == 0
    offsets = [plan[f] for f in knda.PLAN_FIELDS if f.startswith("off_")]
    assert offsets == sorted(offsets) and all(o % 16 == 0 for o in offsets)
    assert offsets[-1] <= plan["smem"]


@pytest.mark.parametrize("which", ["fwd", "bwd_q", "bwd_kv"])
def test_tiles_cover_every_query_once(which):
    """Each geometry of the repo's configs, 8 heads of 64: the rule's plan
    (bf16 and fp32) and each staged tile that fits the frame (the forward's:
    both kernels stage the same union) serve every
    query exactly once, every valid neighbour lies in the staged union, and
    the rule's shared memory fits an H100's 232,448 bytes a block; the key
    side's tiles serve every key exactly once and hold every valid pair in
    their keys' pair tables."""
    for b, t, fmap, kernel, dilation, mode in GEOMETRIES:
        for es in (2, 4):
            plan = knda.tile_plan(which, b, 8, t, 64, es, fmap, kernel, dilation, mode, True)
            _check_layout(plan)
            _check_tiles(plan, t, fmap)
        if which == "bwd_kv":
            _check_pairs(plan, t, fmap, kernel, dilation, mode)
        for ty, tx in ((4, 4), (2, 4), (2, 2), (1, 2), (1, 1)):
            if ty > fmap[0] or tx > fmap[1] or which != "fwd":  # the union is the kernels' own
                continue
            plan = knda.tile_plan(which, b, 8, t, 64, 2, fmap, kernel, dilation, mode, True,
                                  tiles=((ty, tx, 2),), fill=0)
            _check_layout(plan, fits=False)
            _check_tiles(plan, t, fmap)
            _check_union(plan, t, fmap, kernel, dilation, mode)


@pytest.mark.parametrize("tile", [(8, 8, 2), (4, 8, 2), (4, 4, 3), (2, 4, 4), (2, 2, 2),
                                  (1, 2, 3), (1, 1, 4), (2, 2, 0), (1, 1, 0)])
def test_each_tile_shape_covers_every_query(tile):
    """Tile shapes beyond the rule's own, staged in rings of 2-4 buffers and
    not staged, forced at fmap 12
    and 12 x 9 (ragged tiles at the frame's edge), a ragged last frame, and
    dilations from 1 to 4, anisotropic, causal and centered."""
    for fmap, t, dilation, mode in (((12, 12), 2 * 144 - 7, (2, 2, 2), "causal"),
                                    ((12, 9), 3 * 108 - 50, (1, 4, 3), "centered"),
                                    ((12, 12), 2 * 144 - 1, (2, 1, 4), "causal")):
        plan = knda.tile_plan("bwd_q", 2, 2, t, 16, 2, fmap, (5, 3, 3), dilation, mode, True,
                              tiles=(tile,), fill=0)
        assert (plan["ty"], plan["tx"], plan["stage"]) == tile
        _check_layout(plan)
        _check_tiles(plan, t, fmap)
        _check_union(plan, t, fmap, (5, 3, 3), dilation, mode)


@pytest.mark.parametrize("tile", [(1, 1), (1, 2), (2, 2), (1, 4), (2, 4), (4, 4), (4, 8)])
def test_each_key_tile_holds_every_pair(tile):
    """The key side's tiles forced at fmap 12 and 12 x 9 (ragged tiles at the
    frame's edge), a ragged last frame, dilations from 1 to 4, anisotropic,
    causal and centered, and the audio geometry at H = 4: every key served
    once and every valid pair in its key's table; a staged tile refused."""
    for fmap, kernel, t, dilation, mode in (
            ((12, 12), (5, 3, 3), 2 * 144 - 7, (2, 2, 2), "causal"),
            ((12, 9), (5, 3, 3), 3 * 108 - 50, (1, 4, 3), "centered"),
            ((12, 12), (5, 3, 3), 2 * 144 - 1, (2, 1, 4), "causal"),
            ((1, 4), (7, 1, 4), 38, (2, 1, 1), "audio")):
        plan = knda.tile_plan("bwd_kv", 2, 2, t, 16, 2, fmap, kernel, dilation, mode, True,
                              tiles=((*tile, 0),), fill=0)
        if tile[0] <= fmap[0] and tile[1] <= fmap[1]:
            assert (plan["ty"], plan["tx"]) == tile
        _check_layout(plan)
        _check_tiles(plan, t, fmap)
        _check_pairs(plan, t, fmap, kernel, dilation, mode)
    with pytest.raises(ValueError):
        knda.tile_plan("bwd_kv", 2, 2, 287, 16, 2, (12, 12), (5, 3, 3), (2, 2, 2), "causal",
                       True, tiles=((*tile, 2),), fill=0)


def test_every_input_the_kernels_took_still_has_a_plan():
    """Heads 1-32 (17: a block of a whole number of warps), head dims 1-256,
    both types, 16-byte rows or not, kernels up to 225 slots: a plan exists
    and fits wherever the first design's shared memory did (4 * (h*h +
    2*h*(Kn+1)) + 4*Kn bytes for the forward, 4 * (2*h*h + 5*h*(Kn+1) +
    h*Kn) + 4*Kn for the query side, 4*Kn for the key side)."""
    for h, d, es, kernel in itertools.product((1, 8, 17, 32), (1, 37, 64, 128, 256), (2, 4),
                                              ((3, 3, 3), (7, 1, 32), (1, 15, 15))):
        audio = kernel == (7, 1, 32)
        fmap, mode = ((1, 32), "audio") if audio else ((8, 8), "causal")
        dilation = (1, 1, 1) if audio else (1, 2, 2)
        kn = kernel[0] * kernel[1] * kernel[2]
        old = {"fwd": 4 * (h * h + 2 * h * (kn + 1)) + 4 * kn,
               "bwd_q": 4 * (2 * h * h + 5 * h * (kn + 1) + h * kn) + 4 * kn,
               "bwd_kv": 4 * kn}
        for which in ("fwd", "bwd_q", "bwd_kv"):
            if old[which] > knda.SMEM_LIMIT:
                continue
            plan = knda.tile_plan(which, 1, h, 300, d, es, fmap, kernel, dilation, mode,
                                  (d * es) % 16 == 0)
            _check_layout(plan)
