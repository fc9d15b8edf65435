"""Sparse3DNA attention: the Hopper kernels' wrappers, their plain versions
and the autograd function that joins them.

Three kernels, each replacing two TPU kernels of
``nuwa_tpu/kernels/nda_pallas.py``, with or without attention dropout, in
three geometries:
causal windows (the video decoder), centered ones (the sketch encoder), and
the audio geometry of ``SparseCausal2DNA`` (``mode="audio"``): a grid of
(timesteps, 1, H) with ``fmap=(1, H)``, ``kernel=(K, 1, H)`` and
``dilation=(d, 1, 1)``, causal in time, whose window on the width axis is
the whole timestep (the absolute columns 0..H-1, mode ``"full"`` of
``nuwa_tpu/nda.py``), so a query also sees the later tokens of its own
timestep, as the JAX module's forward does. In the audio geometry they
replace the six as ``_audio_core_op`` and ``_audio_rb_core_op`` run them;
there a key is read through one slot of each time tap by all H queries of a
timestep, so the key side's inverse neighbourhood is not the reflected
window (``csrc/sparse3dna_geometry.cuh`` holds both rules).
The JAX package takes the whole-frame kernels for frames of up to 256
tokens and the row-blocked ones above that (``rb_row_block``); each kernel
here takes a frame of any size:

* ``sparse_3dna_fwd`` (``csrc/sparse3dna_fwd.cu``): the forward, out and the
  per-row logsumexp; replaces ``_kernel`` (launched by ``_fwd_call``) and
  the row-blocked ``_rb_kernel`` (``_rb_fwd_call``);
* ``sparse_3dna_bwd_q`` (``csrc/sparse3dna_bwd_q.cu``): the query-side
  backward, dq, the bos, talking-heads and rel-pos bias cotangents, and the
  sparse dS and mixed probabilities; replaces ``_bwd_q_kernel`` and
  ``_rb_bwd_q_kernel``;
* ``sparse_3dna_bwd_kv`` (``csrc/sparse3dna_bwd_kv.cu``): the key-side
  backward, dk and dv gathered from dS and the mixed probabilities; replaces
  ``_bwd_kv_kernel`` and ``_rb_bwd_kv_kernel``.

The row-blocked family tiles a frame into blocks of ``R`` query rows, at
most 256 tokens (``rb_row_block``, ``_rb_geometry``), pads every frame with
``prow`` zero rows above and ``brow`` below (``_rb_pad_frames``) and scores
each block against a window of ``W = R + (Kh - 1) * dh`` key rows, so that
a block's queries and keys fit VMEM as dense tiles. The Hopper kernels have
no such tiles: each finds every neighbour from its coordinates and checks
each axis against the grid, so a window that reaches past a frame's first
or last row is masked where the TPU kernel reads a padded row, and nothing
is sized by the frame. A block of each kernel owns a tile of queries (the
key side: of keys) of one frame with all heads (``tile_plan``: the first of
``TILES`` whose grid still fills the card and whose shared memory fits:
2 x 2, 1 x 2 or one token, rows read through L1); given such a tile
through the ``tiles`` argument, the forward and query-side kernels also
stage each head's window union of key and value rows in shared memory.
The rel-pos bias is the same
(h, Kn) table in both families (``_rb_bias_tensors`` builds it from the same axial tables
as ``_axial_tables``), so ``Sparse3DNA.rel_bias`` serves every frame size.

A query window: the forward and both backward functions take ``q_lo`` and
the forward and query side ``tok0``. Their queries are then the tokens
[q_lo, q_lo + nq) of the t keys (q's nq rows; ``q_lo`` the first token of a
frame), every per-query tensor (the output, lse, dS, mix, dq and the
cotangent) holds the window's rows only, and the key side sums only the
window's pairs into every key's dk and dv (``t=`` the keys there). ``tok0``
is the id of key token 0 in the whole sequence, which the dropout hash
keys (the bos key keeps ``BOS_KEY``). A shard of a context-parallel run
(``parallel.context_parallel``) attends its own frames (the window) over a
key buffer that adds the halo frames it received, a contiguous slice of
the sequence starting at ``tok0``, so the kernels' frame masks are the
whole sequence's and the shard draws the whole sequence's dropout bits.
The defaults (``q_lo = 0``, q as long as k, ``tok0 = 0``) are the whole
sequence, launched as before. The staged variants and the audio geometry
take no window: a window there raises.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its ``*_plain`` version, the same function written with gathers and
``index_add_`` (the ``_nda_attend`` math of ``nuwa_tpu/nda.py``). The plain
versions use the copied neighbour table (``nuwa_tpu_torch.nda.build_nda_indices``);
the kernels compute neighbours from coordinates, so comparing the two on the
card checks one against the other. Either way a neighbour at or past the
sequence end t is masked: centered windows reach the phantom tokens of a
ragged last frame, which the JAX package pads and masks the same way.
``sparse_3dna`` is the differentiable op:
a ``torch.autograd.Function`` whose forward is ``sparse_3dna_fwd`` and whose
backward runs ``sparse_3dna_bwd_q`` and then ``sparse_3dna_bwd_kv``.

The JAX package reaches HW = 64 (fmap 8) only by lane-packing two frames into
a 128-lane super-frame (``packed_frames``); the kernel reads each query's
neighbours directly, so packing has no counterpart here.

The query-side kernel's sums over queries (the bos, talking-heads and bias
cotangents) are written per tile and summed here over the tile axis in one
fixed order, so every output of the backward is the same, bit for bit, from
run to run.

Attention dropout: every function here takes ``dropout=(rate, seed)``
(None, a rate of 0 or a seed of None: no dropout, the launch that runs
without it). The mask is inverted dropout on the mixed probabilities, after
the talking-heads mix and before PV, keyed by a counter hash of (seed, batch
row, head, query token, key token), the bos column's key id being -2:
``keep_mask``, the JAX package's ``_coord_keep_mask`` (``nuwa_tpu/nda.py``,
the twin of the Pallas kernels' ``_keep_mask_abs``), and
``csrc/sparse3dna_dropout.cuh`` in the kernels. So the forward and the
backward draw the same bits on any device, any recompute replays them, and
the row-blocked TPU kernels' bits (rows 4-6, keyed by the same absolute ids)
are matched; the whole-frame TPU kernels key their mask by tiles
(``_keep_mask``), whose bits no other path draws. The forward's ``lse`` is
the undropped softmax's. The query-side backward masks the cotangent of the
mix and returns the dropped mix, so the key side is the same function with
or without dropout (its ``dropout`` argument only counts the launch). A
dropout launch adds one to ``mode_launches["dropout"]`` beside its mode.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1  # token ids and t are 32-bit ints in the kernels
_MAX_GRID_Y = 65535  # the batch rows are the grid's second axis
# the window geometry: its name and the kernels' mode argument
MODES = {"centered": 0, "causal": 1, "audio": 2}
_U32 = 0xFFFFFFFF
BOS_KEY = -2  # the bos column's key id in the dropout hash


def _avalanche(x):
    """splitmix32's avalanche on int64 tensors that hold uint32 values."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def keep_params(rate):
    """(threshold, scale) of inverted dropout at ``rate``: a pair is kept
    where its hash is at least the threshold, and scaled by fp32 1 / keep;
    both computed as the JAX package does."""
    keep = 1.0 - rate
    thresh = min(_U32, int(round((1.0 - keep) * 2**32)))
    return thresh, torch.tensor(1.0 / keep, dtype=torch.float32).item()


def keep_mask(seed, rate, b, h, q_ids, k_ids=None):
    """(b, h, n, K) bool: where inverted dropout at ``rate`` keeps the pair
    (batch row, head, query ``q_ids[i]``, key ``k_ids[i, j]``); ``q_ids``
    (n,) and ``k_ids`` (n, K) or (1, K) integer tensors, negative ids taken
    as their uint32; no ``k_ids`` is key 0 (K = 1). Bit for bit
    ``_coord_keep_mask`` of ``nuwa_tpu/nda.py``: uint32 arithmetic done in
    int64, each product and sum masked to 32 bits before any shift (an int64
    product may wrap, its low 32 bits stay right). The hash's XOR terms of
    the batch row are host ints, so a call launches about 20 elementwise
    kernels, most of them the avalanche."""
    thresh, _ = keep_params(rate)
    e = ((q_ids.long() & _U32) * 0x27D4EB2F & _U32)[:, None]
    if k_ids is not None:
        e = e ^ ((k_ids.long().to(e.device) & _U32) * 0x165667B1 & _U32)
    s0 = (int(seed) * 0x9E3779B9) & _U32
    streams = [_avalanche((s0 + r + 0x85EBCA6B) & _U32) for r in range(b)]
    if b == h == 1:  # one stream and head 0's term 0: a scalar XOR
        return (_avalanche(e ^ streams[0]) >= thresh)[None, None]
    terms = torch.stack([_head_terms(h, e.device) ^ s for s in streams])  # (b, h)
    return _avalanche(e ^ terms[:, :, None, None]) >= thresh


@functools.lru_cache(maxsize=None)
def _head_terms(h, device):
    """(h,) the hash's XOR term of each head, uint32 values in int64."""
    return torch.arange(h, device=device) * 0x9E3779B9 & _U32


def _dropout(dropout):
    """(rate, seed) of a dropout that acts, or None."""
    if dropout is None:
        return None
    rate, seed = dropout
    if seed is None or rate <= 0:
        return None
    if not rate < 1:
        raise ValueError(f"dropout rate must be below 1, got {rate}")
    return float(rate), int(seed)


def _drop_args(dropout):
    """The kernels' dropout arguments: (on, seed, threshold, scale)."""
    if dropout is None:
        return [0, 0, 0, 0.0]
    rate, seed = dropout
    return [1, seed & _U32, *keep_params(rate)]


def _dropped(x, dropout, idx, q_lo=0, tok0=0):
    """The mixed probabilities (or their cotangent) ``x`` (b, h, n, Kn + 1),
    slot 0 bos, of the queries [q_lo, q_lo + n) whose neighbours ``idx``
    (n, Kn) gives, with the dropout mask of those pairs applied (the ids
    offset by ``tok0``, the bos key's not) and the kept ones scaled: ``x``
    itself without dropout."""
    if dropout is None:
        return x
    rate, seed = dropout
    b, h, n = x.shape[:3]
    k_ids = torch.cat([idx.new_full((n, 1), BOS_KEY), idx + tok0], dim=1)
    q_ids = torch.arange(q_lo + tok0, q_lo + tok0 + n, device=idx.device)
    keep = keep_mask(seed, rate, b, h, q_ids, k_ids)
    return torch.where(keep, x * keep_params(rate)[1], 0.0)


@functools.lru_cache(maxsize=64)
def _neighbour_table(t, fmap, kernel, dilation, mode, device):
    """(t, Kn) neighbour token ids (causal or centered windows, or the audio
    geometry's whole timesteps) and their validity, phantom tokens masked."""
    from ..nda import build_nda_indices

    fh, fw = fmap
    frames = -(-t // (fh * fw))
    if mode == "audio":  # (timesteps, H) with the width axis "full"
        idx, valid = build_nda_indices((frames, fw), (kernel[0], fw), (dilation[0], 1),
                                       ("causal", "full"))
    else:
        idx, valid = build_nda_indices((frames, fh, fw), kernel, dilation, (mode,) * 3)
    idx, valid = idx[:t], valid[:t] & (idx[:t] < t)
    return (
        torch.as_tensor(idx, dtype=torch.long, device=device).clamp(max=t - 1),
        torch.as_tensor(valid, device=device),
    )


def _check_window(name, n, t, fmap, mode, q_lo, tok0):
    """The query window [q_lo, q_lo + n) of t keys starts a frame and lies in
    the keys; the audio geometry takes none."""
    if q_lo < 0 or tok0 < 0 or q_lo + n > t or q_lo % (fmap[0] * fmap[1]):
        raise ValueError(f"{name}: the query window [{q_lo}, {q_lo + n}) must start a frame of "
                         f"{fmap[0]} x {fmap[1]} and lie in the {t} keys, tok0 = {tok0} >= 0")
    if mode == "audio" and (q_lo or n != t or tok0):
        raise ValueError(f"{name}: the audio geometry takes no query window")


def _window_table(t, q_lo, n, fmap, kernel, dilation, mode, device):
    """The neighbour table's rows (and validity) of the queries [q_lo, q_lo + n)
    of a t-token sequence."""
    idx, valid = _neighbour_table(
        t, tuple(fmap), tuple(kernel), tuple(dilation), mode, str(device)
    )
    return idx[q_lo:q_lo + n], valid[q_lo:q_lo + n]


def valid_pairs(t, fmap, kernel, dilation, mode="causal", q_lo=0, n=None) -> int:
    """How many (query, neighbour) pairs of a t-token sequence are valid in
    the given geometry (causal, centered or audio), bos not counted; of the
    queries [q_lo, q_lo + n) only, where ``n`` is given."""
    _check_geometry(fmap, kernel, dilation, mode)
    n = t - q_lo if n is None else n
    _, valid = _window_table(t, q_lo, n, fmap, kernel, dilation, mode, "cpu")
    return int(valid.sum())


# ---------------------------------------------------------------------------
# Tiles of the kernels (csrc/sparse3dna_tile.cuh): queries of the forward and
# query-side kernels (the cross query side's too), keys of the key side
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # shared memory a block may opt into on an H100 (227 KB)
SMS = 132  # the H100's streaming multiprocessors
_THREADS = 256  # threads of a block, or more where a tile's groups need them
# the kernels' __launch_bounds__: Sparse3DNA's forward, query side and key
# side, and SparseCross2DNA's forward, query side and key side
# (csrc/sparse_cross2dna_*.cu)
_MAX_THREADS = {"fwd": 256, "bwd_q": 512, "bwd_kv": 256, "cross_fwd": 256, "cross_bwd_q": 512,
                "cross_bwd_kv": 256}
_KEY_SIDE = ("bwd_kv", "cross_bwd_kv")  # kernels whose tiles are of keys
# tile candidates (rows, columns of queries of one frame, buffers of the ring
# in which each head's window union is staged in shared memory, 2-4, or 0 to
# read the rows from global memory), first choice first; the last, one query
# read from global memory, fits wherever the kernels' first design did.
# Staged tiles measured slower on an H100 than rows read through L1 at every
# shape of the main path (PERF.md), so the rule takes none; the wrappers'
# `tiles` argument reaches them.
TILES = ((2, 2, 0), (1, 2, 0), (1, 1, 0))
# a tile is taken where its blocks are at least this many times the SMs
FILL = 2
PLAN_FIELDS = ("ty", "tx", "tiles_y", "tiles_x", "blocks", "group", "threads", "vec", "stage",
               "uy", "ux", "off_s", "off_s2", "off_nb", "off_qtok", "off_th", "off_bias",
               "off_lse", "off_red", "off_aux", "off_utok", "off_buf",
               "smem", "tf", "hs")  # kPlanInts, in order


def _group(d, elems):
    """Lanes that read one row: the chunks of a row, rounded up to a power
    of 2, at most a warp."""
    chunks = d // elems
    return min(32, 1 << max(0, chunks - 1).bit_length())


def _axis_span(n, k, dl):
    """Positions of one axis in a tile's window union: n queries along an
    axis of kernel k and dilation dl read i + m*dl (i < n, m < k), all of
    0 .. n + (k-1)*dl - 1 where n >= dl, else k runs of n (the kernels'
    ``axis_index`` numbers them)."""
    return n + (k - 1) * dl if n >= dl else k * n


def _union(ty, tx, kernel, dilation, mode):
    """(uy, ux): rows and columns of a frame in a tile's window union; in
    the audio geometry the columns are the whole timestep's."""
    ux = kernel[2] if mode == "audio" else _axis_span(tx, kernel[2], dilation[2])
    return _axis_span(ty, kernel[1], dilation[1]), ux


def _layout(which, h, d, es, kn, tq, group, threads, ring, rows, positions):
    """Byte offsets of the kernel's shared arrays and the total, each array
    16-byte aligned: scores (and, in the query-side backward, dA) of every
    (head, query, slot) in fp32 (``h`` the block's heads), the slot table of
    the tile's ``positions`` (the key side: every key's pairs' queries; the
    cross forward's query frames share one table), the tile's tokens, the
    talking-heads matrix, the bias table (Sparse3DNA's forward and query
    side), the query side's lse of the tile, the shares of a row summed
    between the groups of a (head, token) unit (two rows, dk and dv, on the
    key side; and the query side's dth parts), the query side's mix of bos
    (or of the null column; the key side's slot of each pair), and where the
    plan stages (``ring`` buffers of ``rows`` union rows, else 0) the
    union's tokens and the ring of buffers of its rows and bos."""
    slots = kn + 1
    units = tq if rows else h * tq  # a stage's units: one head staged, else all
    gpu = max(1, threads // group // units)  # the groups of a unit
    key_side = which in _KEY_SIDE
    # staged: two stages' shares in turn; the key side: dk's and dv's
    red = (2 if rows or key_side else 1) * units * gpu * d if gpu > 1 else 0
    bwd = which in ("bwd_q", "cross_bwd_q")
    if bwd:
        red = max(red, h * h * max(1, threads // (h * h)))
    sizes = [
        ("off_s", 0 if key_side else 4 * h * tq * slots),
        ("off_s2", 4 * h * tq * slots if bwd else 0),
        ("off_nb", 4 * positions * kn), ("off_qtok", 4 * tq),
        ("off_th", 0 if key_side else 4 * h * h),
        ("off_bias", 4 * h * kn if which in ("fwd", "bwd_q") else 0),
        ("off_lse", 4 * h * tq if bwd else 0), ("off_red", 4 * red),
        ("off_aux", 4 * h * tq if bwd else 4 * tq * kn if key_side else 0),
        ("off_utok", 4 * rows),
        ("off_buf", ring * (rows + 1) * d * es),
    ]
    offsets, at = {}, 0
    for name, size in sizes:
        offsets[name] = at
        at += -(-size // 16) * 16
    return offsets, at


@functools.lru_cache(maxsize=256)
def tile_plan(which, b, h, t, d, es, fmap, kernel, dilation, mode, vec, *, tiles=TILES,
              fill=FILL):
    """The launch plan of the forward (``which="fwd"``), query-side
    (``"bwd_q"``) or key-side (``"bwd_kv"``) kernel, or of the
    SparseCross2DNA forward (``"cross_fwd"``) and query side
    (``"cross_bwd_q"``), with ``kernel`` (Fc, k, k), ``dilation`` (1, dl,
    dl), ``fmap`` the square frames and t the video queries, or its key
    side (``"cross_bwd_kv"``), with ``kernel`` (1, k, k) and t the context
    tokens: a dict of ``PLAN_FIELDS``.

    A block owns a tile of ``ty x tx`` queries (the key sides: keys) of one
    frame with all heads; groups of ``group`` lanes read rows in 16-byte
    chunks; where ``stage`` is not 0 (forward and query side only) each
    head's window union (``uy x ux`` positions of each of the window's
    frames) is staged in shared memory, in a ring of ``stage`` buffers. A
    candidate ``(ty, tx, stage)`` may name a fourth number: the cross
    forward's query frames a tile, ``tf`` (its tile then holds the same
    positions of ``tf`` frames, which read the same context window), or the
    cross key side's heads a block, ``hs`` (its grid then splits the heads
    over blocks: nothing couples them there); 0 or none is one frame, or
    all heads. The plan is the first of
    ``tiles`` (``TILES``) that fits the frame and the shared memory and
    gives at least ``fill`` (``FILL``) blocks an SM; the last candidate is
    taken where none is. ``es``: bytes of an element; ``vec``: rows start
    16-byte aligned and hold a whole number of 16-byte chunks (staging
    needs it). The forward and query-side wrappers launch a staged plan's
    kernels from ``csrc/sparse3dna_fwd_staged.cu`` and
    ``csrc/sparse3dna_bwd_q_staged.cu``."""
    fh, fw = fmap
    kn = kernel[0] * kernel[1] * kernel[2]
    group = _group(d, 16 // es if vec else 1)
    frames = -(-t // (fh * fw))
    for i, (ty, tx, stage, *more) in enumerate(tiles):
        extra = more[0] if more else 0
        if stage not in (0, 2, 3, 4):
            raise ValueError(f"a tile stages in a ring of 2-4 buffers, or 0, not {stage}")
        if stage and not vec:
            raise ValueError("a staged tile needs rows of whole 16-byte chunks, 16-byte aligned")
        if stage and which not in ("fwd", "bwd_q"):
            raise ValueError(f"the {which} kernel stages no window union")
        if len(more) > 1 or extra < 0 or extra and which not in ("cross_fwd", "cross_bwd_kv"):
            raise ValueError(f"the {which} kernel takes no tile of {(ty, tx, stage, *more)}")
        last = i == len(tiles) - 1
        tf = (extra or 1) if which == "cross_fwd" else 1
        hs = min(h, extra or h) if which == "cross_bwd_kv" else h
        tq = ty * tx * tf
        tiles_y, tiles_x = -(-fh // ty), -(-fw // tx)
        blocks = -(-frames // tf) * tiles_y * tiles_x * -(-h // hs)
        # threads: a whole number of warps, enough for one group a unit, and at
        # least _THREADS, whose spare groups share a unit's slots; the
        # Sparse3DNA key side takes the spare groups only where its grid does
        # not fill the card (they measured slower on an H100 where it does)
        units = tq if stage else hs * tq
        threads = -(-min(units, _MAX_THREADS[which] // group) * group // 32) * 32
        if which != "bwd_kv" or b * blocks < fill * SMS:
            threads = max(_THREADS, threads)
        if not last and (ty > fh or tx > fw or b * blocks < fill * SMS):
            continue
        uy, ux = _union(ty, tx, kernel, dilation, mode) if stage else (0, 0)
        offsets, smem = _layout(which, hs, d, es, kn, tq, group, threads, stage,
                                kernel[0] * uy * ux, ty * tx if which == "cross_fwd" else tq)
        if smem <= SMEM_LIMIT or last:
            return dict(ty=ty, tx=tx, tiles_y=tiles_y, tiles_x=tiles_x, blocks=blocks,
                        group=group, threads=threads, vec=int(vec), stage=stage, uy=uy, ux=ux,
                        **offsets, smem=smem, tf=tf, hs=hs)
    raise ValueError(f"no tile candidates for {which}")


def _plan_args(which, q, geometry, tensors, tiles=None, candidates=TILES, *, t=None,
               fill=FILL):
    """(plan dict, ctypes int array) for a launch on these tensors in
    ``geometry`` (fmap, kernel, dilation, mode); ``tiles``: candidates taken
    in place of the rule's ``candidates``, with its fill rule off; ``t``:
    the tokens the tiles cover, q's by default."""
    b, h, tq, d = q.shape
    es = q.element_size()
    vec = (d * es) % 16 == 0 and all(x.data_ptr() % 16 == 0 for x in tensors)
    rule = (dict(tiles=tuple(map(tuple, tiles)), fill=0) if tiles
            else dict(tiles=candidates, fill=fill))
    plan = tile_plan(which, b, h, tq if t is None else t, d, es,
                     *(tuple(geometry[k]) for k in ("fmap", "kernel", "dilation")),
                     geometry["mode"], vec, **rule)
    return plan, (ctypes.c_int * len(PLAN_FIELDS))(*(plan[f] for f in PLAN_FIELDS))


def launch_plan(which, q, *, fmap, kernel, dilation, mode="causal", tiles=None):
    """The plan (``tile_plan``) with which the forward (``which="fwd"``),
    query-side (``"bwd_q"``) or key-side (``"bwd_kv"``) wrapper launches on
    q (b, h, t, d) in the given geometry, given the wrapper's ``tiles``
    argument."""
    geometry = dict(fmap=fmap, kernel=kernel, dilation=dilation, mode=mode)
    return _plan_args(which, q, geometry, [q], tiles)[0]


def sparse_3dna_fwd_plain(q, k, v, k_bos, v_bos, talking_heads, rel_bias=None,
                          *, fmap, kernel, dilation, mode="causal", dropout=None, q_lo=0,
                          tok0=0):
    """Plain PyTorch version of the kernel (fp32 math); same arguments and
    results as ``sparse_3dna_fwd``."""
    dropout = _dropout(dropout)
    n, t = q.shape[2], k.shape[2]
    _check_window("sparse_3dna_fwd", n, t, fmap, mode, q_lo, tok0)
    idx, valid = _window_table(t, q_lo, n, fmap, kernel, dilation, mode, q.device)
    qf = q.float()
    sim = torch.einsum("bhid,bhijd->bhij", qf, k.float()[:, :, idx])
    if rel_bias is not None:
        sim = sim + rel_bias.float()[None, :, None, :]
    sim = sim.masked_fill(~valid, -torch.finfo(torch.float32).max)
    sim_bos = torch.einsum("bhid,bhd->bhi", qf, k_bos.float()[:, :, 0])
    sim = torch.cat([sim_bos[..., None], sim], dim=-1)
    lse = torch.logsumexp(sim, dim=-1)
    attn = torch.softmax(sim, dim=-1)
    attn = _dropped(torch.einsum("bhij,gh->bgij", attn, talking_heads.float()), dropout, idx,
                    q_lo, tok0)
    out = attn[..., :1] * v_bos.float()
    out = out + torch.einsum("bhij,bhijd->bhid", attn[..., 1:], v.float()[:, :, idx])
    return out.to(q.dtype), lse


def _gathered(x, idx, bos):
    """(b, h, t, Kn + 1, d) fp32 rows of each query's slots: ``bos``
    (b, h, 1, d) in slot 0, then the neighbours ``x[:, :, idx]``."""
    b, h, t = x.shape[0], x.shape[1], idx.shape[0]
    head = bos.float()[:, :, None].expand(b, h, t, 1, x.shape[-1])
    return torch.cat([head, x.float()[:, :, idx]], dim=3)


def sparse_3dna_bwd_q_plain(q, k, v, k_bos, v_bos, talking_heads, rel_bias, grad, lse,
                            *, fmap, kernel, dilation, mode="causal", dropout=None, q_lo=0,
                            tok0=0):
    """Plain PyTorch version of the query-side backward kernel (fp32 math);
    same arguments and results as ``sparse_3dna_bwd_q``."""
    dropout = _dropout(dropout)
    n, t = q.shape[2], k.shape[2]
    _check_window("sparse_3dna_bwd_q", n, t, fmap, mode, q_lo, tok0)
    idx, valid = _window_table(t, q_lo, n, fmap, kernel, dilation, mode, q.device)
    qf, gf, th = q.float(), grad.float(), talking_heads.float()
    keys, vals = _gathered(k, idx, k_bos), _gathered(v, idx, v_bos)
    sim = torch.einsum("bhid,bhijd->bhij", qf, keys)
    if rel_bias is not None:
        sim[..., 1:] += rel_bias.float()[None, :, None, :]
    slot_valid = torch.cat([valid.new_ones(n, 1), valid], dim=1)
    sim = sim.masked_fill(~slot_valid, float("-inf"))
    p = torch.exp(sim - lse[..., None])
    # the cotangent of the (undropped) mix, and the mix that weighted the values
    da = _dropped(torch.einsum("bhid,bhijd->bhij", gf, vals), dropout, idx, q_lo, tok0)
    dp = torch.einsum("bgij,gh->bhij", da, th)  # through the talking-heads mix
    mix = _dropped(torch.einsum("bhij,gh->bgij", p, th), dropout, idx, q_lo, tok0)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))  # through the softmax
    dq = torch.einsum("bhij,bhijd->bhid", ds, keys)
    dth = torch.einsum("bgij,bhij->gh", da, p)
    dbias = ds[..., 1:].sum(dim=(0, 2)) if rel_bias is not None else None
    dk_bos = torch.einsum("bhi,bhid->bhd", ds[..., 0], qf)[:, :, None]
    dv_bos = torch.einsum("bhi,bhid->bhd", mix[..., 0], gf)[:, :, None]
    return (dq.to(q.dtype), ds, mix, dk_bos.to(k_bos.dtype), dv_bos.to(v_bos.dtype),
            dth, dbias)


def sparse_3dna_bwd_kv_plain(q, grad, ds, mix, *, fmap, kernel, dilation, mode="causal",
                             dropout=None, q_lo=0, t=None):
    """Plain PyTorch version of the key-side backward kernel (fp32 math);
    same arguments and results as ``sparse_3dna_bwd_kv`` (the ``mix`` it
    is given is the dropped one, so ``dropout`` changes nothing)."""
    b, h, n, d = q.shape
    t = q_lo + n if t is None else t
    _check_window("sparse_3dna_bwd_kv", n, t, fmap, mode, q_lo, 0)
    idx, valid = _window_table(t, q_lo, n, fmap, kernel, dilation, mode, q.device)
    kn = idx.shape[1]
    flat = idx.reshape(-1)
    out = []
    for w, x in ((ds, q), (mix, grad)):
        w = w[..., 1:].masked_fill(~valid, 0.0)
        terms = (w[..., None] * x.float()[:, :, :, None, :]).reshape(b, h, n * kn, d)
        out.append(terms.new_zeros(b, h, t, d).index_add_(2, flat, terms))
    return out[0].to(q.dtype), out[1].to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library(name):
    """The ctypes library of ``csrc/<name>.cu`` with its entry point typed:
    an int dtype, pointers, then ints (b, heads, t, d, the geometry and, but
    for the staged variants and the cross kernels, the query window), the
    forward's and the query side's dropout (on, seed, threshold, scale) and
    the launch plan (``tile_plan``), then the stream."""
    pointers, ints = {  # the three kernels' ints end with the query window
        "sparse3dna_fwd": (9, 16),
        "sparse3dna_fwd_staged": (9, 13),
        "sparse3dna_bwd_q": (13, 16),
        "sparse3dna_bwd_q_staged": (13, 13),
        "sparse3dna_bwd_kv": (6, 15),
        "sparse_cross2dna_fwd": (9, 8),
        "sparse_cross2dna_bwd_q": (13, 8),
        "sparse_cross2dna_bwd_kv": (6, 8),
    }[name]
    drop = ([ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
            if not name.endswith("_bwd_kv") else [])
    plan = [ctypes.POINTER(ctypes.c_int)]
    lib = build.load(name)
    fn = getattr(lib, f"nuwa_{name}")
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + drop + plan
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.nuwa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nuwa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, dtype, pointers, ints, device, plan=()):
    lib = _library(name)
    rc = getattr(lib, f"nuwa_{name}")(
        _DTYPES[dtype], *pointers, *ints, *plan, torch.cuda.current_stream(device).cuda_stream
    )
    if rc != 0:
        msg = lib.nuwa_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def _check_geometry(fmap, kernel, dilation, mode):
    """``mode`` is one of ``MODES``; the audio geometry is a (timesteps, 1, H)
    grid whose window spans the whole timestep: fmap (1, H), kernel
    (K, 1, H), dilation (d, 1, 1)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if mode == "audio" and not (fmap[0] == 1 and kernel[1] == 1 and kernel[2] == fmap[1]
                      and tuple(dilation[1:]) == (1, 1)):
        raise ValueError("the audio geometry needs fmap (1, H), kernel (K, 1, H) and "
                         f"dilation (d, 1, 1), got {fmap}, {kernel}, {dilation}")


def _check_cuda(name, q, fmap, kernel, dilation, tensors, t=None, tok0=0):
    """Raise on anything the kernels do not take. ``tensors``: (name, tensor,
    shape, dtype) to check beside q (b, h, n, d); ``t``: the keys (n by
    default), ``tok0`` the id of key 0. A frame of any size is
    taken: the kernels bound only the heads (32), the head dim (8 elements
    a lane) and what their 32-bit ints index, t and the token ids of the
    windows, which reach at most one window's frames past tok0 + t. The shared
    memory of the forward and query-side kernels grows with h·Kn (K·H in
    the audio geometry): past the card's opt-in maximum the launch fails,
    and ``_launch`` raises."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    b, h, n, d = q.shape
    t = n if t is None else t
    fh, fw = fmap
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {q.dtype}")
    if not (1 <= h <= 32 and 1 <= d <= 256):
        raise ValueError(f"need 1 <= heads <= 32 and 1 <= dim_head <= 256, got {h}, {d}")
    if b > _MAX_GRID_Y or tok0 + t + kernel[0] * dilation[0] * fh * fw > _INT_MAX:
        raise ValueError(f"{name}: b = {b} or t = {t} with frames of {fh} x {fw} is past "
                         "what the kernels index")
    for arg, x, shape, dtype in tensors:
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != q.device:
            raise ValueError(f"{name}: {arg} must be {shape} {dtype} on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def _params(q, talking_heads, rel_bias, kn):
    """The talking-heads matrix and the bias as contiguous fp32 on q's device."""
    h = q.shape[1]
    th = talking_heads.to(device=q.device, dtype=torch.float32).contiguous()
    if tuple(th.shape) != (h, h):
        raise ValueError(f"talking_heads: expected {(h, h)}, got {tuple(th.shape)}")
    bias = None
    if rel_bias is not None:
        bias = rel_bias.to(device=q.device, dtype=torch.float32).contiguous()
        if tuple(bias.shape) != (h, kn):
            raise ValueError(f"rel_bias: expected {(h, kn)}, got {tuple(bias.shape)}")
    return th, bias


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _count(fn, mode, dropout):
    """One launch of ``fn``'s kernel: its count, its count in ``mode`` and,
    with dropout, its dropout count."""
    fn.launches += 1
    fn.mode_launches[mode] += 1
    if dropout is not None:
        fn.mode_launches["dropout"] += 1


def sparse_3dna_fwd(q, k, v, k_bos, v_bos, talking_heads, rel_bias=None,
                    *, fmap, kernel, dilation, mode="causal", dropout=None, tiles=None, q_lo=0,
                    tok0=0):
    """Sparse3DNA attention of t queries over their dilated neighbourhoods
    (causal windows, centered ones with ``mode="centered"``, or with
    ``mode="audio"`` the whole-timestep windows of SparseCausal2DNA) plus bos.

    q (pre-scaled by dim_head**-0.5), k, v: (b, h, t, d); k_bos, v_bos:
    (b, h, 1, d); talking_heads: (h, h); rel_bias: (h, kf*kh*kw) or None;
    fmap: (height, width) of a frame, (1, H) in the audio geometry; kernel,
    dilation: per-axis triples, (K, 1, H) and (d, 1, 1) in the audio
    geometry; dropout: (rate, seed) or None; tiles: (rows, columns, staged)
    tile candidates taken in place of ``TILES``, the first that fits the
    frame and the shared memory, else the last (``tile_plan`` with its fill
    rule off), or None; q_lo, tok0: the query window (the module's
    docstring): q (b, h, n, d) holds the queries [q_lo, q_lo + n) of the t
    keys, and tok0 is key 0's id in the whole sequence. Returns out (b, h,
    n, d) in q's dtype and lse (b, h, n) in fp32, the undropped softmax's.
    """
    _check_geometry(fmap, kernel, dilation, mode)
    dropout = _dropout(dropout)
    if q.device.type == "cpu":
        return sparse_3dna_fwd_plain(
            q, k, v, k_bos, v_bos, talking_heads, rel_bias,
            fmap=fmap, kernel=kernel, dilation=dilation, mode=mode, dropout=dropout,
            q_lo=q_lo, tok0=tok0,
        )
    b, h, n, d = q.shape
    t = k.shape[2]
    _check_window("sparse_3dna_fwd", n, t, fmap, mode, q_lo, tok0)
    kn = kernel[0] * kernel[1] * kernel[2]
    full, bos = (b, h, t, d), (b, h, 1, d)
    _check_cuda("sparse_3dna_fwd", q, fmap, kernel, dilation, [
        ("k", k, full, q.dtype), ("v", v, full, q.dtype),
        ("k_bos", k_bos, bos, q.dtype), ("v_bos", v_bos, bos, q.dtype),
    ], t, tok0)
    th, bias = _params(q, talking_heads, rel_bias, kn)
    ins = [x.contiguous() for x in (q, k, v, k_bos, v_bos)]
    out = torch.empty_like(ins[0])
    lse = torch.empty(b, h, n, device=q.device, dtype=torch.float32)
    if n == 0:
        return out, lse
    geometry = dict(fmap=fmap, kernel=kernel, dilation=dilation, mode=mode)
    plan, plan_arg = _plan_args("fwd", q, geometry, [*ins, out], tiles)
    _launch(_variant("sparse3dna_fwd", plan, n, t, q_lo, tok0), q.dtype,
            [*(x.data_ptr() for x in ins), th.data_ptr(), _ptr(bias), out.data_ptr(),
             lse.data_ptr()],
            [b, h, t, d, *fmap, *kernel, *dilation, MODES[mode],
             *([] if plan["stage"] else [q_lo, q_lo + n, tok0]), *_drop_args(dropout)],
            q.device, [plan_arg])
    _count(sparse_3dna_fwd, mode, dropout)
    return out, lse


def _variant(name, plan, n, t, q_lo, tok0):
    """The kernel a plan launches: ``name``, or its staged variant, which
    takes the whole sequence only."""
    if not plan["stage"]:
        return name
    if q_lo or n != t or tok0:
        raise ValueError(f"{name}: the staged kernels take no query window")
    return name + "_staged"


def sparse_3dna_bwd_q(q, k, v, k_bos, v_bos, talking_heads, rel_bias, grad, lse,
                      *, fmap, kernel, dilation, mode="causal", dropout=None, tiles=None,
                      q_lo=0, tok0=0):
    """Query side of the Sparse3DNA backward.

    Takes the forward's arguments (its dropout and query window too), its
    output cotangent ``grad`` (b, h, n, d, q's dtype) and its ``lse``.
    Returns dq (q's dtype), dS and the mixed probabilities mix, dropped with
    dropout (both (b, h, n, Kn + 1) fp32, slot 0 being bos), dk_bos and
    dv_bos ((b, h, 1, d), k_bos's dtype), dth (h, h) fp32 and the rel-pos
    bias cotangent (h, Kn) fp32, or None without a bias. ``tiles``: as
    ``sparse_3dna_fwd``'s.
    """
    _check_geometry(fmap, kernel, dilation, mode)
    dropout = _dropout(dropout)
    if q.device.type == "cpu":
        return sparse_3dna_bwd_q_plain(
            q, k, v, k_bos, v_bos, talking_heads, rel_bias, grad, lse,
            fmap=fmap, kernel=kernel, dilation=dilation, mode=mode, dropout=dropout,
            q_lo=q_lo, tok0=tok0,
        )
    b, h, n, d = q.shape
    t = k.shape[2]
    _check_window("sparse_3dna_bwd_q", n, t, fmap, mode, q_lo, tok0)
    full, bos = (b, h, t, d), (b, h, 1, d)
    kn = kernel[0] * kernel[1] * kernel[2]
    _check_cuda("sparse_3dna_bwd_q", q, fmap, kernel, dilation, [
        ("k", k, full, q.dtype), ("v", v, full, q.dtype),
        ("k_bos", k_bos, bos, q.dtype), ("v_bos", v_bos, bos, q.dtype),
        ("grad", grad, (b, h, n, d), q.dtype), ("lse", lse, (b, h, n), torch.float32),
    ], t, tok0)
    th, bias = _params(q, talking_heads, rel_bias, kn)
    ins = [x.contiguous() for x in (q, k, v, k_bos, v_bos)]
    grad, lse = grad.contiguous(), lse.contiguous()
    dq = torch.empty_like(ins[0])
    ds = torch.empty(b, h, n, kn + 1, device=q.device, dtype=torch.float32)
    mix = torch.empty_like(ds)
    # each tile's sums over its queries: [dth | dk_bos | dv_bos | dbias], one
    # slot a block of the plan's grid
    hh, hd = h * h, h * d
    geometry = dict(fmap=fmap, kernel=kernel, dilation=dilation, mode=mode)
    plan, plan_arg = _plan_args("bwd_q", q, geometry, [*ins, grad, dq], tiles)
    partial = torch.empty(b, plan["blocks"] if n > 0 else 0,
                          hh + 2 * hd + (h * kn if bias is not None else 0),
                          device=q.device, dtype=torch.float32)
    if n > 0:
        _launch(_variant("sparse3dna_bwd_q", plan, n, t, q_lo, tok0), q.dtype,
                [*(x.data_ptr() for x in ins), th.data_ptr(), _ptr(bias), grad.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), ds.data_ptr(), mix.data_ptr(),
                 partial.data_ptr()],
                [b, h, t, d, *fmap, *kernel, *dilation, MODES[mode],
                 *([] if plan["stage"] else [q_lo, q_lo + n, tok0]), *_drop_args(dropout)],
                q.device, [plan_arg])
        _count(sparse_3dna_bwd_q, mode, dropout)
    sums = partial.sum(dim=1)  # one fixed-order reduction over the blocks: (b, nsum)
    dth = sums[:, :hh].sum(dim=0).view(h, h)
    dk_bos = sums[:, hh:hh + hd].reshape(b, h, 1, d)
    dv_bos = sums[:, hh + hd:hh + 2 * hd].reshape(b, h, 1, d)
    dbias = sums[:, hh + 2 * hd:].sum(dim=0).view(h, kn) if bias is not None else None
    return dq, ds, mix, dk_bos.to(k_bos.dtype), dv_bos.to(v_bos.dtype), dth, dbias


def sparse_3dna_bwd_kv(q, grad, ds, mix, *, fmap, kernel, dilation, mode="causal",
                       dropout=None, tiles=None, q_lo=0, t=None):
    """Key side of the Sparse3DNA backward: dk and dv (b, h, t, d, q's dtype)
    of the t keys (q_lo + n by default) from q (b, h, n, d), the output
    cotangent ``grad`` and the ``ds`` and ``mix`` that ``sparse_3dna_bwd_q``
    returned, the queries [q_lo, q_lo + n) of the window, whose pairs alone
    are summed. Those carry the forward's dropout, so
    the function is the same with or without it; ``dropout`` only counts
    the launch as a dropout launch. ``tiles``: key tiles (rows, columns, 0)
    taken in place of the rule's, as ``sparse_3dna_fwd``'s."""
    _check_geometry(fmap, kernel, dilation, mode)
    dropout = _dropout(dropout)
    if q.device.type == "cpu":
        return sparse_3dna_bwd_kv_plain(
            q, grad, ds, mix, fmap=fmap, kernel=kernel, dilation=dilation, mode=mode,
            q_lo=q_lo, t=t,
        )
    b, h, n, d = q.shape
    t = q_lo + n if t is None else t
    _check_window("sparse_3dna_bwd_kv", n, t, fmap, mode, q_lo, 0)
    slots = (b, h, n, kernel[0] * kernel[1] * kernel[2] + 1)
    _check_cuda("sparse_3dna_bwd_kv", q, fmap, kernel, dilation, [
        ("grad", grad, (b, h, n, d), q.dtype),
        ("ds", ds, slots, torch.float32), ("mix", mix, slots, torch.float32),
    ], t)
    ins = [x.contiguous() for x in (q, grad, ds, mix)]
    if n == 0:  # no pair: every key's sums are 0
        return q.new_zeros(b, h, t, d), q.new_zeros(b, h, t, d)
    dk = q.new_empty(b, h, t, d)
    dv = q.new_empty(b, h, t, d)
    # the plan's key tiles cover the t keys
    geometry = dict(fmap=fmap, kernel=kernel, dilation=dilation, mode=mode)
    _, plan_arg = _plan_args("bwd_kv", dk, geometry, [*ins[:2], dk, dv], tiles)
    _launch("sparse3dna_bwd_kv", q.dtype,
            [*(x.data_ptr() for x in ins), dk.data_ptr(), dv.data_ptr()],
            [b, h, t, d, *fmap, *kernel, *dilation, MODES[mode], q_lo, q_lo + n], q.device,
            [plan_arg])
    _count(sparse_3dna_bwd_kv, mode, dropout)
    return dk, dv


def reset_launches():
    """Set every kernel's launch count, and its count per mode and with
    dropout, to 0."""
    for fn in (sparse_3dna_fwd, sparse_3dna_bwd_q, sparse_3dna_bwd_kv):
        fn.launches = 0
        fn.mode_launches = dict.fromkeys((*MODES, "dropout"), 0)


# kernel launches since the counts were last reset, in all, per mode and with
# dropout
reset_launches()


class Sparse3DNAFunction(torch.autograd.Function):
    """Differentiable Sparse3DNA: the forward kernel saves only ``lse``
    beside its inputs; the backward recomputes the probabilities query-side
    (``sparse_3dna_bwd_q``) and then gathers dk and dv key-side
    (``sparse_3dna_bwd_kv``), as the JAX package's ``_core_op`` does with its
    two Pallas kernels. The rel-pos bias gradient comes back as (h, Kn), and
    autograd chains it to the axial tables that built the bias. The dropout
    (rate, seed) and the query window (q_lo, tok0) are kept beside the
    geometry: the backward draws the forward's mask again from them."""

    @staticmethod
    def forward(ctx, q, k, v, k_bos, v_bos, talking_heads, rel_bias, geometry, dropout, window):
        q_lo, tok0 = window
        out, lse = sparse_3dna_fwd(q, k, v, k_bos, v_bos, talking_heads, rel_bias,
                                   dropout=dropout, q_lo=q_lo, tok0=tok0, **geometry)
        ctx.save_for_backward(q, k, v, k_bos, v_bos, talking_heads, rel_bias, lse)
        ctx.geometry, ctx.dropout, ctx.window = geometry, dropout, window
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, k_bos, v_bos, th, rel_bias, lse = ctx.saved_tensors
        geo, grad = dict(ctx.geometry, dropout=ctx.dropout), grad.to(q.dtype)
        q_lo, tok0 = ctx.window
        dq, ds, mix, dk_bos, dv_bos, dth, dbias = sparse_3dna_bwd_q(
            q, k, v, k_bos, v_bos, th, rel_bias, grad, lse, q_lo=q_lo, tok0=tok0, **geo
        )
        dk, dv = sparse_3dna_bwd_kv(q, grad, ds, mix, q_lo=q_lo, t=k.shape[2], **geo)
        dbias = dbias.to(rel_bias.dtype) if rel_bias is not None else None
        return dq, dk, dv, dk_bos, dv_bos, dth.to(th.dtype), dbias, None, None, None


def sparse_3dna(q, k, v, k_bos, v_bos, talking_heads, rel_bias=None,
                *, fmap, kernel, dilation, mode="causal", dropout=None, q_lo=0, tok0=0):
    """``sparse_3dna_fwd``'s output, differentiable in every tensor argument,
    in every geometry, with or without dropout ((rate, seed) or None), over
    the query window (``q_lo``, ``tok0``) or the whole sequence."""
    geometry = dict(fmap=tuple(fmap), kernel=tuple(kernel), dilation=tuple(dilation),
                    mode=mode)
    return Sparse3DNAFunction.apply(q, k, v, k_bos, v_bos, talking_heads, rel_bias, geometry,
                                    _dropout(dropout), (int(q_lo), int(tok0)))
