#!/usr/bin/env python3
"""Time the port's Sparse3DNA and SparseCross2DNA kernels of two checkouts
against each other on one GPU, with chip_smoke.py's own timing functions.

    python3 kernel_ab.py run TREE LABEL > LOG   # one checkout's times
    python3 kernel_ab.py table LOG ...          # the A/B table of such logs
    python3 kernel_ab.py tiles [nda bwd_kv cross]  # this checkout's kernels under other tiles
    python3 kernel_ab.py sectors                # what B3's gather reads (CPU, no card)

`run` imports chip_smoke.py and nuwa_tpu_torch from TREE (a checkout, such
as `git archive <commit>` unpacked into a directory that .gitignore lists)
and prints each kernel's device time (CUDA-graph replay) at the main path's
shapes: the training shapes at fmap 16 (dilations 1, 2, 4) and fmap 32, the
centered sketch encoder's, the serving shapes at fmap 8, the audio
geometry's forward and backward, and every dropout shape (chip_smoke's
time_train_kernels, time_nda, time_audio, time_audio_bwd and dropout_rows);
then the three cross kernels (B7, B9q, B9kv) at chip_smoke's
CROSS_DROPOUT_SHAPES with and without dropout (cross_dropout_rows). Its
last line is `AB {json}`. Compare two versions only within one call, one
process each, in turns: parent, change, change, parent; `table` averages
the two runs of each label and prints the change's time over the parent's.

`tiles` times this checkout's kernels under each of a few tiles (the
wrappers' `tiles` argument: that one candidate), the rule's own choice
first: B1 and B2 at the training, centered, audio and serving shapes,
staged in shared memory or read through L1; B3 at the same shapes but
serving, and B9q at the sketch shapes with and without dropout, read
through L1.

`sectors` counts, from the geometry alone, the dS and mix sectors and the q
and g rows B3's pairs read at the fmap-16 and fmap-32 training shapes,
once a pair and once a key tile.

`run` and `tiles` need a CUDA device; nothing here imports JAX.
"""
import json
import os
import statistics
import sys


def _import(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke
    from nuwa_tpu_torch.kernels import nda

    return chip_smoke, nda


def run(tree, label):
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA device")
    cs, knda = _import(tree)
    dropout = cs.dropout_rows(knda, cross=False)
    out = {
        "train16": cs.time_train_kernels(knda),
        "train32": cs.time_train_kernels(knda, fmap=(cs.FMAP128,) * 2, t=cs.T128,
                                         plain_iters=2),
        "centered": cs.time_train_kernels(knda, fmap=(cs.SKETCH_FMAP,) * 2,
                                          t=2 * cs.SKETCH_FMAP**2 - 1, mode="centered",
                                          bias=False, dilations=(1, 2)),
        "serve": cs.time_nda(knda),
        "audio": cs.time_audio(knda),
        "audio_bwd": {" / ".join(k): v for k, v in cs.time_audio_bwd(knda).items()},
        "dropout": {" / ".join(k): v for k, v in dropout.items()},
        "cross": {" / ".join(k): v for k, v in cs.cross_dropout_rows().items()},
    }
    print("AB " + json.dumps({"label": label, **out}), flush=True)


def _times(run_out):
    """{(section, kernel, shape): (ms, bound_ms)} of one run's AB line."""
    got = {}
    for section in ("train16", "train32", "centered"):
        for r in run_out[section]:
            got[section, r["name"], f"dilation {r['dilation']}"] = r["ms"], r["bound_ms"]
    for r in run_out["serve"]:
        got["serve", "fwd", f"b={r['b']} t={r['t']} dilation {r['dilation']}"] = (
            r["ms"], r["bound_ms"])
    for shape, r in run_out["audio"].items():
        got["audio", "fwd", shape] = r["ms"], r["bound_ms"]
    for key, r in run_out["audio_bwd"].items():
        name, shape = key.split(" / ")
        got["audio", name, shape] = r["ms"], r["bound_ms"]
    for key, r in run_out["dropout"].items():
        name, shape = key.split(" / ")
        got["dropout", name, shape] = r["ms"], r["bound_ms"]
    for key, r in run_out["cross"].items():
        name, shape = key.split(" / ")
        got["cross", name, shape] = r["no_dropout_ms"], r["bound_ms"]
        got["cross", name, f"{shape}, dropout"] = r["ms"], r["bound_ms"]
    return got


def table(paths):
    runs = {}
    for path in paths:
        with open(path) as f:
            line = [ln for ln in f if ln.startswith("AB ")][-1]
        out = json.loads(line[3:])
        runs.setdefault(out["label"].rstrip("0123456789"), []).append(_times(out))
    parent, change = runs["parent"], runs["change"]
    print("| section | kernel | shape | parent ms | change ms | change / parent | bound ms |")
    print("|---|---|---|---|---|---|---|")
    for key in parent[0]:
        p = statistics.mean(r[key][0] for r in parent)
        c = statistics.mean(r[key][0] for r in change)
        print(f"| {key[0]} | {key[1]} | {key[2]} | {p:.4f} | {c:.4f} | {c / p:.3f} | "
              f"{parent[0][key][1]:.5f} |")


L1_TILES = ((1, 1), (1, 2), (2, 2), (1, 4), (2, 4), (4, 4), (1, 8), (2, 8))


def tiles(kernels=("nda", "bwd_kv", "cross")):
    """Each of ``kernels`` ("nda": B1 and B2, "bwd_kv": B3, "cross": B9q)
    under the rule's tile and each other candidate, one a line."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA device")
    cs, knda = _import(os.path.dirname(os.path.abspath(__file__)))
    train = dict(kernel=cs.TRAIN_KERNEL, dilation=(2, 2, 2))
    shapes = {
        "train b=2 t=2559 fmap 16 dilation 2": (2, cs.TRAIN_T,
                                                dict(train, fmap=cs.TRAIN_FMAP), True),
        "train b=2 t=2559 fmap 16 dilation 1": (2, cs.TRAIN_T, dict(
            train, fmap=cs.TRAIN_FMAP, dilation=(1, 1, 1)), True),
        "train b=2 t=2559 fmap 16 dilation 4": (2, cs.TRAIN_T, dict(
            train, fmap=cs.TRAIN_FMAP, dilation=(4, 4, 4)), True),
        "train b=2 t=10239 fmap 32 dilation 2": (2, cs.T128,
                                                 dict(train, fmap=(cs.FMAP128,) * 2), True),
        "centered b=2 t=511 dilation 1": (2, 2 * cs.SKETCH_FMAP**2 - 1, dict(
            fmap=(cs.SKETCH_FMAP,) * 2, kernel=cs.TRAIN_KERNEL, dilation=(1, 1, 1),
            mode="centered"), False),
        "audio b=1 t=128 H=4": (1, 128, cs.audio_kw(4), True),
        "audio b=1 t=128 H=1": (1, 128, cs.audio_kw(1), True),
        "serve b=2 t=191 dilation 1": (2, 191, dict(fmap=cs.FMAP, kernel=cs.KERNEL,
                                                    dilation=(1, 1, 1)), False),
        "serve b=16 t=191 dilation 2": (16, 191, dict(fmap=cs.FMAP, kernel=cs.KERNEL,
                                                      dilation=(2, 2, 2)), False),
    }
    variants = {"rule": None, **{
        f"{ty}x{tx} " + (f"staged, ring {st}" if st else "L1"): ((ty, tx, st),)
        for ty, tx, st in ((4, 4, 2), (4, 4, 3), (2, 4, 2), (2, 4, 3), (2, 4, 4), (2, 2, 2),
                           (2, 2, 3), (2, 2, 4), (1, 2, 4), (1, 1, 4), (2, 4, 0), (2, 2, 0),
                           (1, 2, 0), (1, 1, 0))}}
    l1 = {"rule": None, **{f"{ty}x{tx} L1": ((ty, tx, 0),) for ty, tx in L1_TILES}}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    for name, (b, t, kw, bias) in shapes.items():
        args, g = cs.nda_inputs(b, t, torch.bfloat16, bias, gen, kw["kernel"])
        _, lse = knda.sparse_3dna_fwd(*args, **kw)
        _, ds, mix, *_ = knda.sparse_3dna_bwd_q(*args, g, lse, **kw)
        for variant, tl in variants.items() if "nda" in kernels else ():
            if tl and (tl[0][0] > kw["fmap"][0] or tl[0][1] > kw["fmap"][1]):
                continue
            vkw = dict(kw, tiles=tl)
            try:
                fwd = cs.device_ms(lambda: knda.sparse_3dna_fwd(*args, **vkw))
                bwd = cs.device_ms(lambda: knda.sparse_3dna_bwd_q(*args, g, lse, **vkw))
            except RuntimeError as e:  # a plan past the card's shared memory
                print(f"{name}, tiles {variant}: {e}", flush=True)
                continue
            print(f"{name}, tiles {variant}: sparse_3dna_fwd {fwd:.4f} ms, "
                  f"sparse_3dna_bwd_q {bwd:.4f} ms; "
                  f"{cs.tiles_text(knda, args[0], vkw, ('fwd', 'bwd_q'))}", flush=True)
        for variant, tl in l1.items() if "bwd_kv" in kernels and name[:5] != "serve" else ():
            if tl and (tl[0][0] > kw["fmap"][0] or tl[0][1] > kw["fmap"][1]):
                continue
            vkw = dict(kw, tiles=tl)
            ms = cs.device_ms(lambda: knda.sparse_3dna_bwd_kv(args[0], g, ds, mix, **vkw))
            print(f"{name}, tiles {variant}: sparse_3dna_bwd_kv {ms:.4f} ms; "
                  f"{cs.tiles_text(knda, args[0], vkw, ('bwd_kv',))}", flush=True)
    if "cross" not in kernels:
        return
    from nuwa_tpu_torch.kernels import cross as kcross

    kw = dict(fmap=cs.SKETCH_FMAP, kernel_size=3, dilation=1)
    for name, (b, t, frames) in cs.CROSS_DROPOUT_SHAPES.items():
        lc = frames * cs.SKETCH_FMAP**2
        args = cs.cross_inputs(b, t, frames, cs.SKETCH_FMAP, torch.bfloat16, gen)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(torch.bfloat16)
        mask = torch.ones(b, lc, dtype=torch.bool, device="cuda")
        mask[1, cs.SKETCH_FMAP**2:] = False  # no-op at one frame
        _, lse = kcross.sparse_cross_2dna_fwd(*args, mask, **kw)
        for variant, tl in l1.items():
            vkw = dict(kw, tiles=tl)
            ms = [cs.device_ms(lambda: kcross.sparse_cross_2dna_bwd_q(
                *args, mask, g, lse, dropout=drop, **vkw))
                for drop in (None, (cs.DROP_RATE, cs.DROP_SEED))]
            print(f"cross {name} b={b} t={t}, tiles {variant}: sparse_cross_2dna_bwd_q "
                  f"{ms[0]:.4f} ms, with dropout {ms[1]:.4f} ms; "
                  f"{cs.cross_tiles_text(kcross, args[0], lc, vkw)}", flush=True)


def sectors():
    """What the key side's gather reads at the training shapes, counted from
    the geometry on the CPU (no card needed): for each key tile and dilation,
    the 32-byte sectors of dS and mix and the q and g rows its pairs read,
    each counted once a tile (what L1 can share within a block) and once a
    pair, in MB over b = 2 and 8 heads, beside the bytes of dS and mix in all.
    Each (b, h) plane is taken to start on a sector."""
    import torch

    cs, knda = _import(os.path.dirname(os.path.abspath(__file__)))
    b, h, d, es = 2, 8, 64, 2
    for fmap, t in (((16, 16), cs.TRAIN_T), ((32, 32), cs.T128)):
        fh, fw = fmap
        for dil in (1, 2, 4):
            idx, valid = knda._neighbour_table(t, fmap, cs.TRAIN_KERNEL, (dil,) * 3, "causal",
                                               "cpu")
            kn = idx.shape[1]
            query = torch.arange(t)[:, None].expand_as(idx)[valid]
            slot = torch.arange(kn)[None].expand_as(idx)[valid]
            key = idx[valid]
            sector = ((query * (kn + 1) + 1 + slot) * 4) // 32
            pairs, total = len(key), 2 * b * h * t * (kn + 1) * 4 / 1e6
            print(f"fmap {fh} dilation {dil}: {pairs * b * h / 1e6:.3f} M pairs, dS and mix "
                  f"{total:.1f} MB in all; read pair by pair {2 * 32 * pairs * b * h / 1e6:.1f} "
                  f"MB of sectors and {2 * d * es * pairs * b * h / 1e6:.1f} MB of rows",
                  flush=True)
            for ty, tx in ((1, 1), (2, 2), (1, 4), (2, 4), (4, 4)):
                f, y, x = key // (fh * fw), key // fw % fh, key % fw
                tile = (f * -(-fh // ty) + y // ty) * -(-fw // tx) + x // tx
                secs = len(torch.unique(tile * (t * (kn + 1)) + sector))
                rows = len(torch.unique(tile * t + query))
                print(f"  {ty}x{tx} tiles: {2 * 32 * secs * b * h / 1e6:.1f} MB of dS and mix "
                      f"sectors, {2 * d * es * rows * b * h / 1e6:.1f} MB of q and g rows, "
                      f"counted once a tile", flush=True)


if __name__ == "__main__":
    mode, rest = (sys.argv[1], sys.argv[2:]) if len(sys.argv) > 1 else ("", [])
    if mode == "run" and len(rest) == 2:
        run(*rest)
    elif mode == "table" and rest:
        table(rest)
    elif mode == "sectors" and not rest:
        sectors()
    elif mode == "tiles":
        tiles(rest or ("nda", "bwd_kv", "cross"))
    else:
        sys.exit(__doc__)
