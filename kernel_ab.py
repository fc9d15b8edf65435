#!/usr/bin/env python3
"""Time the port's Sparse3DNA kernels of two checkouts against each other on
one GPU, with chip_smoke.py's own timing functions.

    python3 kernel_ab.py run TREE LABEL > LOG   # one checkout's times
    python3 kernel_ab.py table LOG ...          # the A/B table of such logs
    python3 kernel_ab.py tiles                  # this checkout's B1 and B2 under other tiles

`run` imports chip_smoke.py and nuwa_tpu_torch from TREE (a checkout, such
as `git archive <commit>` unpacked into a directory that .gitignore lists)
and prints each kernel's device time (CUDA-graph replay) at the main path's
shapes: the training shapes at fmap 16 (dilations 1, 2, 4) and fmap 32, the
centered sketch encoder's, the serving shapes at fmap 8, the audio
geometry's forward and backward, and every dropout shape (chip_smoke's
time_train_kernels, time_nda, time_audio, time_audio_bwd and dropout_rows;
the cross kernels' dropout rows are left out). Its last line is
`AB {json}`. Compare two versions only within one call, one process each,
in turns: parent, change, change, parent; `table` averages the two runs of
each label and prints the change's time over the parent's.

`tiles` times B1 and B2 of this checkout at the same training, centered,
audio and serving shapes under each of a few tiles, staged in shared memory
or read through L1 (the wrappers' `tiles` argument: that one candidate),
the rule's own choice (kernels.nda.TILES) first.

Needs a CUDA device; imports no JAX.
"""
import inspect
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
    if "cross" in inspect.signature(cs.dropout_rows).parameters:
        dropout = cs.dropout_rows(knda, cross=False)  # the cross kernels are not compared
    else:  # an older checkout's dropout_rows runs the cross kernels' rows too: leave them out
        cs.cross_dropout_rows = dict
        dropout = cs.dropout_rows(knda)
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


def tiles():
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
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    for name, (b, t, kw, bias) in shapes.items():
        args, g = cs.nda_inputs(b, t, torch.bfloat16, bias, gen, kw["kernel"])
        _, lse = knda.sparse_3dna_fwd(*args, **kw)
        for variant, tiles in variants.items():
            if tiles and (tiles[0][0] > kw["fmap"][0] or tiles[0][1] > kw["fmap"][1]):
                continue
            vkw = dict(kw, tiles=tiles)
            try:
                fwd = cs.device_ms(lambda: knda.sparse_3dna_fwd(*args, **vkw))
                bwd = cs.device_ms(lambda: knda.sparse_3dna_bwd_q(*args, g, lse, **vkw))
            except RuntimeError as e:  # a plan past the card's shared memory
                print(f"{name}, tiles {variant}: {e}", flush=True)
                continue
            print(f"{name}, tiles {variant}: sparse_3dna_fwd {fwd:.4f} ms, "
                  f"sparse_3dna_bwd_q {bwd:.4f} ms; {cs.tiles_text(knda, args[0], vkw)}",
                  flush=True)


if __name__ == "__main__":
    mode, rest = (sys.argv[1], sys.argv[2:]) if len(sys.argv) > 1 else ("", [])
    if mode == "run" and len(rest) == 2:
        run(*rest)
    elif mode == "table" and rest:
        table(rest)
    elif mode == "tiles" and not rest:
        tiles()
    else:
        sys.exit(__doc__)
