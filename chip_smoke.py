#!/usr/bin/env python3
"""Smoke test of the PyTorch port (nuwa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every CUDA kernel of the port, from the sources in this checkout;
3. kernels: each kernel against its plain PyTorch version, fp32 and bf16,
   with the tolerance printed beside the error: the Sparse3DNA forward at
   the serving shapes; the forward, the query-side and the key-side
   backward at the training shapes and around them, in causal and in
   centered mode; the autograd function against autograd of the plain
   forward. Then each kernel's time, the plain version's time and the bound
   (the least time the card could take: bytes over 3.35 TB/s or operations
   over the type's peak, for the valid pairs of each geometry), in causal
   mode at the training shape and in centered mode at the centered sketch
   encoder's; then the SparseCross2DNA forward and its
   backward's two kernels (fp32 and bf16; one to three context frames,
   fmap 16 and 4, dilations 1 and 2, full, ragged and single query tokens,
   b 1 and 2, context masks all True, one frame masked and all False), the
   cross autograd function, and their times at the forward and training
   shapes;
4. serving: the full-width NUWA of bench.py's decode config (dim 512, fmap 8,
   4 frames, depth 6, bf16, CFG 2.0) from a seed answers generate (b = 1 and
   8), generate_long (8 frames) and forward, with the kernel launch counts
   checked; then the same weights at depth 3 (CHECK_DEPTH) in fp32 on the
   GPU against the CPU plain path: forward logits and greedy generate_long
   ids one frame past the window;
5. training: NUWATrainer at bench.py's training config (dim 512, fmap 16, 10
   frames, kernel (5, 3, 3), dilations (1, 2, 4), rel-pos bias, token shift,
   reversible decoder of depth 6, bf16, batch 2) on one seeded batch: falling
   finite losses, the exact launches of each kernel per step, ms per step,
   tokens/s, peak memory and the device's busy share; then the loss and
   every gradient of the same weights at depth 3 in fp32 on the GPU against
   the CPU;
6. sketch serving: the full-width NUWASketch of the JAX package's sketch config (dim
   512, a reversible decoder of depth 6, 8 heads of 64, kernel (5, 3, 3) with
   dilations (1, 2, 4), a dense sketch encoder of depth 2, cross kernel 3,
   bf16, fmap 16 from a one-layer VQGanVAE on 32-pixel frames, 5 video and 2
   sketch frames) from a seed answers forward (2-frame and 1-frame sketches),
   generate (b = 1 and 4, decoded to pixels) and generate_long, with the
   launch counts of both kernels checked; then the same weights at depth 3
   in fp32 on the GPU against the CPU plain path: sketch token ids, forward
   logits and greedy generate_long ids;
7. sketch training: two full-width NUWASketch models from a seed, bf16, 4
   AdamW steps each on one seeded batch with condition dropout: (a) the JAX
   package's sketch training config (scripts/bench_sketch_train.py: 10
   video frames and 1 sketch frame, a dense sketch encoder of depth 2, the
   reversible decoder of depth 6), (b) the same widths with BASELINE.json
   config 4's sketch side (a separate 5-channel sketch VAE, a centered
   Sparse3DNA encoder of depth 2, 2 sketch frames, the second padded in one
   row): falling finite losses, the exact launches of every kernel per step
   (centered ones apart), step ms, video tokens/s, peak memory and the
   device's busy share; then model (b)'s loss and every gradient at depth 3
   in fp32 on the GPU against the CPU;
8. NUWA at 128 px: BASELINE.json config 3 at full width (dim 512, a
   reversible decoder of depth 6, 8 heads of 64, kernel (5, 3, 3),
   dilations (1, 2, 4), rel-pos bias, token shift, bf16, 10 frames) with
   config 1's codec on 128-pixel frames (fmap 32, 1,024 tokens a frame,
   past the 256 at which the JAX package turns to its row-blocked kernels),
   captions through the port's tokenizer and seeded moving-square videos:
   the three Sparse3DNA kernels against their plain versions at the fmap-32
   training shape and at fmap 12, 20, 24 and 32 x 9; every backward output
   (Sparse3DNA and cross) equal bit for bit across two calls; the kernels'
   times at the fmap-32 training shape; forward (b = 2, scored from pixels
   through the codec) and generate (b = 1, one frame, to pixels) with their
   launch counts and tokens/s; the codec's ids, the logits and greedy ids
   at depth 3 in fp32 on the GPU against the CPU; NUWATrainer for 4 steps
   with the tokenizer, its step-0 sample written as a PNG and read back, the
   exact launches a step, step ms, tokens/s, peak memory and busy share; the fp32
   loss and every gradient at depth 3 on the GPU against the CPU, none for
   the codec;
9. NUWAVideoAudio serving, BASELINE config 5: the forward kernel in the audio
   geometry of SparseCausal2DNA (a (timesteps, 1, H) grid whose window spans
   whole timesteps) against its plain version at heights 1, 4, 5, 9 and 32,
   kernels 7 and 5, dilations 1 and 2, ragged last timesteps, the bias on
   and off, fp32 and bf16;
   held against its plain version and timed at the main path's two shapes,
   with its bound; the three Sparse3DNA kernels at the dual decoder's video
   launches against their plain versions; the depth-64
   flagship (dim 512, 8 heads of 64, 256-px frames through a 4-layer codec,
   fmap 16, 4 frames, 32 audio tokens a frame at 4 a timestep, a reversible
   decoder, bf16) scoring pixels with forward (exactly 64 video and 64
   audio launches), peak memory and tokens/s; bench.py's depth-12 config
   (fmap 8 through a 2-layer codec on 32-px frames, H = 1) answering cached
   generate (4 frames to pixels, no launch) and generate_long (6 frames, 12
   + 12 launches a prefill) with tokens/s and the busy share of generate;
   then fp32 GPU vs CPU at the flagship's widths, depth 2, 2 frames, H = 4:
   codec ids, video and audio logits, the loss and greedy generate ids;
10. NUWAVideoAudio training, BASELINE config 5: the query-side and
   key-side backward kernels in the audio geometry against their plain
   versions over the forward's 144 cases, every output equal bit for bit
   across two calls; the autograd function against autograd of the plain
   forward in that geometry; both kernels timed at the train step's shape
   (H = 4, b 1, t 127) and at H = 1 (b 2, t 95) beside their plain versions
   and bounds; the depth-64 flagship from a seed trained for 4 steps on
   seeded token ids as scripts/bench_dual_flagship.py's step does it (the
   loss with condition dropout, its backward through the reversible dual
   decoder, the global-norm clip at 0.5, AdamW at lr 3e-4 with weight decay
   0.01): finite losses, the exact launches of each kernel a step (B1 256,
   128 audio; B2 and B3 128, 64 audio), step ms, tokens/s, peak memory and
   the busy share; then at depth 2 in fp32 the loss and every gradient on
   the GPU against the CPU, and one clip-and-AdamW step from the same
   gradients;
11. training with attention and feed-forward dropout (rate 0.1): the three
   Sparse3DNA kernels with dropout against their plain versions (the same
   counter-hash mask) at the main path's shapes, causal at the fmap-16
   training shape, centered at the sketch encoder's, at fmap 32 and in the
   audio geometry at H = 4 and 1, fp32 and bf16, every backward output
   equal bit for bit across two calls and the dropped share of the valid
   pairs within 4 binomial standard deviations of the rate; each kernel's
   time with and without dropout beside its plain version's; NUWATrainer at
   128 px with attn_dropout = ff_dropout = 0.1 (4 steps, every launch a
   dropout one, step ms beside the step without dropout) and its fp32 loss
   and gradients on the GPU against the CPU (the one dropout seed drawn
   from the same CPU generator); the depth-64 flagship's train step with
   the same dropout (4 steps, launches, step ms and peak memory beside the
   step without), and at depth 2 its fp32 loss and gradients against the
   CPU; then the three SparseCross2DNA kernels with dropout against their
   plain versions at the sketch forward's shapes (b = 2, t = 1280, one and
   two context frames) and the sketch training step's (t = 2559, Lc 256 and
   512, the second frame masked in row 1), fp32 and bf16, the same checks,
   each timed with and without dropout beside its plain version; the two
   NUWASketch training models with the same dropout (4 steps each, every
   launch a dropout one, step ms and busy share beside the step without)
   and model (b)'s fp32 loss and gradients with dropout against the CPU;
12. the dense causal decoder of BASELINE config 2 at full width (dim 512,
   depth 4, 8 heads of 64, cross-attention, b = 2, 1,024 tokens, a context of
   256): the fp32 forward on the GPU against the CPU, causality at position
   10, a prefill and teacher-forced cached steps against the forward, the
   bf16 forward's time (no kernel of the port is on this path);
13. method="full" (every token re-runs the whole decoder), greedy with CFG
   2.0: NUWA's serving model (generate and generate_long one frame past the
   window, the forward kernel launched depth times a token), the sketch
   serving model with a centered Sparse3DNA encoder (generate, both forward
   kernels): every bf16 greedy id the top of the logits row it was sampled
   from (recomputed by a teacher-forced forward of the same shapes) up to a
   bf16 near-tie, then against method="cached" on the card by the near-tie
   rule; NUWAVideoAudio at width 512, depth 3: at H = 1 bf16 the same, at
   H = 4 fp32 against the CPU's method="full" ids; tokens/s of each;
14. int8 weight-only serving (utils.quantize.quantize_int8_): the serving
   model quantised against the bf16 one (cached generate b = 8: tokens/s,
   peak memory, weights held), its forward's launches; fp32 on the GPU
   against the CPU: logits and greedy ids, and NUWAVideoAudio's logits;
15. checkpoints and resume: NUWATrainer at 128 px (BASELINE config 3) with
   save_model_every=1 takes 2 steps, a fresh trainer with resume=True over
   other weights restores the newest file (found by the folder scan), and
   both take step 3: the same loss and parameters; the file's size and the
   save and load times;
16. throughput: tokens/s of each serving request, NUWA's and NUWASketch's
   (CUDA events around the serving phases' runs of the generates, the
   sketch forward run once more), and the device's busy share of a
   generate of each model;
17. codec training (VQGanVAETrainer): (a) the README's codec and trainer
   at full width (VQGanVAE(dim=256, image_size=256, num_layers=4,
   vq_codebook_size=8192): GAN, random-weight VGG16 perceptual loss, k-means
   init; lr 3e-4, batch 8, 4 microbatches; fp32) on 64 seeded 256-px
   moving-square frames read from a uint8 memmap through the port's batch
   loader (host C++ built with g++ first: its path and build seconds, its
   gather of 32 of the frames and rot90 of each at every k bit for bit
   against their numpy versions, one gather's and one dataset read's host
   ms against numpy's), 3
   steps with the EMA on from step 0: each step's losses and codebook
   usage, k-means run once, the EMA moved, generator and discriminator ms,
   images/s, peak memory, the parameters of the codec, discriminator and
   VGG16, the images read through the loader, and no kernel launch;
   (b) BASELINE config 1 with the GAN and the random VGG, b = 2, fp32 on the
   GPU against the CPU: the generator loss with every gradient and the
   codebook state after the update (k-means), the discriminator loss with
   the gradient penalty and every discriminator gradient; (c) a resume at
   that config: 2 steps saving each, a fresh trainer resumed from the
   folder, the next step of both bit for bit (deterministic cuDNN), the
   file's size, save and load times;
18. data and tensor parallelism, after the throughput phase: a process
   group of one rank over NCCL and ``make_mesh(data=1, model=1)`` on the
   card; NUWATrainer at 128 px (phase 8's model and batch, bf16) for 3
   steps with and without the mesh from one seed (the step-0 sample left
   out), the launches of each step checked: the losses and parameters
   (bit-equal, or within tests/test_parallel.py's tolerances), the meshed
   step's CUDA-event ms beside ``utils.profiling.StepTimer``'s and
   ``utils.timing.device_rate``'s; one meshed step under
   ``utils.profiling.trace`` with an ``annotate`` region, whose name must be
   in the trace file; the NUWA serving model's cached generate (b = 8, one
   frame) under the mesh: the unmeshed ids; VQGanVAETrainer at BASELINE
   config 1 (GAN, random VGG, k-means, b = 2, fp32, deterministic cuDNN) for
   2 steps with and without the mesh; ``shift_video_tokens`` on the card at
   its four ``shift_space`` / ``shift_time`` settings against the CPU. The
   group is destroyed at the end. Several ranks on one card are not
   possible over NCCL: the multi-rank arithmetic is held by the CPU tests.
19. context parallelism, after phase 18: (a) B1-B3 over the query window
   of each virtual shard at context 2 and 4 (the key buffer the shard's
   frames and its lookback halo, ``q_lo`` and ``tok0``; the last shard
   ragged, at dilation 2 and context 4 a halo of 3 ranks) at the fmap-32
   and fmap-16 training shapes, dilations 1 and 2, fp32 and bf16, with and
   without dropout 0.1, against their windowed plain versions; (b) in fp32
   the shards' outputs reassembled (halo gradients added to their owners)
   against one unsharded launch of each kernel, the dropout masks equal;
   each shard's B1-B3 timed at fmap 32, dilation 2, bf16, beside the
   unsharded time; (c) NUWATrainer(context_parallel=True) at 128 px on a
   one-rank NCCL mesh, 2 steps against 2 unmeshed in turns: losses and
   parameters bit-equal, each step's launches checked.
20. pipeline parallelism, after phase 19: (a) the stage body at full width,
   the stages that each rank of 'pipe' runs chained in this process
   (``parallel.pipeline.chained_transformer`` / ``chained_dual_decoder``:
   stage 0's microbatch outputs stage 1's inputs, the backward in the
   schedule's reverse order), 2 stages of 2 microbatches of b = 2, against
   the unpipelined decoder: phase 8's 128-px reversible decoder in fp32
   without and with dropout 0.1 (the same masks: each microbatch keyed by
   its global rows and each slot by its layer) and in bf16, its plain
   (``dec_reversible=False``) stack in fp32, and config 5's reversible
   dual decoder (the quad carry, the audio geometry) at depth 12, the least
   that splits into 2 identical stages; the outputs and every gradient,
   and the launches of B1-B3 (the chained ones twice the unpipelined
   ones); each stage's parameter and AdamW moment bytes against the whole
   stack's; the bf16 chained step's CUDA-event ms beside the unpipelined
   one's; (b) NUWATrainer(pipeline_parallel=True, pipeline_microbatches=2)
   at 128 px on a one-rank NCCL ('data', 'pipe') mesh, 2 steps against 2
   unmeshed in turns: losses and parameters bit-equal, each step's
   launches checked. NCCL cannot put two ranks on one card: the
   multi-rank arithmetic is held by the CPU tests
   (tests/test_torch_parallel_pp.py).

The CPU plain-path sides of the fp32 GPU-vs-CPU checks (phases 4-15) run
in one spawned process (``CpuRefs``), all submitted at the start, while the
card runs the phases; each check reads its side where it compares.

The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.
"""
import collections
import contextlib
import itertools
import json
import math
import multiprocessing
import os
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

FULL = dict(
    dim=512, image_size=8, num_image_tokens=1024, max_video_frames=4,
    text_num_tokens=49408, text_max_seq_len=32, text_enc_depth=2,
    text_enc_heads=8, text_enc_dim_head=64, dec_depth=6, dec_heads=8,
    dec_dim_head=64, sparse_3dna_kernel_size=3, sparse_3dna_dilation=2,
    shift_video_tokens=True,
)
TRAIN = dict(
    dim=512, image_size=16, num_image_tokens=1024, max_video_frames=10,
    text_num_tokens=49408, text_max_seq_len=32, text_enc_depth=2,
    text_enc_heads=8, text_enc_dim_head=64, dec_depth=6, dec_heads=8,
    dec_dim_head=64, dec_reversible=True, sparse_3dna_kernel_size=(5, 3, 3),
    sparse_3dna_dilation=(1, 2, 4), sparse_3dna_rel_pos_bias=True,
    shift_video_tokens=True,
)
TRAIN_BATCH, TRAIN_STEPS = 2, 5
# the JAX package's NUWASketch (scripts/bench_sketch_train.py:38-57) with the
# frame counts of the reference README's NUWASketch example
SKETCH_VAE = dict(dim=32, image_size=32, num_layers=1, vq_codebook_size=1024,
                  use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
                  num_resnet_blocks=0)
SKETCH = dict(
    dim=512, image_size=32, max_video_frames=5, sketch_max_video_frames=2,
    sketch_enc_depth=2, sketch_enc_dim_head=64, sketch_enc_heads=8, dec_depth=6,
    dec_dim_head=64, dec_heads=8, dec_reversible=True, sparse_3dna_kernel_size=(5, 3, 3),
    sparse_3dna_dilation=(1, 2, 4), shift_video_tokens=True, cross_2dna_kernel_size=3,
    cross_2dna_dilation=1,
)
SEED = 0
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # the JAX tests' bf16 tolerance
LOGITS_ATOL = 1e-3  # fp32 GPU vs CPU logits: sums in another order, up to 6 layers deep
# fp32 GPU vs CPU training: loss within LOSS_ATOL, each gradient within
# GRAD_REL of its max abs: sums in another order through the reversible couples
# whose backward rebuilds activations by subtraction
LOSS_ATOL, GRAD_REL = 1e-4, 1e-3
TIE_GAP = 1e-3
# the decoder depth of the fp32 GPU-vs-CPU checks of the NUWA and NUWASketch
# models: every dilation of a (1, 2, 4) cycle once, at half the host time of
# the configs' 6 layers (the CPU's plain path dominates the script's time)
CHECK_DEPTH = 3


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


REF_TIMEOUT = 900  # seconds a check waits for its CPU side


class CpuRefs:
    """The CPU plain-path sides of the GPU-vs-CPU checks, run in one spawned
    process while the card runs the phases: each is submitted at the start
    of main (its inputs made from seeds, as on the card) and read by its
    check. The process takes all but ``spare`` of the host's cores, which
    the host-bound phases on the card keep. It stops with main (``close``)
    or, after a failure, with the interpreter (multiprocessing terminates a
    pool at exit)."""

    def __init__(self, spare=3):
        threads = max(1, len(os.sched_getaffinity(0)) - spare)
        self.pool = multiprocessing.get_context("spawn").Pool(
            1, initializer=torch.set_num_threads, initargs=(threads,))
        self.jobs = {}

    def submit(self, key, fn, *args):
        self.jobs[key] = self.pool.apply_async(fn, args)

    def result(self, key):
        try:  # a worker that died would leave its job unanswered
            return self.jobs.pop(key).get(timeout=REF_TIMEOUT)
        except multiprocessing.TimeoutError:
            fail(f"the CPU reference {key!r} gave no result in {REF_TIMEOUT} s")

    def close(self):
        self.pool.close()
        self.pool.join()


def cuda_ms(fn, iters=20, reps=5, warmup=3):
    """Median ms per call of ``fn`` (host work included) over ``reps``
    CUDA-event-timed runs of ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters=20, reps=5):
    """Median device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so the host's launch work drops out."""
    fn()  # warm caches (neighbour tables) before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=1, reps=reps, warmup=1) / iters


# ---------------------------------------------------------------------------
# Sparse3DNA forward kernel
# ---------------------------------------------------------------------------

HEADS, DIM_HEAD, FMAP, KERNEL = 8, 64, (8, 8), (3, 3, 3)
TRAIN_FMAP = (TRAIN["image_size"],) * 2
TRAIN_KERNEL = TRAIN["sparse_3dna_kernel_size"]
TRAIN_T = TRAIN["max_video_frames"] * TRAIN["image_size"] ** 2 - 1  # shifted by one
# (frame shape, frames) of the backward checks: the serving and training fmaps
BWD_GRIDS = (((8, 8), 8), ((16, 16), 10))


def nda_inputs(b, t, dtype, bias, gen, kernel=KERNEL):
    """q (pre-scaled), k, v, k_bos, v_bos, talking heads, rel-pos bias and
    an output cotangent, as Sparse3DNA hands them to the kernels."""
    h, d, kn = HEADS, DIM_HEAD, kernel[0] * kernel[1] * kernel[2]

    def rnd(*shape, scale=1.0):
        x = torch.randn(*shape, generator=gen, device="cuda") * scale
        return x.to(dtype)

    q = rnd(b, h, t, d, scale=d**-0.5)
    k, v = rnd(b, h, t, d), rnd(b, h, t, d)
    k_bos, v_bos = rnd(b, h, 1, d), rnd(b, h, 1, d)
    th = (torch.rand(h, h, generator=gen, device="cuda") * 2 - 1) * (3 / h) ** 0.5
    rel = rnd(h, kn, scale=0.5).float() if bias else None
    return (q, k, v, k_bos, v_bos, th, rel), rnd(b, h, t, d)


def bound_ms(nbytes, ops, dtype):
    """(least time, what bounds it): the bytes over the memory rate or the
    operations over the peak rate of the type, whichever is longer."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def plan_text(which, p):
    """One launch plan (``kernels.nda.tile_plan``) in words: its tile (the
    cross forward's query frames a tile, the cross key side's heads a
    block), staged (each head's window union of uy x ux positions a frame in
    shared memory) or read through L1, its block and its shared memory."""
    tokens = "keys" if which.endswith("bwd_kv") else "queries"
    tile = f"{p['ty']}x{p['tx']}" + (f"x{p['tf']} frames" if p["tf"] > 1 else "")
    heads = f", {p['hs']} head{'s' * (p['hs'] > 1)}" if which == "cross_bwd_kv" else ""
    how = f"staged union {p['uy']}x{p['ux']}" if p["stage"] else "read through L1"
    return (f"{which} {tile} {tokens}{heads} a block, {how}, {p['threads']} threads, "
            f"{p['group']} lanes a row, {p['smem']} B shared")


def tiles_text(knda, q, kw, names=("fwd", "bwd_q", "bwd_kv")):
    """The tiles with which B1, B2 and B3 launch on q in the geometry
    ``kw``."""
    geometry = {k: kw[k] for k in ("fmap", "kernel", "dilation", "mode", "tiles") if k in kw}
    return "tiles: " + "; ".join(plan_text(which, knda.launch_plan(which, q, **geometry))
                                 for which in names)


def cross_tiles_text(kcross, q, lc, kw, names=("cross_fwd", "cross_bwd_q", "cross_bwd_kv")):
    """The tiles with which the cross forward (B7), query side (B9q) and
    key side (B9kv) launch on q against Lc context tokens in the geometry
    ``kw``."""
    geometry = {k: kw[k] for k in ("fmap", "kernel_size", "dilation", "tiles") if k in kw}
    return "tiles: " + "; ".join(
        plan_text(which, kcross.launch_plan(q, lc, which=which, **geometry)) for which in names)


def nda_bounds(knda, b, t, dil, dtype, bias, fmap=FMAP, kernel=KERNEL, mode="causal",
               keys=None, q_lo=0):
    """{kernel: (least time, what bounds it)} for the work this input needs:
    each input read once, each output written once; operations (multiply and
    add counted apart) for the valid (query, neighbour) pairs of this
    geometry only (causal, centered or audio: ``knda.valid_pairs``), bos
    included. "bwd" is the whole backward as a function (q, k, v, g, bos,
    lse in; dq, dk, dv, the bos and parameter cotangents out), with no dS or
    mix between its two kernels. ``dil``: one dilation for every axis, or
    the per-axis triple. A query window: the t queries are tokens [q_lo,
    q_lo + t) of ``keys`` keys (t by default)."""
    h, d, kn = HEADS, DIM_HEAD, kernel[0] * kernel[1] * kernel[2]
    keys = t if keys is None else keys
    es = torch.finfo(dtype).bits // 8
    row, key_row = b * h * t * d * es, b * h * keys * d * es
    bos, lse = b * h * d * es, b * h * t * 4
    params = h * h * 4 + (h * kn * 4 if bias else 0)
    slots = 2 * b * h * t * (kn + 1) * 4  # dS and mix, fp32
    dilation = dil if isinstance(dil, tuple) else (dil,) * 3
    pairs = b * h * (knda.valid_pairs(keys, fmap, kernel, dilation, mode, q_lo, t) + t)
    mixes = b * t * (kn + 1) * 2 * h * h  # one (h x h) head mix of every slot
    # scores, dA and dq, the bos sums, the mixes of dP and P and the dth sum
    ops_q = pairs * 6 * d + b * t * h * 4 * d + 3 * mixes
    ops_kv = (pairs - b * h * t) * 4 * d  # dK and dV over the neighbour slots
    return {
        # q, k, v, bos in; out, lse out: scores and PV, the mix
        "fwd": bound_ms(2 * row + 2 * key_row + 2 * bos + params + lse, pairs * 4 * d + mixes,
                        dtype),
        # q, k, v, g, bos, lse in; dq, dS, mix, the sums out
        "bwd_q": bound_ms(3 * row + 2 * key_row + 2 * bos + 2 * params + lse + slots
                          + 2 * b * h * d * 4, ops_q, dtype),
        # q, g, dS, mix in; dk, dv out
        "bwd_kv": bound_ms(2 * row + 2 * key_row + slots, ops_kv, dtype),
        "bwd": bound_ms(3 * row + 4 * key_row + 4 * bos + 2 * params + lse, ops_q + ops_kv,
                        dtype),
    }


def check_nda(knda):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (2, 16):
            for dil in (1, 2):
                for t in (256, 191, 64, 1):
                    for bias in (False, True):
                        args, _ = nda_inputs(b, t, dtype, bias, gen)
                        kw = dict(fmap=FMAP, kernel=KERNEL, dilation=(dil,) * 3)
                        out, lse = knda.sparse_3dna_fwd(*args, **kw)
                        torch.cuda.synchronize()
                        ref, ref_lse = knda.sparse_3dna_fwd_plain(*args, **kw)
                        if out.dtype != dtype or out.shape != ref.shape:
                            fail(f"kernel out {out.dtype} {tuple(out.shape)}")
                        # out in q's dtype; lse is fp32 in both versions
                        for name, a, w, tol in (("out", out, ref, TOL[dtype]),
                                                ("lse", lse, ref_lse, TOL[torch.float32])):
                            err = (a.float() - w.float()).abs().max().item()
                            if not err <= tol:
                                fail(f"sparse_3dna_fwd {name} b={b} t={t} dil={dil} "
                                     f"{dtype} bias={bias}: max err {err} > {tol}")
                            key = (dtype, name, tol)
                            worst[key] = max(worst.get(key, 0.0), err)
    for (dtype, name, tol), err in worst.items():
        print(f"sparse_3dna_fwd {name} vs plain, {dtype}: max abs err {err:.3e} "
              f"(tolerance {tol:.0e}, 32 cases)", flush=True)
    return max(worst.values())


def time_nda(knda):
    """(b, t) of the serving path: forward at b=1 scores 256 tokens; each
    generate_long prefill runs 191 tokens at b=2 (b=1 under CFG), 16 at b=8."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for b, t in ((2, 191), (16, 191), (1, 256)):
        for dil in (1, 2):
            args, _ = nda_inputs(b, t, torch.bfloat16, False, gen)
            kw = dict(fmap=FMAP, kernel=KERNEL, dilation=(dil,) * 3)
            call_ms = cuda_ms(lambda: knda.sparse_3dna_fwd(*args, **kw))
            ms = device_ms(lambda: knda.sparse_3dna_fwd(*args, **kw))
            plain = device_ms(lambda: knda.sparse_3dna_fwd_plain(*args, **kw))
            bound, by = nda_bounds(knda, b, t, dil, torch.bfloat16, False)["fwd"]
            rows.append(dict(b=b, t=t, dilation=dil, ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by))
            print(f"sparse_3dna_fwd bf16 b={b} t={t} dilation={dil}: kernel "
                  f"{ms:.4f} ms (device; {call_ms:.4f} ms a call with the "
                  f"wrapper's host work), plain {plain:.4f} ms, bound "
                  f"{bound:.5f} ms ({by}); {tiles_text(knda, args[0], kw, ('fwd',))}",
                  flush=True)
    return rows


BWD_NAMES = ("dq", "ds", "mix", "dk_bos", "dv_bos", "dth", "dbias", "dk", "dv")
# the outputs in q's dtype; the rest are fp32 in the kernels and the plain
# versions alike, from the same loaded values, so fp32's tolerance holds them
ROUNDED = ("out", "dq", "dk_bos", "dv_bos", "dk", "dv")


def check_bwd(knda):
    """The forward, query-side and key-side kernels against their plain
    versions, in causal and in centered mode: HW 64 and 256, kernel 3 and
    (5, 3, 3), dilations 1, 2 and 4, rel-pos bias on and off, full frames, a
    ragged last frame (whose phantom token the centered windows reach) and
    t = 1, b 1 and 2. Returns the largest absolute error of each kernel."""
    cases = []
    for mode, dtype, (fmap, frames), kernel, dil, bias, t_off, b in itertools.product(
            ("causal", "centered"), (torch.float32, torch.bfloat16), BWD_GRIDS,
            ((3, 3, 3), (5, 3, 3)), (1, 2, 4), (False, True), (0, 1, None), (1, 2)):
        full = frames * fmap[0] * fmap[1]
        t = 1 if t_off is None else full - t_off
        cases.append((mode, dtype, fmap, t, kernel, dil, bias, b))
    return check_nda_cases(knda, cases, SEED + 5)


def check_nda_cases(knda, cases, seed):
    """Each case (mode, dtype, fmap, t, kernel, dilation, bias, b): the
    forward, query-side and key-side kernels against their plain versions.
    Errors are normalised by each reference's max abs (at least 1): the
    backward's outputs span orders of magnitude (dS near 0, the sums over
    all queries in the hundreds or thousands), its sums over queries run in
    another order than the plain version's, and in bf16 dq, dk and dv round
    to 8 bits of mantissa, a relative step of 2**-8 of the value: those are
    held to bf16's tolerance, every fp32 output (lse, dS, mix, dth, the bias
    cotangent) to fp32's in both runs. Returns the largest absolute error of
    each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst_rel, worst_abs, count = {}, {}, {}
    for mode, dtype, fmap, t, kernel, dil, bias, b in cases:
        count[mode, dtype] = count.get((mode, dtype), 0) + 1
        args, g = nda_inputs(b, t, dtype, bias, gen, kernel)
        kw = dict(fmap=fmap, kernel=kernel, dilation=(dil,) * 3, mode=mode)
        out, lse = knda.sparse_3dna_fwd(*args, **kw)
        ref, ref_lse = knda.sparse_3dna_fwd_plain(*args, **kw)
        got = knda.sparse_3dna_bwd_q(*args, g, ref_lse, **kw)
        want = knda.sparse_3dna_bwd_q_plain(*args, g, ref_lse, **kw)
        got += knda.sparse_3dna_bwd_kv(args[0], g, *want[1:3], **kw)
        want += knda.sparse_3dna_bwd_kv_plain(args[0], g, *want[1:3], **kw)
        torch.cuda.synchronize()
        pairs = [("fwd", "out", out, ref), ("fwd", "lse", lse, ref_lse)]
        pairs += [("bwd_kv" if n in ("dk", "dv") else "bwd_q", n, a, w)
                  for n, a, w in zip(BWD_NAMES, got, want)]
        for kname, name, a, w in pairs:
            if w is None:
                if a is not None:
                    fail(f"{name}: None expected without a bias")
                continue
            if a.dtype != w.dtype or a.shape != w.shape:
                fail(f"{name}: {a.dtype} {tuple(a.shape)} != "
                     f"{w.dtype} {tuple(w.shape)}")
            err = (a.float() - w.float()).abs().max().item()
            rel = err / max(1.0, w.float().abs().max().item())
            tol = TOL[dtype if name in ROUNDED else torch.float32]
            if not rel <= tol:
                fail(f"{name} fmap={fmap} kernel={kernel} dil={dil} "
                     f"bias={bias} t={t} b={b} {dtype} {mode}: "
                     f"error {rel} of the max abs > {tol}")
            key = (mode, kname, dtype, name in ROUNDED)
            worst_rel[key] = max(worst_rel.get(key, 0.0), rel)
            worst_abs[kname] = max(worst_abs.get(kname, 0.0), err)
        del args, g, out, lse, ref, ref_lse, got, want, pairs
    print("backward checks: errors over each reference's max abs (at least 1), since "
          "the outputs span orders of magnitude, sums over queries run in another "
          "order, and bf16 outputs round to 2**-8 of the value", flush=True)
    for (mode, kname, dtype, rounded), rel in sorted(worst_rel.items(), key=str):
        tol = TOL[dtype if rounded else torch.float32]
        which = f"outputs in {dtype}" if rounded else "fp32 outputs"
        print(f"sparse_3dna_{kname} vs plain, {mode}, {dtype} inputs, {which}: max error "
              f"{rel:.3e} of the reference's max abs (tolerance {tol:.0e}, "
              f"{count[mode, dtype]} cases)", flush=True)
    return worst_abs


def check_autograd(knda):
    """The whole autograd function (kernels forward and backward) against
    torch.autograd of the plain forward, fp32, at the training shape with a
    ragged last frame: every input's gradient within 1e-5 of its max abs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    t = TRAIN_T
    args, g = nda_inputs(2, t, torch.float32, True, gen, TRAIN_KERNEL)
    args = [x.detach().requires_grad_() for x in args]
    kw = dict(fmap=TRAIN_FMAP, kernel=TRAIN_KERNEL, dilation=(2, 2, 2))
    out, _ = knda.sparse_3dna_fwd_plain(*args, **kw)
    want = torch.autograd.grad(out, args, g)
    got = torch.autograd.grad(knda.sparse_3dna(*args, **kw), args, g)
    worst = 0.0
    for name, a, w in zip(("q", "k", "v", "k_bos", "v_bos", "talking_heads", "rel_bias"),
                          got, want):
        rel = (a - w).abs().max().item() / max(1.0, w.abs().max().item())
        if not rel <= 1e-5:
            fail(f"sparse_3dna autograd: d{name} error {rel} of the max abs > 1e-5")
        worst = max(worst, rel)
    print(f"sparse_3dna autograd function vs autograd of the plain forward, fp32, "
          f"b=2 t={t}: max error {worst:.3e} of the max abs (tolerance 1e-5)", flush=True)


def time_train_kernels(knda, fmap=TRAIN_FMAP, t=TRAIN_T, plain_iters=5, mode="causal",
                       bias=True, dilations=(1, 2, 4)):
    """Each kernel at the training shape: b = 2, t = 2559 (10 frames of 256
    tokens, shifted by one; or the given fmap and t), 8 heads of 64, kernel
    (5, 3, 3), rel-pos bias, bf16, at each dilation of the stack (or in
    centered mode, without the bias, at the given dilations: the sketch
    encoder's shape)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    b, dtype = TRAIN_BATCH, torch.bfloat16
    rows = []
    for dil in dilations:
        args, g = nda_inputs(b, t, dtype, bias, gen, TRAIN_KERNEL)
        kw = dict(fmap=fmap, kernel=TRAIN_KERNEL, dilation=(dil,) * 3, mode=mode)
        _, lse = knda.sparse_3dna_fwd(*args, **kw)
        _, ds, mix, *_ = knda.sparse_3dna_bwd_q(*args, g, lse, **kw)
        bounds = nda_bounds(knda, b, t, dil, dtype, bias, fmap, TRAIN_KERNEL, mode)
        print(f"dilation={dil} {mode} t={t}: {tiles_text(knda, args[0], kw)}", flush=True)
        for name, kernel, plain in (
            ("fwd", lambda: knda.sparse_3dna_fwd(*args, **kw),
             lambda: knda.sparse_3dna_fwd_plain(*args, **kw)),
            ("bwd_q", lambda: knda.sparse_3dna_bwd_q(*args, g, lse, **kw),
             lambda: knda.sparse_3dna_bwd_q_plain(*args, g, lse, **kw)),
            ("bwd_kv", lambda: knda.sparse_3dna_bwd_kv(args[0], g, ds, mix, **kw),
             lambda: knda.sparse_3dna_bwd_kv_plain(args[0], g, ds, mix, **kw)),
        ):
            ms, plain_ms = device_ms(kernel), device_ms(plain, iters=plain_iters)
            bound, by = bounds[name]
            rows.append(dict(name=name, dilation=dil, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by))
            print(f"sparse_3dna_{name} bf16 b={b} t={t} fmap {fmap} kernel {TRAIN_KERNEL} "
                  f"dilation={dil} {mode}: kernel {ms:.4f} ms "
                  f"(device), plain {plain_ms:.4f} ms, "
                  f"bound {bound:.5f} ms ({by}), kernel / bound {ms / bound:.1f}x",
                  flush=True)
        # the backward as one function: its two kernels against its own bound
        bwd_ms = rows[-2]["ms"] + rows[-1]["ms"]
        bound, by = bounds["bwd"]
        for row in rows[-2:]:
            row["backward_bound_ms"] = bound
        print(f"sparse_3dna backward (bwd_q + bwd_kv) bf16 b={b} t={t} dilation={dil}: "
              f"{bwd_ms:.4f} ms, bound of the whole backward {bound:.5f} ms ({by}), "
              f"kernels / bound {bwd_ms / bound:.1f}x", flush=True)
    return rows


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def request_text(b, gen):
    text = torch.randint(1, FULL["text_num_tokens"], (b, FULL["text_max_seq_len"]),
                         generator=gen)
    text[:, 20:] = 0  # padded tail, as a tokenizer leaves it
    return text


def check_ids(name, ids, shape):
    if tuple(ids.shape) != shape:
        fail(f"{name}: shape {tuple(ids.shape)} != {shape}")
    if ids.min().item() < 0 or ids.max().item() >= FULL["num_image_tokens"]:
        fail(f"{name}: ids out of range")


def serve(NUWA, knda):
    """The main path at full width, bf16, with the kernel's launch count;
    each request timed with CUDA events (the throughput phase reports
    them)."""
    model = NUWA(**FULL, compute_dtype="bfloat16", seed=SEED)
    gen_cpu = torch.Generator().manual_seed(SEED)
    texts = {1: request_text(1, gen_cpu), 8: request_text(8, gen_cpu)}
    tpf, frames = model.tokens_per_frame, model.max_video_frames
    video = torch.randint(0, FULL["num_image_tokens"], (1, frames * tpf), generator=gen_cpu)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    depth, vocab = FULL["dec_depth"], FULL["num_image_tokens"]
    reset_launches(knda)
    counts, ms = {}, {}
    for name, call, shape, expect in (
        ("generate b=1", lambda: model.generate(texts[1], generator=gen),
         (1, frames * tpf), 0),
        ("generate b=8", lambda: model.generate(texts[8], generator=gen),
         (8, frames * tpf), 0),
        # one prefill (depth launches) per frame past max_video_frames
        ("generate_long b=1", lambda: model.generate_long(
            texts[1], num_frames=2 * frames, generator=gen), (1, 2 * frames * tpf),
         frames * depth),
        ("forward b=1", torch.no_grad()(lambda: model(texts[1], video)),
         (1, frames * tpf + 1, vocab), depth),
    ):
        before = knda.sparse_3dna_fwd.launches
        out, ms[name] = timed(call)
        counts[name] = knda.sparse_3dna_fwd.launches - before
        if name.startswith("forward"):
            if tuple(out.shape) != shape or not torch.isfinite(out).all():
                fail(f"{name}: logits {tuple(out.shape)} not finite or wrong shape")
        else:
            check_ids(name, out, shape)
        if counts[name] != expect:
            fail(f"{name}: {counts[name]} sparse_3dna_fwd launches, expected {expect}")
        print(f"{name}: {tuple(out.shape)} ok, sparse_3dna_fwd launches "
              f"{counts[name]} (expected {expect})", flush=True)
    got = launch_counts(knda)
    launches = got["fwd"]
    if launches == 0:
        fail("the serving path launched no sparse_3dna_fwd kernel")
    if got != expect_launches(fwd=launches):
        fail(f"the NUWA serving path launched another kernel: {got}")
    return model, texts, launches, ms


KERNELS = ("fwd", "bwd_q", "bwd_kv", "cross", "cross_bwd_q", "cross_bwd_kv")
# the Sparse3DNA wrappers also count their launches per mode, centered and
# audio among them; the cross wrappers their dropout launches
CENTERED = ("fwd", "bwd_q", "bwd_kv")
CROSS = ("cross", "cross_bwd_q", "cross_bwd_kv")


def kernel_wrappers(knda):
    """{short name: wrapper} of every kernel of the port."""
    from nuwa_tpu_torch.kernels import cross as kcross

    return dict(zip(KERNELS, (
        knda.sparse_3dna_fwd, knda.sparse_3dna_bwd_q, knda.sparse_3dna_bwd_kv,
        kcross.sparse_cross_2dna_fwd, kcross.sparse_cross_2dna_bwd_q,
        kcross.sparse_cross_2dna_bwd_kv)))


def reset_launches(knda):
    from nuwa_tpu_torch.kernels import cross as kcross

    knda.reset_launches()
    kcross.reset_launches()


COUNTED_MODES = ("centered", "audio", "dropout")


def launch_counts(knda):
    """Each wrapper's launches since the reset, and the Sparse3DNA wrappers'
    centered ones as "<name>_centered", audio ones as "<name>_audio" and
    those with attention dropout as "<name>_dropout", the cross wrappers'
    too."""
    fns = kernel_wrappers(knda)
    counts = {name: fn.launches for name, fn in fns.items()}
    counts.update({f"{name}_{mode}": fns[name].mode_launches[mode] for name in CENTERED
                   for mode in COUNTED_MODES})
    counts.update({f"{name}_dropout": fns[name].mode_launches["dropout"] for name in CROSS})
    return counts


def expect_launches(**nonzero):
    """The launch counts of a run that launches the named kernels that many
    times and no other."""
    keys = (*KERNELS, *(f"{name}_{mode}" for mode in COUNTED_MODES for name in CENTERED),
            *(f"{name}_dropout" for name in CROSS))
    return {key: nonzero.get(key, 0) for key in keys}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_batch(gen):
    """One batch of (text ids, video token ids) pairs made from a seed: the
    texts padded after 20 tokens, as a tokenizer leaves them."""
    tokens = TRAIN["max_video_frames"] * TRAIN["image_size"] ** 2
    text = request_text(TRAIN_BATCH, gen)
    video = torch.randint(0, TRAIN["num_image_tokens"], (TRAIN_BATCH, tokens), generator=gen)
    return [(text[i].numpy(), video[i].numpy()) for i in range(TRAIN_BATCH)]


def train(NUWA, NUWATrainer, knda):
    """The training path at full width, bf16: NUWATrainer for TRAIN_STEPS
    steps over a dataset of one batch, so every step sees the same batch.
    Per step of one microbatch the reversible decoder launches the forward
    kernel 2 x depth times (the forward under no grad, then the recompute of
    each self-attention couple in the backward) and each backward kernel
    depth times; the text encoder and the cached sampling at step 0 launch
    none."""
    depth = TRAIN["dec_depth"]
    expect = expect_launches(fwd=2 * depth, bwd_q=depth, bwd_kv=depth)
    model = NUWA(**TRAIN, compute_dtype="bfloat16", seed=SEED)
    trainer = NUWATrainer(
        nuwa=model, dataset=train_batch(torch.Generator().manual_seed(SEED + 9)),
        num_train_steps=TRAIN_STEPS, lr=3e-4, wd=0.01, batch_size=TRAIN_BATCH,
        grad_accum_every=1, max_grad_norm=0.5, cond_dropout_prob=0.2,
        save_results_every=1000, num_sampled_frames=1, seed=SEED,
    )
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], {k: 0 for k in expect}
    for step in range(TRAIN_STEPS):
        reset_launches(knda)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logs = trainer.train_step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(logs["loss"])
        got = launch_counts(knda)
        if got != expect:
            fail(f"train step {step}: launches {got}, expected {expect}")
        total = {k: total[k] + got[k] for k in total}
        if step == 0 and logs.get("sampled_indices") is None:
            fail("train step 0 logged no sample")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(math.isfinite, losses)):
        fail(f"train losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train loss did not fall: {losses}")
    ms = statistics.median(times[1:])  # step 0 also samples 256 tokens
    tokens = TRAIN_BATCH * TRAIN["max_video_frames"] * TRAIN["image_size"] ** 2
    print(f"train: losses {', '.join(f'{x:.4f}' for x in losses)} (finite, falling)",
          flush=True)
    print(f"train: launches per step {expect} (as expected, every step)", flush=True)
    print(f"train step (b={TRAIN_BATCH}, {tokens} video tokens): {ms:.1f} ms median of "
          f"steps 1-{TRAIN_STEPS - 1} (step 0 with its sample: {times[0]:.1f} ms), "
          f"{tokens / (ms / 1e3):.0f} video tokens/s, peak memory {peak:.2f} GiB",
          flush=True)
    train_device_share(trainer)
    return total, dict(ms=ms, tokens_per_s=tokens / (ms / 1e3), peak_gib=peak)


def kernel_events(prof):
    """The profiler's device kernels, by name: user annotations such as
    ``Optimizer.step`` also carry device time, that of the kernels inside
    them, and would count it twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def train_device_share(trainer):
    """Device busy share of one train step: kernel time from torch.profiler
    (device activity only: tracing the host's ops as well costs minutes on
    the longest requests) over the wall time of the same step unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    wall = cuda_ms(trainer.train_step, iters=1, reps=1, warmup=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step()
        torch.cuda.synchronize()
    kernels = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        print("train device busy share: not measured (the profiler saw no device time)")
        return
    print(f"train step: {wall:.1f} ms wall, {busy:.2f} ms of kernels ({100 * busy / wall:.2f}% "
          f"busy, {sum(e.count for e in kernels)} kernel launches)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}", flush=True)


def train_side(device):
    """train_against_cpu's run on ``device``: the fp32 loss and every
    parameter's gradient at CHECK_DEPTH."""
    from nuwa_tpu_torch import NUWA

    gen = torch.Generator().manual_seed(SEED + 10)
    (t0, v0), (t1, v1) = train_batch(gen)
    text, video = torch.from_numpy(np.stack([t0, t1])), torch.from_numpy(np.stack([v0, v1]))
    model = NUWA(**dict(TRAIN, dec_depth=CHECK_DEPTH), device=device, seed=SEED + 11)
    start = time.perf_counter()
    loss = model(text, video, return_loss=True, train=True, uncond=torch.tensor([False, True]))
    loss.backward()
    print(f"fp32 train forward and backward on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}


def train_against_cpu(refs):
    """Same weights in fp32, one microbatch with the same condition-dropout
    mask: the GPU path (kernels) against the CPU plain path (``refs``), the
    loss and every parameter's gradient."""
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = train_side("cuda"), refs.result("train")
    worst, where = 0.0, None
    for name, ref in g_cpu.items():
        rel = (g_gpu[name] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, name
    print(f"fp32 train GPU vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f} (tolerance "
          f"{LOSS_ATOL:.0e}); {len(g_cpu)} gradients, largest error {worst:.3e} of the "
          f"gradient's max abs at {where} (tolerance {GRAD_REL:.0e})", flush=True)
    if not abs(loss_gpu - loss_cpu) <= LOSS_ATOL:
        fail("the training loss differs between GPU and CPU")
    if not worst <= GRAD_REL:
        fail("training gradients differ between GPU and CPU")



def cpu_top2_gap(model, text, ids, p, cond_scale):
    """Top-2 logit gap of the model (on its device) at the first differing
    position p of a sliding-window rollout."""
    tpf, maxf = model.tokens_per_frame, model.max_video_frames
    start = max(p // tpf - (maxf - 1), 0) * tpf
    text = torch.as_tensor(text, device=model.device)
    mask = text != 0
    ctx, cmask = model._cfg_context(model.embed_text(text, mask), mask, True)
    inp = ids[:, start:p].to(model.device).repeat(2, 1)
    with torch.no_grad():
        row = model._decode_logits(inp, ctx, cmask)[:, p - start]
    logits = row[1:] + (row[:1] - row[1:]) * cond_scale
    top = logits.topk(2, dim=-1).values[0]
    return (top[0] - top[1]).item()


def serving_model(device):
    """check_against_cpu's model on ``device`` (fp32, CHECK_DEPTH), its
    request and its video."""
    from nuwa_tpu_torch import NUWA

    model = NUWA(**dict(FULL, dec_depth=CHECK_DEPTH), device=device, seed=SEED + 7)
    gen = torch.Generator().manual_seed(SEED + 7)
    text = request_text(1, gen)
    video = torch.randint(0, FULL["num_image_tokens"], (1, model.max_video_tokens),
                          generator=gen)
    return model, text, video


def serving_side(device):
    """check_against_cpu's run on ``device``: the forward logits and the
    greedy generate_long ids one frame past the window."""
    model, text, video = serving_model(device)
    start = time.perf_counter()
    with torch.no_grad():
        logits = model(text, video).cpu()
    thres = 1 - 0.5 / FULL["num_image_tokens"]  # top-k keeps k = 1: greedy
    ids = model.generate_long(text, num_frames=model.max_video_frames + 1,
                              filter_thres=thres).cpu()
    print(f"fp32 forward and greedy generate_long on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return logits, ids


def check_against_cpu(refs):
    """Same weights in fp32: GPU (kernel) vs CPU (plain path, ``refs``)."""
    (a, ids_gpu), (b, ids_cpu) = serving_side("cuda"), refs.result("serving")
    err = (a - b).abs().max().item()
    print(f"forward fp32 logits GPU vs CPU: max abs err {err:.3e} "
          f"(tolerance {LOGITS_ATOL:.0e})", flush=True)
    if not err <= LOGITS_ATOL:
        fail("forward logits differ between GPU and CPU")
    diff = (ids_gpu != ids_cpu).nonzero()
    if len(diff) == 0:
        print(f"greedy generate_long fp32 ids GPU vs CPU: all {ids_cpu.numel()} equal",
              flush=True)
        return
    p = diff[0, 1].item()
    cpu, text, _ = serving_model("cpu")
    gap = cpu_top2_gap(cpu, text, ids_cpu, p, 2.0)
    print(f"greedy generate_long ids differ first at position {p}; CPU top-2 "
          f"logit gap there {gap:.3e} (a tie below {TIE_GAP:.0e})", flush=True)
    if not gap < TIE_GAP:
        fail("greedy generate_long ids differ between GPU and CPU")



def throughput(model, ms):
    """tokens/s of each NUWA request, from serve()'s CUDA-event ms (each
    request's only run: repeating the host-bound token loops to time them
    again cost the script about a minute)."""
    n, nf = model.max_video_tokens, 2 * model.max_video_frames
    rates = {}
    for name, tokens, served in (("generate b=1", n, "generate b=1"),
                                 ("generate b=8", 8 * n, "generate b=8"),
                                 (f"generate_long b=1 ({nf} frames)", 2 * n,
                                  "generate_long b=1")):
        rates[name] = tokens / (ms[served] / 1e3)
        print(f"{name}: {ms[served]:.1f} ms per request, {rates[name]:.1f} tokens/s",
              flush=True)
    return rates


def device_share(model, texts):
    """Device busy share of one NUWA generate (b=1, one frame)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    share(lambda: model.generate(texts[1], generator=gen, num_frames=1),
          "generate b=1, 1 frame")


def share(call, name, wall=None):
    """Device busy share of one request: kernel time from torch.profiler
    (device activity only) over the wall time of the same request
    unprofiled (``wall``, measured here unless given). Returns the kernel
    ms (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    if wall is None:
        wall = cuda_ms(call, iters=1, reps=3, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return
    print(f"{name}: {wall:.1f} ms wall, {busy:.2f} ms of kernels "
          f"({100 * busy / wall:.2f}% busy, {sum(e.count for e in kernels)} "
          f"kernel launches)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}", flush=True)
    return busy


# ---------------------------------------------------------------------------
# sketch serving: the SparseCross2DNA kernel and NUWASketch
# ---------------------------------------------------------------------------

SKETCH_FMAP = SKETCH["image_size"] // 2 ** SKETCH_VAE["num_layers"]
SKETCH_T = SKETCH["max_video_frames"] * SKETCH_FMAP**2  # forward's video queries


def cross_inputs(b, t, frames, fmap, dtype, gen):
    """q (pre-scaled), k, v, null k/v and talking heads, as SparseCross2DNA
    hands them to the kernel."""
    h, d, lc = HEADS, DIM_HEAD, frames * fmap * fmap

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    th = (torch.rand(h, h, generator=gen, device="cuda") * 2 - 1) * (3 / h) ** 0.5
    return (rnd(b, h, t, d, scale=d**-0.5), rnd(b, h, lc, d), rnd(b, h, lc, d),
            rnd(b, h, 1, d), rnd(b, h, 1, d), th)


def cross_masks(b, frames, fmap):
    """The context masks of the check: all True; the last context frame of
    the last batch row masked (a padded sketch frame); all False (the
    unconditional half of a CFG batch)."""
    hw = fmap * fmap
    ones = torch.ones(b, frames * hw, dtype=torch.bool, device="cuda")
    one_frame = ones.clone()
    one_frame[-1, (frames - 1) * hw:] = False
    return {"all True": ones, "one frame masked": one_frame, "all False": ~ones}


def check_cross(kcross):
    """The kernel against its plain version over fp32 and bf16, one and two
    context frames, fmap 16 and 4, dilations 1 and 2, full, ragged and
    single query tokens (5 query frames), b 1 and 2 and every mask. Errors
    over each reference's max abs (at least 1): out within the dtype's
    tolerance (bf16 rounds it to 2**-8 of the value), the fp32 lse within
    fp32's in both runs. Returns the largest absolute error at each context
    frame count."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst_rel, worst_abs, cases = {}, {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for frames in (1, 2):
            for fmap in (SKETCH_FMAP, 4):
                full = SKETCH["max_video_frames"] * fmap * fmap
                for dil in (1, 2):
                    for t in (full, full - fmap - 1, 1):
                        for b in (1, 2):
                            args = cross_inputs(b, t, frames, fmap, dtype, gen)
                            kw = dict(fmap=fmap, kernel_size=3, dilation=dil)
                            for mname, mask in cross_masks(b, frames, fmap).items():
                                out, lse = kcross.sparse_cross_2dna_fwd(*args, mask, **kw)
                                torch.cuda.synchronize()
                                ref, ref_lse = kcross.sparse_cross_2dna_fwd_plain(
                                    *args, mask, **kw)
                                if out.dtype != dtype or out.shape != ref.shape:
                                    fail(f"cross kernel out {out.dtype} {tuple(out.shape)}")
                                for name, a, w, tol in (("out", out, ref, TOL[dtype]),
                                                        ("lse", lse, ref_lse,
                                                         TOL[torch.float32])):
                                    err = (a.float() - w.float()).abs().max().item()
                                    rel = err / max(1.0, w.float().abs().max().item())
                                    if not rel <= tol:
                                        fail(f"sparse_cross_2dna_fwd {name} Fc={frames} "
                                             f"fmap={fmap} dil={dil} t={t} b={b} {dtype} "
                                             f"mask {mname}: error {rel} of the max abs "
                                             f"> {tol}")
                                    key = (dtype, name)
                                    worst_rel[key] = max(worst_rel.get(key, 0.0), rel)
                                    worst_abs[frames] = max(worst_abs.get(frames, 0.0), err)
                                cases += 1
    for (dtype, name), rel in worst_rel.items():
        tol = TOL[dtype if name == "out" else torch.float32]
        print(f"sparse_cross_2dna_fwd {name} vs plain, {dtype}: max error {rel:.3e} of "
              f"the reference's max abs (tolerance {tol:.0e}, {cases // 2} cases)", flush=True)
    return worst_abs


def cross_bound(kcross, b, t, frames, mask, dtype):
    """(least time, what bounds it) of the op on these inputs: q, k, v, the
    null rows, the talking heads and the mask read once, out and lse written
    once; operations for the valid (query, key) pairs of this mask, the null
    column included, and the talking-heads mix of every slot."""
    h, d, es = HEADS, DIM_HEAD, torch.finfo(dtype).bits // 8
    lc = frames * SKETCH_FMAP**2
    nbytes = (2 * b * h * t * d * es + b * h * t * 4 + 2 * b * h * lc * d * es
              + 2 * b * h * d * es + h * h * 4 + b * lc)
    pairs = h * (kcross.valid_pairs(t, mask, fmap=SKETCH_FMAP, kernel_size=3, dilation=1)
                 + b * t)
    mixes = b * t * (frames * 9 + 1) * 2 * h * h
    return bound_ms(nbytes, pairs * 4 * d + mixes, dtype)


def time_cross(kcross):
    """The kernel at the forward shape: bf16, b = 2, 1280 video queries, 8
    heads of 64, kernel 3, dilation 1; two context frames (Lc 512) with the
    forward's mask (the second sketch frame of row 1 padded) and one (Lc
    256)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    b, t, dtype = 2, SKETCH_T, torch.bfloat16
    rows = {}
    for frames in (2, 1):
        args = cross_inputs(b, t, frames, SKETCH_FMAP, dtype, gen)
        mask = torch.ones(b, frames * SKETCH_FMAP**2, dtype=torch.bool, device="cuda")
        mask[1, SKETCH_FMAP**2:] = False  # no-op at one frame
        kw = dict(fmap=SKETCH_FMAP, kernel_size=3, dilation=1)
        ms = device_ms(lambda: kcross.sparse_cross_2dna_fwd(*args, mask, **kw))
        plain = device_ms(lambda: kcross.sparse_cross_2dna_fwd_plain(*args, mask, **kw), iters=5)
        bound, by = cross_bound(kcross, b, t, frames, mask, dtype)
        tiles = cross_tiles_text(kcross, args[0], frames * SKETCH_FMAP**2, kw, ("cross_fwd",))
        rows[frames] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, tiles=tiles)
        print(f"sparse_cross_2dna_fwd bf16 b={b} t={t} Lc={frames * SKETCH_FMAP**2}: kernel "
              f"{ms:.4f} ms (device), plain {plain:.4f} ms, bound {bound:.5f} ms ({by}), "
              f"kernel / bound {ms / bound:.1f}x; {tiles}", flush=True)
    return rows


def sketch_models(NUWASketch, VQGanVAE, device="cuda", dtype="bfloat16", seed=SEED, **kw):
    vae = VQGanVAE(**SKETCH_VAE, device=device, seed=seed + 20)
    return NUWASketch(vae=vae, sketch_vae=vae, **dict(SKETCH, **kw), compute_dtype=dtype,
                      device=device, seed=seed)


def sketch_request(b, frames, gen):
    """Pixels in [0, 1] made from a seed: b sketches of ``frames`` frames
    (one frame as (b, c, h, w)) and b videos of max_video_frames."""
    size = SKETCH["image_size"]
    sketch = torch.rand(b, frames, 3, size, size, generator=gen)
    video = torch.rand(b, SKETCH["max_video_frames"], 3, size, size, generator=gen)
    return (sketch[:, 0] if frames == 1 else sketch), video


def serve_sketch(NUWASketch, VQGanVAE, knda):
    """NUWASketch serving at full width, bf16: each request with the counts
    set to 0 just before it and read just after, and timed with CUDA events
    (the throughput phase reports the generates'). Per decoder layer, a forward
    and every generate_long prefill launch the cross kernel once and the
    Sparse3DNA forward once; cached steps gather in plain PyTorch."""
    model = sketch_models(NUWASketch, VQGanVAE)
    short = sketch_models(NUWASketch, VQGanVAE, max_video_frames=2)
    gen = torch.Generator().manual_seed(SEED + 14)
    sketch2, video = sketch_request(2, 2, gen)
    sketch1, _ = sketch_request(2, 1, gen)
    mask2 = torch.tensor([[True, True], [True, False]])  # row 1's second frame is padding
    req4 = sketch_request(4, 2, gen)[0]
    mask4 = torch.tensor([[True, True]] * 3 + [[True, False]])
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    depth, tpf, size = SKETCH["dec_depth"], SKETCH_FMAP**2, SKETCH["image_size"]
    logits = (2, SKETCH_T + 1, SKETCH_VAE["vq_codebook_size"])
    requests = {
        "forward b=2, 2-frame sketch": (
            torch.no_grad()(lambda: model(sketch2, video, sketch_mask=mask2)), logits,
            {"fwd": depth, "cross": depth}, 2),
        "forward b=2, 1-frame sketch": (
            torch.no_grad()(lambda: model(sketch1, video)), logits,
            {"fwd": depth, "cross": depth}, 1),
        "generate b=1, 1 frame, pixels": (
            lambda: model.generate(sketch1[:1], generator=g, num_frames=1),
            (1, 1, 3, size, size), {"fwd": 0, "cross": 0}, 1),
        "generate b=4, 1 frame, pixels": (
            lambda: model.generate(req4, sketch_mask=mask4, generator=g, num_frames=1),
            (4, 1, 3, size, size), {"fwd": 0, "cross": 0}, 2),
        "generate_long b=1, 3 frames on a 2-frame window, pixels": (
            lambda: short.generate_long(sketch2[:1], generator=g, num_frames=3),
            (1, 3, 3, size, size), {"fwd": depth, "cross": depth}, 2),
    }
    cross = {1: 0, 2: 0}  # cross kernel launches by context frames
    fwd, ms = 0, {}
    for name, (call, shape, expect, frames) in requests.items():
        reset_launches(knda)
        out, ms[name] = timed(call)
        got = launch_counts(knda)
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            fail(f"{name}: {tuple(out.shape)} not finite or not {shape}")
        want = expect_launches(**expect)
        if got != want:
            fail(f"{name}: launches {got}, expected {want}")
        cross[frames] += got["cross"]
        fwd += got["fwd"]
        print(f"{name}: {tuple(out.shape)} finite, launches sparse_cross_2dna_fwd "
              f"{got['cross']}, sparse_3dna_fwd {got['fwd']} (as expected)", flush=True)
    return model, (sketch1, sketch2, mask2, req4, mask4), cross, fwd, ms


def sketch_top2_gap(model, sketch, ids, p, cond_scale):
    """Top-2 logit gap of the (CPU) model at the first differing position p
    of a sliding-window rollout."""
    tpf, maxf = model.tokens_per_frame, model.max_video_frames
    start = max(p // tpf - (maxf - 1), 0) * tpf
    with torch.no_grad():
        ctx, cmask = model._sketch_context(sketch, None, True)
        row = model._decode_logits(ids[:, start:p].repeat(2, 1), ctx, cmask)[:, p - start]
    logits = row[1:] + (row[:1] - row[1:]) * cond_scale
    top = logits.topk(2, dim=-1).values[0]
    return (top[0] - top[1]).item()


def sketch_side(device):
    """sketch_against_cpu's run on ``device``: the codec's sketch and video
    ids and the forward logits of the fp32 sketch model at CHECK_DEPTH, then
    the greedy generate_long ids of its 2-frame-window copy."""
    from nuwa_tpu_torch import NUWASketch, VQGanVAE

    sketch, video = sketch_request(1, 2, torch.Generator().manual_seed(SEED + 16))
    model = sketch_models(NUWASketch, VQGanVAE, device=device, dtype=None, seed=SEED + 17,
                          dec_depth=CHECK_DEPTH)
    start = time.perf_counter()
    with torch.no_grad():
        ids = (model.sketch_vae.get_video_indices(sketch).cpu(),
               model.vae.get_video_indices(video).cpu())
        logits = model(sketch, video, sketch_mask=torch.tensor([[True, False]])).cpu()
    print(f"fp32 sketch encode and forward on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    model = sketch_window_model(device)
    start = time.perf_counter()
    thres = 1 - 0.5 / SKETCH_VAE["vq_codebook_size"]  # top-k keeps k = 1: greedy
    greedy = model.generate_long(sketch, num_frames=3, filter_thres=thres,
                                 decode_video=False).cpu()
    print(f"fp32 greedy sketch generate_long on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return ids, logits, greedy


def sketch_window_model(device):
    from nuwa_tpu_torch import NUWASketch, VQGanVAE

    return sketch_models(NUWASketch, VQGanVAE, device=device, dtype=None, seed=SEED + 17,
                         max_video_frames=2, dec_depth=CHECK_DEPTH)


def sketch_against_cpu(refs):
    """Same weights in fp32: GPU (kernels) vs CPU (plain path, ``refs``):
    sketch and video token ids of the VAE encode, forward logits, greedy
    generate_long ids."""
    (ids_gpu, lg_gpu, gr_gpu), (ids_cpu, lg_cpu, gr_cpu) = (sketch_side("cuda"),
                                                            refs.result("sketch"))
    for name, a, b in zip(("sketch", "video"), ids_gpu, ids_cpu):
        same = int((a == b).sum())
        print(f"fp32 {name} token ids (VAE encode) GPU vs CPU: {same} of {b.numel()} equal",
              flush=True)
        if same != b.numel():
            fail(f"{name} token ids differ between GPU and CPU")
    err = (lg_gpu - lg_cpu).abs().max().item()
    print(f"sketch forward fp32 logits GPU vs CPU: max abs err {err:.3e} "
          f"(tolerance {LOGITS_ATOL:.0e})", flush=True)
    if not err <= LOGITS_ATOL:
        fail("sketch forward logits differ between GPU and CPU")
    diff = (gr_gpu != gr_cpu).nonzero()
    if len(diff) == 0:
        print(f"greedy sketch generate_long fp32 ids GPU vs CPU: all {gr_cpu.numel()} "
              f"equal", flush=True)
        return
    p = diff[0, 1].item()
    sketch, _ = sketch_request(1, 2, torch.Generator().manual_seed(SEED + 16))
    gap = sketch_top2_gap(sketch_window_model("cpu"), sketch, gr_cpu, p, 2.0)
    print(f"greedy sketch generate_long ids differ first at position {p}; CPU top-2 "
          f"logit gap there {gap:.3e} (a tie below {TIE_GAP:.0e})", flush=True)
    if not gap < TIE_GAP:
        fail("greedy sketch generate_long ids differ between GPU and CPU")



def sketch_throughput(model, inputs, ms):
    """tokens/s of each sketch request: the forward timed once more (its
    serving run was the model's first forward), the generates from
    serve_sketch's CUDA-event ms (each one's only run: timing the host-bound
    token loops again cost the script about half a minute); and the
    device's busy share of the b = 1 generate."""
    sketch1, sketch2, mask2, req4, mask4 = inputs
    _, video = sketch_request(2, 2, torch.Generator().manual_seed(SEED + 18))
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    tpf = SKETCH_FMAP**2
    walls = {"sketch forward b=2 (scoring)": cuda_ms(
        torch.no_grad()(lambda: model(sketch2, video, sketch_mask=mask2)), iters=1, reps=1,
        warmup=0)}
    for name, served in (("sketch generate b=1, 1 frame", "generate b=1, 1 frame, pixels"),
                         ("sketch generate b=4, 1 frame", "generate b=4, 1 frame, pixels"),
                         ("sketch generate_long b=1, 3 frames",
                          "generate_long b=1, 3 frames on a 2-frame window, pixels")):
        walls[name] = ms[served]
    for name, tokens in (("sketch forward b=2 (scoring)", 2 * SKETCH_T),
                         ("sketch generate b=1, 1 frame", tpf),
                         ("sketch generate b=4, 1 frame", 4 * tpf),
                         ("sketch generate_long b=1, 3 frames", 3 * tpf)):
        print(f"{name}: {walls[name]:.1f} ms per request, "
              f"{tokens / (walls[name] / 1e3):.1f} tokens/s", flush=True)
    name = "sketch generate b=1, 1 frame"
    share(lambda: model.generate(sketch1[:1], generator=g, num_frames=1), name, walls[name])


# ---------------------------------------------------------------------------
# sketch training: the cross backward, centered Sparse3DNA and NUWASketch
# ---------------------------------------------------------------------------

# the JAX package's NUWASketch training config (scripts/bench_sketch_train.py:38-57)
SKETCH_TRAIN = dict(
    dim=512, image_size=32, max_video_frames=10, sketch_max_video_frames=1,
    sketch_enc_depth=2, sketch_enc_dim_head=64, sketch_enc_heads=8, dec_depth=6,
    dec_dim_head=64, dec_heads=8, dec_reversible=True, sparse_3dna_kernel_size=(5, 3, 3),
    sparse_3dna_dilation=(1, 2, 4), shift_video_tokens=True, cross_2dna_kernel_size=3,
    cross_2dna_dilation=1,
)
# the same widths with BASELINE.json config 4's sketch side: a separate
# 5-channel sketch VAE, a centered Sparse3DNA sketch encoder, two sketch frames
SKETCH_TRAIN_VARIANTS = {
    "a": dict(SKETCH_TRAIN),
    "b": dict(SKETCH_TRAIN, sketch_max_video_frames=2, sketch_enc_use_sparse_3dna=True),
}
SKETCH_TRAIN_BATCH, SKETCH_TRAIN_STEPS = 2, 4
SKETCH_TRAIN_T = SKETCH_TRAIN["max_video_frames"] * SKETCH_FMAP**2 - 1  # bos first
CROSS_BWD_NAMES = ("dq", "ds", "mix", "dnull_k", "dnull_v", "dth", "dk", "dv")


def check_cross_bwd(kcross):
    """The query-side and key-side cross backward against their plain
    versions over fp32 and bf16, one to three context frames, fmap 16 and 4,
    dilations 1 and 2, full, ragged and single query tokens (5 query
    frames), b 1 and 2 and every mask. Each backward takes the lse of its own
    forward, as the autograd function gives it: a row whose context is all
    masked has P = 1 on the null column, and its dS there, P * dP * (1 - P),
    is 0 only if P is exactly 1, which an lse from the other path's sums
    would leave to rounding (about 1e-5 of dq in fp32). Errors over each
    reference's max abs (at least 1): dq, dk and dv within the dtype's
    tolerance (bf16 rounds them to 2**-8 of the value), the fp32 outputs
    (dS, mix, the null and talking-heads cotangents) within fp32's in both
    runs; sums over queries run in atomics' order. Returns the largest
    absolute error of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    worst_rel, worst_abs, cases = {}, {}, 0
    for dtype, frames, fmap, dil, t_off, b in itertools.product(
            (torch.float32, torch.bfloat16), (1, 2, 3), (SKETCH_FMAP, 4), (1, 2),
            (0, None, -1), (1, 2)):
        full = SKETCH["max_video_frames"] * fmap * fmap
        t = {0: full, None: full - fmap - 1, -1: 1}[t_off]
        args = cross_inputs(b, t, frames, fmap, dtype, gen)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype)
        kw = dict(fmap=fmap, kernel_size=3, dilation=dil)
        for mname, mask in cross_masks(b, frames, fmap).items():
            _, lse = kcross.sparse_cross_2dna_fwd(*args, mask, **kw)
            _, ref_lse = kcross.sparse_cross_2dna_fwd_plain(*args, mask, **kw)
            got = kcross.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **kw)
            want = kcross.sparse_cross_2dna_bwd_q_plain(*args, mask, g, ref_lse, **kw)
            got += kcross.sparse_cross_2dna_bwd_kv(args[0], g, *want[1:3], **kw)
            want += kcross.sparse_cross_2dna_bwd_kv_plain(args[0], g, *want[1:3], **kw)
            torch.cuda.synchronize()
            for name, a, w in zip(CROSS_BWD_NAMES, got, want):
                if a.dtype != w.dtype or a.shape != w.shape:
                    fail(f"cross {name}: {a.dtype} {tuple(a.shape)} != {w.dtype} "
                         f"{tuple(w.shape)}")
                err = (a.float() - w.float()).abs().max().item()
                rel = err / max(1.0, w.float().abs().max().item())
                rounded = name in ("dq", "dk", "dv")
                tol = TOL[dtype if rounded else torch.float32]
                if not rel <= tol:
                    fail(f"sparse_cross_2dna backward {name} Fc={frames} fmap={fmap} "
                         f"dil={dil} t={t} b={b} {dtype} mask {mname}: error {rel} of the "
                         f"max abs > {tol}")
                kname = "bwd_kv" if name in ("dk", "dv") else "bwd_q"
                key = (kname, dtype, rounded)
                worst_rel[key] = max(worst_rel.get(key, 0.0), rel)
                worst_abs[kname] = max(worst_abs.get(kname, 0.0), err)
            cases += 1
    for (kname, dtype, rounded), rel in sorted(worst_rel.items(), key=str):
        tol = TOL[dtype if rounded else torch.float32]
        which = f"outputs in {dtype}" if rounded else "fp32 outputs"
        print(f"sparse_cross_2dna_{kname} vs plain, {dtype} inputs, {which}: max error "
              f"{rel:.3e} of the reference's max abs (tolerance {tol:.0e}, "
              f"{cases // 2} cases)", flush=True)
    return worst_abs


def check_cross_autograd(kcross):
    """The cross autograd function (kernels forward and backward) against
    torch.autograd of the plain forward, fp32, at the training shape of
    model (b) (t = 2559, two context frames, the second masked in row 1):
    every input's gradient within 1e-5 of its max abs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    t = SKETCH_TRAIN_T
    args = [x.requires_grad_() for x in cross_inputs(2, t, 2, SKETCH_FMAP, torch.float32, gen)]
    mask = cross_masks(2, 2, SKETCH_FMAP)["one frame masked"]
    g = torch.randn(args[0].shape, generator=gen, device="cuda")
    kw = dict(fmap=SKETCH_FMAP, kernel_size=3, dilation=1)
    out, _ = kcross.sparse_cross_2dna_fwd_plain(*args, mask, **kw)
    want = torch.autograd.grad(out, args, g)
    got = torch.autograd.grad(kcross.sparse_cross_2dna(*args, mask, **kw), args, g)
    worst = 0.0
    for name, a, w in zip(("q", "k", "v", "null_k", "null_v", "talking_heads"), got, want):
        rel = (a - w).abs().max().item() / max(1.0, w.abs().max().item())
        if not rel <= 1e-5:
            fail(f"sparse_cross_2dna autograd: d{name} error {rel} of the max abs > 1e-5")
        worst = max(worst, rel)
    print(f"sparse_cross_2dna autograd function vs autograd of the plain forward, fp32, "
          f"b=2 t={t} Lc=512: max error {worst:.3e} of the max abs (tolerance 1e-5)",
          flush=True)


def cross_bwd_bounds(kcross, b, t, frames, mask, dtype):
    """{kernel: (least time, what bounds it)} of the cross backward on these
    inputs: each input read once, each output written once; operations for
    the valid (query, key) pairs of this mask, the null column included.
    "bwd" is the whole backward as a function (q, g, k, v, the null rows,
    lse, the talking heads and the mask in; dq, dk, dv, the null and
    talking-heads cotangents out), with no dS or mix between its kernels."""
    h, d, es = HEADS, DIM_HEAD, torch.finfo(dtype).bits // 8
    lc, kn = frames * SKETCH_FMAP**2, frames * 9
    row, ctx, null = b * h * t * d * es, b * h * lc * d * es, b * h * d * es
    lse, th, cmask = b * h * t * 4, h * h * 4, b * lc
    sums = 2 * b * h * d * 4 + th  # dnull_k, dnull_v, dth in fp32
    slots = 2 * b * h * t * (kn + 1) * 4  # dS and mix, fp32
    pairs = h * (kcross.valid_pairs(t, mask, fmap=SKETCH_FMAP, kernel_size=3, dilation=1)
                 + b * t)
    mixes = b * t * (kn + 1) * 2 * h * h
    # scores, dA and dq, the null sums, the mixes of dP and P and the dth sum
    ops_q = pairs * 6 * d + b * t * h * 4 * d + 3 * mixes
    ops_kv = (pairs - b * h * t) * 4 * d  # dK and dV over the window slots
    return {
        "bwd_q": bound_ms(2 * row + 2 * ctx + 2 * null + lse + th + cmask + row + slots + sums,
                          ops_q, dtype),
        "bwd_kv": bound_ms(2 * row + slots + 2 * ctx, ops_kv, dtype),
        "bwd": bound_ms(2 * row + 2 * ctx + 2 * null + lse + th + cmask + row + 2 * ctx + sums,
                        ops_q + ops_kv, dtype),
    }


def time_cross_bwd(kcross):
    """The cross forward and the two backward kernels at the training shape:
    bf16, b = 2, t = 2559 video queries, 8 heads of 64, kernel 3, dilation
    1; one context frame (Lc 256, model (a)) and two with the second masked
    in row 1 (Lc 512, model (b))."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    b, t, dtype = SKETCH_TRAIN_BATCH, SKETCH_TRAIN_T, torch.bfloat16
    rows = {}
    for frames in (1, 2):
        args = cross_inputs(b, t, frames, SKETCH_FMAP, dtype, gen)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype)
        mask = torch.ones(b, frames * SKETCH_FMAP**2, dtype=torch.bool, device="cuda")
        mask[1, SKETCH_FMAP**2:] = False  # no-op at one frame
        kw = dict(fmap=SKETCH_FMAP, kernel_size=3, dilation=1)
        _, lse = kcross.sparse_cross_2dna_fwd(*args, mask, **kw)
        _, ds, mix, *_ = kcross.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **kw)
        bounds = cross_bwd_bounds(kcross, b, t, frames, mask, dtype)
        print(f"cross backward b={b} t={t} Lc={frames * SKETCH_FMAP**2}: "
              f"{cross_tiles_text(kcross, args[0], frames * SKETCH_FMAP**2, kw)}", flush=True)
        fwd_ms = device_ms(lambda: kcross.sparse_cross_2dna_fwd(*args, mask, **kw))
        bound, by = cross_bound(kcross, b, t, frames, mask, dtype)
        print(f"sparse_cross_2dna_fwd bf16 b={b} t={t} Lc={frames * SKETCH_FMAP**2}: kernel "
              f"{fwd_ms:.4f} ms (device), bound {bound:.5f} ms ({by}), kernel / bound "
              f"{fwd_ms / bound:.1f}x", flush=True)
        for name, kernel, plain in (
            ("bwd_q", lambda: kcross.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **kw),
             lambda: kcross.sparse_cross_2dna_bwd_q_plain(*args, mask, g, lse, **kw)),
            ("bwd_kv", lambda: kcross.sparse_cross_2dna_bwd_kv(args[0], g, ds, mix, **kw),
             lambda: kcross.sparse_cross_2dna_bwd_kv_plain(args[0], g, ds, mix, **kw)),
        ):
            ms, plain_ms = device_ms(kernel), device_ms(plain, iters=5)
            bound, by = bounds[name]
            tiles = cross_tiles_text(kcross, args[0], frames * SKETCH_FMAP**2, kw,
                                     (f"cross_{name}",))
            rows[name, frames] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                      backward_bound_ms=bounds["bwd"][0], tiles=tiles)
            print(f"sparse_cross_2dna_{name} bf16 b={b} t={t} Lc={frames * SKETCH_FMAP**2}: "
                  f"kernel {ms:.4f} ms (device), plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
                  f"({by}), kernel / bound {ms / bound:.1f}x", flush=True)
        both = rows["bwd_q", frames]["ms"] + rows["bwd_kv", frames]["ms"]
        bound, by = bounds["bwd"]
        print(f"sparse_cross_2dna backward (bwd_q + bwd_kv) bf16 Lc={frames * SKETCH_FMAP**2}: "
              f"{both:.4f} ms, bound of the whole backward {bound:.5f} ms ({by}), kernels / "
              f"bound {both / bound:.1f}x", flush=True)
    return rows


def sketch_train_model(NUWASketch, VQGanVAE, variant, device="cuda", dtype="bfloat16",
                       seed=SEED, dropout=0.0, **kw):
    """Model (a) or (b) from a seed, ``dropout`` its ``attn_dropout`` and
    ``ff_dropout``, ``kw`` over its config."""
    vae = VQGanVAE(**SKETCH_VAE, device=device, seed=seed + 20)
    sketch_vae = (VQGanVAE(**SKETCH_VAE, channels=5, device=device, seed=seed + 21)
                  if variant == "b" else vae)
    return NUWASketch(vae=vae, sketch_vae=sketch_vae, **dict(SKETCH_TRAIN_VARIANTS[variant], **kw),
                      attn_dropout=dropout, ff_dropout=dropout, compute_dtype=dtype,
                      device=device, seed=seed)


def sketch_train_batch(variant, gen):
    """One batch made from a seed: sketches (model (a): one 3-channel frame;
    (b): two 5-channel frames, the second padded in row 1), videos of all
    frames, and the sketch mask."""
    cfg, size = SKETCH_TRAIN_VARIANTS[variant], SKETCH_TRAIN["image_size"]
    frames, channels = (2, 5) if variant == "b" else (1, 3)
    sketch = torch.rand(SKETCH_TRAIN_BATCH, frames, channels, size, size, generator=gen)
    video = torch.rand(SKETCH_TRAIN_BATCH, cfg["max_video_frames"], 3, size, size,
                       generator=gen)
    mask = torch.tensor([[True, True], [True, False]]) if variant == "b" else None
    return sketch, video, mask


def train_sketch(NUWASketch, VQGanVAE, knda, dropout=0.0):
    """NUWASketch training at full width, bf16, both variants: forward with
    the loss (condition dropout 0.2, drawn from a seeded generator), the
    backward, global-norm clipping at 0.5 and an AdamW step, SKETCH_TRAIN_STEPS
    times on one seeded batch, the counts set to 0 before each step and read
    after it. Per step the reversible decoder launches the cross forward and
    B1 2 x depth times (the forward, then each couple's recompute in the
    backward) and each backward kernel depth times; model (b)'s centered
    encoder adds one centered B1, B2 and B3 per layer. With ``dropout`` (the
    models' ``attn_dropout`` and ``ff_dropout``) every one of those launches
    is a dropout launch. Returns the launches of all steps by context frames
    and each variant's median step ms."""
    from nuwa_tpu_torch.train import clip_by_global_norm_, get_optimizer

    depth, enc = SKETCH_TRAIN["dec_depth"], SKETCH_TRAIN["sketch_enc_depth"]
    total = {frames: expect_launches() for frames in (1, 2)}  # by context frames
    step_ms = {}
    for variant in ("a", "b"):
        c = enc if variant == "b" else 0
        counts = dict(fwd=2 * depth + c, bwd_q=depth + c, bwd_kv=depth + c, cross=2 * depth,
                      cross_bwd_q=depth, cross_bwd_kv=depth)
        expect = expect_launches(
            **counts, fwd_centered=c, bwd_q_centered=c, bwd_kv_centered=c,
            **({f"{k}_dropout": n for k, n in counts.items()} if dropout else {}))
        label = f"sketch train ({variant}, dropout {dropout})" if dropout else (
            f"sketch train ({variant})")
        model = sketch_train_model(NUWASketch, VQGanVAE, variant, dropout=dropout)
        params = [p for p in model.parameters() if p.requires_grad]
        opt = get_optimizer(params, lr=3e-4, wd=0.01)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
        sketch, video, mask = sketch_train_batch(variant, torch.Generator().manual_seed(SEED + 26))

        def step():
            loss = model(sketch, video, sketch_mask=mask, return_loss=True, train=True,
                         generator=gen)
            loss.backward()
            clip_by_global_norm_(params, 0.5)
            opt.step()
            opt.zero_grad(set_to_none=True)
            return loss.detach()

        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(SKETCH_TRAIN_STEPS):
            reset_launches(knda)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(loss.item())
            got = launch_counts(knda)
            if got != expect:
                fail(f"{label} step {i}: launches {got}, expected {expect}")
            frames = 2 if variant == "b" else 1
            total[frames] = {k: total[frames][k] + got[k] for k in got}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(map(math.isfinite, losses)):
            fail(f"{label} losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"{label} loss did not fall: {losses}")
        ms = step_ms[variant] = statistics.median(times[1:])
        tokens = SKETCH_TRAIN_BATCH * SKETCH_TRAIN["max_video_frames"] * SKETCH_FMAP**2
        shown = {k: v for k, v in expect.items() if v}
        print(f"{label}: losses {', '.join(f'{x:.4f}' for x in losses)} "
              f"(finite, falling); launches per step {shown} (as expected, every step)",
              flush=True)
        print(f"{label} step (b={SKETCH_TRAIN_BATCH}, {tokens} video tokens): "
              f"{ms:.1f} ms median of steps 1-{SKETCH_TRAIN_STEPS - 1} (step 0: "
              f"{times[0]:.1f} ms), {tokens / (ms / 1e3):.0f} video tokens/s, peak memory "
              f"{peak:.2f} GiB", flush=True)
        share(step, f"{label} step", wall=ms)
        del model, opt, params
        torch.cuda.empty_cache()
    return total, step_ms


def sketch_train_side(device, dropout):
    """sketch_train_against_cpu's run on ``device``: model (b)'s fp32 loss
    and every trained parameter's gradient at CHECK_DEPTH, and the names of
    its SparseCross2DNA modules."""
    from nuwa_tpu_torch import NUWASketch, VQGanVAE

    sketch, video, mask = sketch_train_batch("b", torch.Generator().manual_seed(SEED + 27))
    model = sketch_train_model(NUWASketch, VQGanVAE, "b", device=device, dtype=None,
                               seed=SEED + 28, dropout=dropout, dec_depth=CHECK_DEPTH)
    start = time.perf_counter()
    loss = model(sketch, video, sketch_mask=mask, return_loss=True, train=True,
                 uncond=torch.tensor([True, False]),
                 generator=torch.Generator().manual_seed(SEED + 29))
    loss.backward()
    what = f"sketch train, dropout {dropout}," if dropout else "sketch train"
    print(f"fp32 {what} forward and backward on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    cross = [n for n, m in model.named_modules() if type(m).__name__ == "SparseCross2DNA"]
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.requires_grad}, cross


def sketch_train_against_cpu(refs, dropout=0.0):
    """Model (b)'s weights in fp32, one batch with a fixed condition-dropout
    mask (row 0 unconditional: its context all masked; row 1 with its
    second sketch frame padded): the GPU path (kernels) against the CPU
    plain path (``refs``), the loss and every parameter's gradient, reported
    by group (the sketch encoder, the cross layers, their null key/value and
    the talking-heads matrices). With ``dropout`` (the model's
    ``attn_dropout`` and ``ff_dropout``) both draw their one dropout seed
    from the same CPU generator, so they drop the same pairs."""
    what = f"sketch train, dropout {dropout}," if dropout else "sketch train"
    (loss_gpu, g_gpu, cross), (loss_cpu, g_cpu, _) = (sketch_train_side("cuda", dropout),
                                                      refs.result(("sketch train", dropout)))
    groups = {
        "sketch encoder": lambda n: n.startswith("sketch_transformer."),
        "cross layers": lambda n: any(n.startswith(c + ".") for c in cross),
        "null key/value": lambda n: n.endswith((".null_k", ".null_v")),
        "talking heads": lambda n: n.endswith(".talking_heads"),
        "all": lambda n: True,
    }
    worst = {}
    for name, ref in g_cpu.items():
        rel = (g_gpu[name] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        for group, member in groups.items():
            if member(name) and rel >= worst.get(group, (-1.0, None))[0]:
                worst[group] = (rel, name)
    print(f"fp32 {what} GPU vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f} (tolerance "
          f"{LOSS_ATOL:.0e}); {len(g_cpu)} gradients, each within {GRAD_REL:.0e} of its max "
          f"abs:", flush=True)
    if set(worst) != set(groups):
        fail(f"{what} gradients: groups {sorted(set(groups) - set(worst))} are empty")
    for group in groups:
        rel, name = worst[group]
        print(f"  {group}: largest error {rel:.3e} of the max abs at {name}", flush=True)
    if not abs(loss_gpu - loss_cpu) <= LOSS_ATOL:
        fail(f"the {what} loss differs between GPU and CPU")
    if not worst["all"][0] <= GRAD_REL:
        fail(f"{what} gradients differ between GPU and CPU")



# ---------------------------------------------------------------------------
# NUWA at 128 px: the row-blocked frames (HW > 256), deterministic backward
# sums, and the model from captions and pixels
# ---------------------------------------------------------------------------

# BASELINE.json config 3 ("NUWA sparse-3DNA: 128px, 10 frames, kernel (5,3,3),
# dilation (1,2,4), shift_video_tokens, reversible decoder") at full width,
# with config 1's codec (2 layers: fmap 32, 1,024 tokens a frame) on 128-px
# frames and the text encoder of FULL
NUWA128_VAE = dict(dim=64, image_size=128, num_layers=2, vq_codebook_size=512)
NUWA128 = dict(
    dim=512, max_video_frames=10, text_num_tokens=49408, text_max_seq_len=32,
    text_enc_depth=2, text_enc_heads=8, text_enc_dim_head=64, dec_depth=6, dec_heads=8,
    dec_dim_head=64, dec_reversible=True, sparse_3dna_kernel_size=(5, 3, 3),
    sparse_3dna_dilation=(1, 2, 4), sparse_3dna_rel_pos_bias=True, shift_video_tokens=True,
)
FMAP128 = NUWA128_VAE["image_size"] // 2 ** NUWA128_VAE["num_layers"]
T128 = NUWA128["max_video_frames"] * FMAP128**2 - 1  # training's video queries: 10,239
NUWA128_BATCH, NUWA128_STEPS = 2, 4
SIZE128, VOCAB128 = NUWA128_VAE["image_size"], NUWA128_VAE["vq_codebook_size"]
CAPTIONS = (
    "a red square slides to the right across a dark field",
    "a small blue square drifts down and to the left",
    "a green square bounces along the bottom edge",
    "a white square moves slowly up the frame",
)
NUWA128_RESULTS = "smoke_results/nuwa128"  # the trainer's PNG samples (gitignored)


def check_rb(knda):
    """The three Sparse3DNA kernels past HW 256, the frames the JAX package
    gives its row-blocked kernels (or dense XLA): the fmap-32 training
    shape (b = 2, t = 10,239, kernel (5, 3, 3), dilations 1, 2 and 4, with
    and without the bias, causal and centered; t = F * HW - 1 leaves a
    phantom token that centered windows reach), and fmap 12, 20, 24 and
    (32, 9) (3 frames, whole and with a ragged last frame of half its rows),
    fp32 and bf16. Returns the largest absolute error of each kernel."""
    cases = []
    for mode, dtype, dil, bias in itertools.product(
            ("causal", "centered"), (torch.float32, torch.bfloat16), (1, 2, 4), (False, True)):
        cases.append((mode, dtype, (FMAP128, FMAP128), T128, TRAIN_KERNEL, dil, bias, 2))
    for mode, dtype, fmap, dil, ragged in itertools.product(
            ("causal", "centered"), (torch.float32, torch.bfloat16),
            ((12, 12), (20, 20), (24, 24), (32, 9)), (1, 2), (False, True)):
        t = 3 * fmap[0] * fmap[1] - (fmap[0] // 2 * fmap[1] if ragged else 0)
        cases.append((mode, dtype, fmap, t, TRAIN_KERNEL, dil, True, 2))
    return check_nda_cases(knda, cases, SEED + 30)


def check_determinism(knda, kcross):
    """Every output of the two backward kernels of Sparse3DNA (at the fmap-32
    training shape, dilation 2, with the bias, causal and centered) and of
    the cross (the sketch training shape, two context frames, the second
    masked in row 1) equal bit for bit across two calls on the same inputs,
    fp32 and bf16: the sums over queries are summed per block and then in
    one fixed order."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("causal", "centered"):
            args, g = nda_inputs(2, T128, dtype, True, gen, TRAIN_KERNEL)
            kw = dict(fmap=(FMAP128, FMAP128), kernel=TRAIN_KERNEL, dilation=(2, 2, 2),
                      mode=mode)
            _, lse = knda.sparse_3dna_fwd(*args, **kw)
            runs = []
            for _ in range(2):
                got = knda.sparse_3dna_bwd_q(*args, g, lse, **kw)
                runs.append(got + knda.sparse_3dna_bwd_kv(args[0], g, *got[1:3], **kw))
            torch.cuda.synchronize()
            for name, a, b in zip(BWD_NAMES, *runs):
                if not torch.equal(a, b):
                    fail(f"sparse_3dna backward {name} ({dtype}, {mode}) differs "
                         f"between two calls on the same inputs")
                checked += 1
        args = cross_inputs(2, SKETCH_TRAIN_T, 2, SKETCH_FMAP, dtype, gen)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype)
        mask = cross_masks(2, 2, SKETCH_FMAP)["one frame masked"]
        kw = dict(fmap=SKETCH_FMAP, kernel_size=3, dilation=1)
        _, lse = kcross.sparse_cross_2dna_fwd(*args, mask, **kw)
        runs = []
        for _ in range(2):
            got = kcross.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **kw)
            runs.append(got + kcross.sparse_cross_2dna_bwd_kv(args[0], g, *got[1:3], **kw))
        torch.cuda.synchronize()
        for name, a, b in zip(CROSS_BWD_NAMES, *runs):
            if not torch.equal(a, b):
                fail(f"sparse_cross_2dna backward {name} ({dtype}) differs between two "
                     f"calls on the same inputs")
            checked += 1
    print(f"determinism: {checked} backward outputs (Sparse3DNA b=2 t={T128} fmap "
          f"{FMAP128} causal and centered, the cross b=2 t={SKETCH_TRAIN_T} Lc=512; fp32 and "
          f"bf16) equal bit for bit across two calls", flush=True)


def moving_squares(b, frames, size, rng):
    """(b, frames, 3, size, size) float32 pixels in [0, 1]: on a dark noisy
    field, a square of a random colour and side moving at a random speed."""
    video = rng.uniform(0.0, 0.1, (b, frames, 3, size, size)).astype(np.float32)
    for i in range(b):
        side = int(rng.integers(size // 8, size // 3))
        y, x = rng.integers(0, size - side, 2)
        vy, vx = rng.integers(-size // 16, size // 16 + 1, 2)
        colour = rng.uniform(0.4, 1.0, 3).astype(np.float32)
        for f in range(frames):
            top = int(np.clip(y + vy * f, 0, size - side))
            left = int(np.clip(x + vx * f, 0, size - side))
            video[i, f, :, top:top + side, left:left + side] = colour[:, None, None]
    return video


def nuwa128_model(NUWA, VQGanVAE, device="cuda", dtype="bfloat16", seed=SEED, **kw):
    vae = VQGanVAE(**NUWA128_VAE, device=device, seed=seed + 40)
    return NUWA(vae=vae, **dict(NUWA128, **kw), compute_dtype=dtype, device=device, seed=seed)


def nuwa128_text(tokenizer, b):
    """The first b captions, tokenized by the port's tokenizer."""
    return torch.from_numpy(tokenizer.tokenize(list(CAPTIONS[:b]), NUWA128["text_max_seq_len"],
                                               truncate_text=True))


def serve_128(NUWA, VQGanVAE, tokenizer, knda):
    """Serving at 128 px, bf16, each request with the counts set to 0 just
    before it and read just after: forward scores b = 2 pixel videos of 10
    frames through the codec (B1 once a decoder layer); generate decodes one
    frame at b = 1 with CFG 2.0 to pixels, 1,024 cached token steps, no
    kernel. The forward runs three times, the first checked, and its
    tokens/s is the median of the three; generate (about 30 s, host-bound)
    runs once, checked and timed."""
    model = nuwa128_model(NUWA, VQGanVAE)
    text = nuwa128_text(tokenizer, 2)
    video = torch.from_numpy(moving_squares(2, NUWA128["max_video_frames"], SIZE128,
                                            np.random.default_rng(SEED + 41)))
    g = torch.Generator(device="cuda").manual_seed(SEED + 42)
    depth, tpf = NUWA128["dec_depth"], FMAP128**2
    n = NUWA128["max_video_frames"] * tpf
    requests = {
        "forward b=2, 10 frames of pixels": (
            torch.no_grad()(lambda: model(text, video)), (2, n + 1, VOCAB128), depth, 2 * n, 3),
        "generate b=1, 1 frame, pixels": (
            lambda: model.generate(text[:1], generator=g, num_frames=1),
            (1, 1, 3, SIZE128, SIZE128), 0, tpf, 1),
    }
    launches, rates = 0, {}
    for name, (call, shape, expect, tokens, reps) in requests.items():
        times = []
        for rep in range(reps):  # the first is checked, all timed
            if rep == 0:
                reset_launches(knda)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            if rep > 0:
                continue
            got = launch_counts(knda)
            if tuple(out.shape) != shape or not torch.isfinite(out).all():
                fail(f"128 px {name}: {tuple(out.shape)} not finite or not {shape}")
            if got != expect_launches(fwd=expect):
                fail(f"128 px {name}: launches {got}, expected sparse_3dna_fwd {expect}")
            launches += got["fwd"]
            print(f"128 px {name}: {tuple(out.shape)} finite, sparse_3dna_fwd launches "
                  f"{got['fwd']} (as expected)", flush=True)
        ms = statistics.median(times)
        rates[name] = tokens / (ms / 1e3)
        print(f"128 px {name}: {ms:.1f} ms per request, {rates[name]:.1f} tokens/s "
              f"(median of {reps}: {', '.join(f'{x:.1f}' for x in times)} ms)", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, rates


def nuwa128_check_model(device):
    from nuwa_tpu_torch import NUWA, VQGanVAE

    return nuwa128_model(NUWA, VQGanVAE, device=device, dtype=None, seed=SEED + 44,
                         max_video_frames=2, dec_depth=CHECK_DEPTH)


def nuwa128_side(device, text):
    """nuwa128_against_cpu's run on ``device``: the codec's ids, the forward
    logits and the greedy ids of a one-frame generate, fp32, b = 1, 2
    frames, CHECK_DEPTH."""
    video = torch.from_numpy(moving_squares(1, 2, SIZE128, np.random.default_rng(SEED + 43)))
    model = nuwa128_check_model(device)
    start = time.perf_counter()
    with torch.no_grad():
        ids = model.vae.get_video_indices(video).cpu()
        logits = model(text, video).cpu()
    thres = 1 - 0.5 / VOCAB128  # top-k keeps k = 1: greedy
    greedy = model.generate(text, num_frames=1, filter_thres=thres, decode_video=False)
    print(f"fp32 128 px encode, forward and greedy generate on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return ids, logits, greedy.cpu()


def nuwa128_against_cpu(refs, tokenizer):
    """Same weights in fp32 at b = 1 and 2 frames: the GPU path (kernels)
    against the CPU plain path (``refs``): the codec's token ids equal, the
    forward logits within LOGITS_ATOL, the greedy ids of a one-frame
    generate equal (or first apart at a tie of the CPU's top-2 logits)."""
    text = nuwa128_text(tokenizer, 1)
    (ids_gpu, lg_gpu, gr_gpu), (ids_cpu, lg_cpu, gr_cpu) = (nuwa128_side("cuda", text),
                                                            refs.result("128 px"))
    same = int((ids_gpu == ids_cpu).sum())
    print(f"fp32 128 px token ids (VAE encode) GPU vs CPU: {same} of {ids_cpu.numel()} equal",
          flush=True)
    if same != ids_cpu.numel():
        fail("128 px token ids differ between GPU and CPU")
    err = (lg_gpu - lg_cpu).abs().max().item()
    print(f"128 px forward fp32 logits GPU vs CPU: max abs err {err:.3e} "
          f"(tolerance {LOGITS_ATOL:.0e})", flush=True)
    if not err <= LOGITS_ATOL:
        fail("128 px forward logits differ between GPU and CPU")
    diff = (gr_gpu != gr_cpu).nonzero()
    if len(diff) == 0:
        print(f"greedy 128 px generate fp32 ids GPU vs CPU: all {gr_cpu.numel()} equal",
              flush=True)
        return
    p = diff[0, 1].item()
    gap = cpu_top2_gap(nuwa128_check_model("cpu"), text, gr_cpu, p, 2.0)
    print(f"greedy 128 px generate ids differ first at position {p}; CPU top-2 logit gap "
          f"there {gap:.3e} (a tie below {TIE_GAP:.0e})", flush=True)
    if not gap < TIE_GAP:
        fail("greedy 128 px generate ids differ between GPU and CPU")



def read_png(path):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG of one IDAT run and no
    scanline filter (what the port writes), every chunk's CRC checked."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        (crc,) = struct.unpack(">I", data[pos + 8 + size:pos + 12 + size])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            fail(f"{path}: bad CRC in {kind}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + size
    width, height, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, colour) != (8, 2) or b"IEND" not in chunks:
        fail(f"{path}: not an 8-bit RGB PNG")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(height, -1)
    if rows[:, 0].any():
        fail(f"{path}: a scanline filter other than none")
    return rows[:, 1:].reshape(height, width, 3)


def train_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, dropout=0.0):
    """NUWATrainer at 128 px, bf16: NUWA128_STEPS AdamW steps at batch 2 on
    one seeded batch of captions and pixel videos, the counts set to 0
    before each step and read after it (the reversible decoder: B1 12, B2 6,
    B3 6 a step, each of them a dropout launch with ``dropout``, the
    ``attn_dropout`` and ``ff_dropout`` of the model; the codec and the
    sample at step 0 none). The step-0 sample (one frame) is written as a
    PNG, which must decode to the logged frame inside the grid's 2-pixel
    border; with ``dropout`` the trainer does not sample (about 30 s of
    1,024 tokens: ``generate`` drops nothing, so the run without dropout
    checks the same path). Returns the launches of all steps and the
    step's median ms."""
    depth = NUWA128["dec_depth"]
    drop = depth if dropout else 0
    expect = expect_launches(fwd=2 * depth, bwd_q=depth, bwd_kv=depth, fwd_dropout=2 * drop,
                             bwd_q_dropout=drop, bwd_kv_dropout=drop)
    label = f"128 px train, dropout {dropout}" if dropout else "128 px train"
    results = f"{NUWA128_RESULTS}_dropout" if dropout else NUWA128_RESULTS
    model = nuwa128_model(NUWA, VQGanVAE, attn_dropout=dropout, ff_dropout=dropout)
    text = nuwa128_text(tokenizer, NUWA128_BATCH).numpy()
    video = moving_squares(NUWA128_BATCH, NUWA128["max_video_frames"], SIZE128,
                           np.random.default_rng(SEED + 45))
    trainer = NUWATrainer(
        nuwa=model, dataset=list(zip(text, video)), num_train_steps=NUWA128_STEPS, lr=3e-4,
        wd=0.01, batch_size=NUWA128_BATCH, grad_accum_every=1, max_grad_norm=0.5,
        cond_dropout_prob=0.2, save_results_every=1000, num_sampled_frames=1, seed=SEED,
        results_folder=results, tokenizer=tokenizer,
    )
    if dropout:
        trainer._sample = lambda *a: None
    if any(p.requires_grad for p in model.vae.parameters()) or any(
            p is q for p in trainer.params for q in model.vae.parameters()):
        fail("the codec's parameters are trained")
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], {k: 0 for k in expect}
    for step in range(NUWA128_STEPS):
        reset_launches(knda)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logs = trainer.train_step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(logs["loss"])
        got = launch_counts(knda)
        if got != expect:
            fail(f"{label} step {step}: launches {got}, expected {expect}")
        total = {k: total[k] + got[k] for k in total}
        if step == 0 and not dropout:
            sample, side = logs.get("sampled_video"), SIZE128
            if sample is None or sample.shape != (1, 3, side, side):
                fail(f"{label} step 0 logged no (1, 3, {side}, {side}) sample")
            png = read_png(f"{results}/0.png")
            want = (np.clip(sample[0], 0.0, 1.0) * 255).astype(np.uint8).transpose(1, 2, 0)
            if png.shape != (side + 4, side + 4, 3) or not np.array_equal(
                    png[2:side + 2, 2:side + 2], want):
                fail(f"128 px sample PNG {png.shape} does not hold the sampled frame")
            print(f"{label} step 0: sampled '{logs['sampled_text']}' to "
                  f"{results}/0.png, a {png.shape[0]} x {png.shape[1]} x 3 PNG that "
                  f"decodes to the {side} x {side} x 3 frame in a 2-pixel border", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(math.isfinite, losses)):
        fail(f"{label} losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label} loss did not fall: {losses}")
    ms = statistics.median(times[1:])  # step 0 also samples 1,024 tokens (not with dropout)
    tokens = NUWA128_BATCH * NUWA128["max_video_frames"] * FMAP128**2
    shown = {k: v for k, v in expect.items() if v}
    print(f"{label}: losses {', '.join(f'{x:.4f}' for x in losses)} (finite, falling); "
          f"launches per step {shown} (as expected, every step)", flush=True)
    print(f"{label} step (b={NUWA128_BATCH}, {tokens} video tokens): {ms:.1f} ms median "
          f"of steps 1-{NUWA128_STEPS - 1} (step 0{'' if dropout else ' with its sample'}: "
          f"{times[0]:.1f} ms), "
          f"{tokens / (ms / 1e3):.0f} video tokens/s, peak memory {peak:.2f} GiB", flush=True)
    train_device_share(trainer)
    del trainer, model
    torch.cuda.empty_cache()
    return total, ms


def train_128_side(device, text, dropout):
    """train_128_against_cpu's run on ``device``: the fp32 loss and every
    trained parameter's gradient at 2 frames, b = 1, CHECK_DEPTH; whether
    a codec parameter got a gradient."""
    from nuwa_tpu_torch import NUWA, VQGanVAE

    video = torch.from_numpy(moving_squares(1, 2, SIZE128, np.random.default_rng(SEED + 46)))
    model = nuwa128_model(NUWA, VQGanVAE, device=device, dtype=None, seed=SEED + 47,
                          max_video_frames=2, attn_dropout=dropout, ff_dropout=dropout,
                          dec_depth=CHECK_DEPTH)
    start = time.perf_counter()
    loss = model(text, video, return_loss=True, train=True, uncond=torch.tensor([False]),
                 generator=torch.Generator().manual_seed(SEED + 48))
    loss.backward()
    what = f"128 px train, dropout {dropout}," if dropout else "128 px train"
    print(f"fp32 {what} forward and backward on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    codec = any(p.grad is not None for p in model.vae.parameters())
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.requires_grad}, codec


def train_128_against_cpu(refs, tokenizer, dropout=0.0):
    """The fp32 loss and every gradient at 2 frames and b = 1 (condition
    dropout off), the GPU path (kernels) against the CPU plain path
    (``refs``); the codec's parameters have none. With ``dropout`` (the
    model's ``attn_dropout`` and ``ff_dropout``) both draw their one dropout
    seed from the same CPU generator, so they drop the same pairs."""
    what = f"128 px train, dropout {dropout}," if dropout else "128 px train"
    runs = {"cuda": train_128_side("cuda", nuwa128_text(tokenizer, 1), dropout),
            "cpu": refs.result(("128 px train", dropout))}
    for device, (_, _, codec) in runs.items():
        if codec:
            fail(f"a codec parameter has a gradient on {device}")
    (loss_gpu, g_gpu, _), (loss_cpu, g_cpu, _) = runs["cuda"], runs["cpu"]
    worst, where = 0.0, None
    for name, ref in g_cpu.items():
        rel = (g_gpu[name] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, name
    print(f"fp32 {what} GPU vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f} (tolerance "
          f"{LOSS_ATOL:.0e}); {len(g_cpu)} gradients, largest error {worst:.3e} of the "
          f"gradient's max abs at {where} (tolerance {GRAD_REL:.0e}); no codec gradient",
          flush=True)
    if not abs(loss_gpu - loss_cpu) <= LOSS_ATOL:
        fail(f"the {what} loss differs between GPU and CPU")
    if not worst <= GRAD_REL:
        fail(f"{what} gradients differ between GPU and CPU")




# ---------------------------------------------------------------------------
# NUWAVideoAudio serving (BASELINE config 5) and the audio geometry
# ---------------------------------------------------------------------------

# the flagship as scripts/bench_dual_flagship.py:50-81 writes it: 256-px
# frames through a 4-layer codec (fmap 16), 4 frames, 32 audio tokens a frame
# at 4 a timestep, a reversible decoder of depth 64, SparseCausal2DNA kernel 7
DUAL_VAE = dict(dim=16, image_size=256, num_layers=4, vq_codebook_size=1024,
                vq_codebook_dim=64, use_vgg_and_gan=False, vq_kmeans_init=False,
                use_attn=False, num_resnet_blocks=0, resnet_groups=8)
DUAL = dict(dim=512, image_size=256, num_audio_tokens=1024,
            num_audio_tokens_per_video_frame=32, audio_tokens_per_timestep=4,
            max_video_frames=4, text_num_tokens=49408, text_max_seq_len=32,
            text_enc_depth=2, text_enc_dim_head=64, text_enc_heads=8, dec_depth=64,
            dec_dim_head=64, dec_heads=8, dec_reversible=True, sparse_3dna_kernel_size=3,
            sparse_3dna_dilation=(1, 2), shift_video_tokens=True, shift_audio_tokens=True,
            cross_modality_attn_every=3)
# bench.py:308-342's for the token-by-token requests: depth 12, fmap 8 through
# a 2-layer codec on 32-px frames, one audio token a timestep
DUAL12_VAE = dict(DUAL_VAE, image_size=32, num_layers=2)
DUAL12 = dict(DUAL, image_size=32, audio_tokens_per_timestep=1, dec_depth=12)
AUDIO_KERNEL = 7  # sparse_2dna_kernel_size, the default of both configs
# the audio forward's shapes on the main path, (b, height, t): the depth-64
# forward scores 4 x 32 audio tokens at H = 4; each generate_long prefill runs
# a window of 3 x 32 audio tokens at H = 1, b = 2 under CFG
AUDIO_SHAPES = {"forward, H=4": (1, 4, 128), "generate_long prefill, H=1": (2, 1, 96)}
# the video Sparse3DNA launches beside them, (fmap, b, t): the depth-64 forward
# scores 4 frames of fmap 16, each generate_long prefill a window of 3 frames
# of fmap 8 at b = 2; kernel 3, the stack's dilations 1 and 2, the bias
DUAL_VIDEO_SHAPES = {"forward": ((16, 16), 1, 1024), "generate_long prefill": ((8, 8), 2, 192)}


def audio_kw(height, kernel=AUDIO_KERNEL, dil=1):
    """The audio geometry of SparseCausal2DNA for the kernel wrappers."""
    return dict(fmap=(1, height), kernel=(kernel, 1, height), dilation=(dil, 1, 1),
                mode="audio")


def fwd_against_plain(knda, args, kw, dtype, what):
    """The forward kernel against its plain version on ``args``: errors
    over each reference's max abs (at least 1), fp32's tolerance for lse,
    the type's for out; fails on a miss. Returns {name: (relative error,
    absolute error)}."""
    out, lse = knda.sparse_3dna_fwd(*args, **kw)
    ref, ref_lse = knda.sparse_3dna_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = {}
    for name, a, w, tol in (("out", out, ref, TOL[dtype]),
                            ("lse", lse, ref_lse, TOL[torch.float32])):
        if a.dtype != w.dtype or a.shape != w.shape:
            fail(f"{what} {name}: {a.dtype} {tuple(a.shape)} != {w.dtype} {tuple(w.shape)}")
        err = (a.float() - w.float()).abs().max().item()
        rel = err / max(1.0, w.float().abs().max().item())
        if not rel <= tol:
            fail(f"sparse_3dna_fwd {what} {name}: error {rel} of the max abs > {tol}")
        errs[name] = rel, err
    return errs


def check_audio(knda):
    """The forward kernel in the audio geometry against its plain version:
    heights 1, 4, 5, 9 and 32, kernels 7 and 5, dilations 1 and 2, 12 whole
    timesteps or a ragged last one (half its tokens), the bias on and off,
    fp32 and bf16, b = 2, 8 heads of 64. Errors over each reference's max abs
    (at least 1): fp32's tolerance for every fp32 output, bf16's for out in
    bf16. Returns the largest absolute error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    worst, worst_abs, count = {}, 0.0, 0
    for dtype, height, kernel, dil, ragged, bias in itertools.product(
            (torch.float32, torch.bfloat16), (1, 4, 5, 9, 32), (7, 5), (1, 2), (False, True),
            (False, True)):
        if ragged and height == 1:
            continue
        t = 12 * height - (height // 2 if ragged else 0)
        args, _ = nda_inputs(2, t, dtype, bias, gen, (kernel, 1, height))
        errs = fwd_against_plain(knda, args, audio_kw(height, kernel, dil), dtype,
                                 f"audio H={height} K={kernel} dil={dil} t={t} bias={bias} "
                                 f"{dtype}")
        count += 1
        for name, (rel, err) in errs.items():
            tol = TOL[dtype if name == "out" else torch.float32]
            key = (str(dtype), name, tol)
            worst[key] = max(worst.get(key, 0.0), rel)
            worst_abs = max(worst_abs, err)
    for (dtype, name, tol), rel in sorted(worst.items()):
        print(f"sparse_3dna_fwd audio geometry {name} vs plain, {dtype}: max error "
              f"{rel:.3e} of the reference's max abs (tolerance {tol:.0e}; {count} cases "
              f"over both types: H 1, 4, 5, 9, 32, K 7 and 5, dilations 1 and 2, ragged "
              f"last timesteps, bias on and off)", flush=True)
    return worst_abs


def check_dual_video(knda):
    """The three Sparse3DNA kernels at the dual decoder's video launches
    (DUAL_VIDEO_SHAPES), fp32 and bf16, against their plain versions.
    Returns the largest absolute error of each kernel."""
    cases = [("causal", dtype, fmap, t, (3, 3, 3), dil, True, b)
             for fmap, b, t in DUAL_VIDEO_SHAPES.values()
             for dtype in (torch.float32, torch.bfloat16) for dil in (1, 2)]
    return check_nda_cases(knda, cases, SEED + 53)


def time_audio(knda):
    """The audio forward at the main path's shapes (AUDIO_SHAPES): bf16, 8
    heads of 64, kernel 7, dilation 1, the rel-pos bias (both configs'),
    held against the plain version on the same inputs (out to bf16's
    tolerance, lse to fp32's), then timed beside it and the bound of its
    valid pairs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    rows = {}
    for name, (b, height, t) in AUDIO_SHAPES.items():
        kw = audio_kw(height)
        args, _ = nda_inputs(b, t, torch.bfloat16, True, gen, kw["kernel"])
        errs = fwd_against_plain(knda, args, kw, torch.bfloat16, f"audio ({name}) b={b} t={t}")
        print(f"sparse_3dna_fwd audio geometry ({name}) bf16 b={b} t={t} vs plain: out "
              f"{errs['out'][0]:.3e}, lse {errs['lse'][0]:.3e} of the max abs (tolerances "
              f"{TOL[torch.bfloat16]:.0e}, {TOL[torch.float32]:.0e})", flush=True)
        ms = device_ms(lambda: knda.sparse_3dna_fwd(*args, **kw))
        plain = device_ms(lambda: knda.sparse_3dna_fwd_plain(*args, **kw), iters=5)
        bound, by = nda_bounds(knda, b, t, kw["dilation"], torch.bfloat16, True, kw["fmap"],
                               kw["kernel"], "audio")["fwd"]
        rows[name] = dict(b=b, height=height, t=t, ms=ms, plain_ms=plain, bound_ms=bound,
                          bound_by=by, max_abs_err=max(e for _, e in errs.values()))
        print(f"sparse_3dna_fwd audio geometry ({name}) bf16 b={b} t={t} kernel "
              f"({AUDIO_KERNEL}, 1, {height}): kernel {ms:.4f} ms (device), plain "
              f"{plain:.4f} ms, bound {bound:.5f} ms ({by}), kernel / bound "
              f"{ms / bound:.1f}x; {tiles_text(knda, args[0], kw, ('fwd',))}", flush=True)
    return rows


def dual_model(NUWAVideoAudio, VQGanVAE, cfg, vae_cfg, device="cuda", dtype="bfloat16",
               seed=SEED, **kw):
    vae = VQGanVAE(**vae_cfg, device=device, seed=seed + 60)
    return NUWAVideoAudio(vae=vae, **dict(cfg, **kw), compute_dtype=dtype, device=device,
                          seed=seed)


def timed(call):
    """(result, ms) of one call, CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = call()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_request(name, knda, call, expect, checks):
    """Run one request with the counts set to 0 just before it and read just
    after; ``checks``: (what, tensor, shape, upper bound of its ids or None
    for finite values). Returns (output, ms, launch counts read)."""
    reset_launches(knda)
    out, ms = timed(call)
    got = launch_counts(knda)
    checked = checks(out)
    for what, x, shape, high in checked:
        if tuple(x.shape) != shape:
            fail(f"{name}: {what} {tuple(x.shape)} != {shape}")
        ok = torch.isfinite(x).all() if high is None else (x.min() >= 0) & (x.max() < high)
        if not ok:
            fail(f"{name}: {what} not finite or out of range")
    if got != expect:
        fail(f"{name}: launches {got}, expected {expect}")
    print(f"{name}: {', '.join(f'{w} {tuple(x.shape)}' for w, x, _, _ in checked)} ok, "
          f"sparse_3dna_fwd launches {got['fwd']} of which audio {got['fwd_audio']} "
          f"(as expected)", flush=True)
    return out, ms, got


def serve_dual(NUWAVideoAudio, VQGanVAE, knda):
    """BASELINE config 5, bf16, b = 1. The depth-64 flagship scores 256-px
    pixels through the codec (forward: 64 video and 64 audio launches of the
    forward kernel), three times, the first checked, then its busy share;
    the depth-12 config of
    bench.py samples 4 frames with cached generate (no launch) and 6 frames
    with generate_long (two prefills of 12 + 12 launches), both with CFG 2.0
    and decoded to pixels, then the device's busy share of a one-frame
    generate. Returns the launches and the rates."""
    gen_cpu = torch.Generator().manual_seed(SEED + 61)
    text = request_text(1, gen_cpu)
    model = dual_model(NUWAVideoAudio, VQGanVAE, DUAL, DUAL_VAE)
    frames, size = DUAL["max_video_frames"], DUAL["image_size"]
    atpf, vocab = DUAL["num_audio_tokens_per_video_frame"], DUAL["num_audio_tokens"]
    nv, na = frames * model.tokens_per_frame, frames * atpf
    video = torch.from_numpy(moving_squares(1, frames, size, np.random.default_rng(SEED + 62)))
    audio = torch.randint(0, vocab, (1, na), generator=gen_cpu)
    depth = DUAL["dec_depth"]
    torch.cuda.reset_peak_memory_stats()
    call = torch.no_grad()(lambda: model(text, video, audio))
    _, first, got = check_request(
        f"dual forward b=1, {size} px, depth {depth}", knda, call,
        expect_launches(fwd=2 * depth, fwd_audio=depth),
        lambda out: (("video logits", out[0], (1, nv + 1, 1024), None),
                     ("audio logits", out[1], (1, na + 1, vocab), None)))
    times = [first] + [timed(call)[1] for _ in range(2)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times)
    rates = {"forward": (nv + na) / (ms / 1e3)}
    launches = {k: got[k] for k in ("fwd", "fwd_audio")}
    print(f"dual forward b=1 depth {depth}: {ms:.1f} ms per request (median of "
          f"{', '.join(f'{x:.1f}' for x in times)}), {rates['forward']:.0f} tokens/s "
          f"({nv} video + {na} audio), peak memory {peak:.2f} GiB", flush=True)
    share(call, f"dual forward b=1, depth {depth}", wall=ms)
    del model, call
    torch.cuda.empty_cache()

    model = dual_model(NUWAVideoAudio, VQGanVAE, DUAL12, DUAL12_VAE)
    g = torch.Generator(device="cuda").manual_seed(SEED + 63)
    depth, size = DUAL12["dec_depth"], DUAL12["image_size"]
    per_frame = model.tokens_per_frame + atpf
    for name, frames, call, expect in (
        ("dual generate b=1, 4 frames, pixels", 4,
         lambda: model.generate(text, generator=g), expect_launches()),
        # one prefill of both towers per frame past the window
        ("dual generate_long b=1, 6 frames, pixels", 6,
         lambda: model.generate_long(text, num_frames=6, generator=g),
         expect_launches(fwd=2 * 2 * depth, fwd_audio=2 * depth)),
    ):
        _, ms, got = check_request(
            name, knda, call, expect,
            lambda out, f=frames: (("video", out[0], (1, f, 3, size, size), None),
                                   ("audio ids", out[1], (1, f * atpf), vocab)))
        rates[name] = frames * per_frame / (ms / 1e3)
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"{name}: {ms:.1f} ms, {rates[name]:.1f} tokens/s ({frames * per_frame} "
              f"tokens, one cached step each)", flush=True)
    one = lambda: model.generate(text, generator=g, num_frames=1)  # noqa: E731
    share(one, f"dual generate b=1, 1 frame ({per_frame} token steps)", wall=timed(one)[1])
    del model
    torch.cuda.empty_cache()
    return launches, rates


def dual_side(device):
    """dual_against_cpu's run on ``device``: the codec's ids, both logits,
    the loss and the greedy ids of a 2-frame cached generate (CFG 2.0), and
    on the CPU the top-2 logit gap at every sample."""
    import nuwa_tpu_torch.models.nuwa_video_audio as va
    from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE

    cfg = dict(DUAL, dec_depth=2, max_video_frames=2, cross_modality_attn_every=2)
    gen = torch.Generator().manual_seed(SEED + 64)
    text = request_text(1, gen)
    video = torch.from_numpy(moving_squares(1, 2, DUAL["image_size"],
                                            np.random.default_rng(SEED + 65)))
    audio = torch.randint(0, DUAL["num_audio_tokens"], (1, 64), generator=gen)
    thres = 1 - 0.5 / 1024  # top-k keeps k = 1 of both vocabularies: greedy
    gaps = []
    filter_ = va.top_k_filter

    def recording(logits, thres):  # the CPU rollout's top-2 gap at every sample
        top = logits.float().topk(2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).min().item())
        return filter_(logits, thres)

    model = dual_model(NUWAVideoAudio, VQGanVAE, cfg, DUAL_VAE, device=device, dtype=None,
                       seed=SEED + 66)
    start = time.perf_counter()
    with torch.no_grad():
        ids = model.vae.get_video_indices(video).cpu()
        logits = [x.cpu() for x in model(text, video, audio)]
        loss = model(text, video, audio, return_loss=True).item()
    va.top_k_filter = recording if device == "cpu" else filter_
    try:
        sampled = [x.cpu() for x in model.generate(text, num_frames=2, filter_thres=thres,
                                                   decode_video=False)]
    finally:
        va.top_k_filter = filter_
    print(f"dual fp32 forward, loss and 2-frame greedy generate on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return ids, logits, loss, sampled, gaps


def dual_against_cpu(refs):
    """The flagship's widths and codec in fp32 at depth 2, 2 frames, H = 4,
    cross-modality attention every 2 depths (so the depth-2 stack holds one
    xmod block), the same weights on the GPU (kernels) and the CPU (plain
    path, ``refs``): codec ids equal, video and audio logits within
    LOGITS_ATOL of their max abs, the loss within LOSS_ATOL, and the greedy
    ids of cached generate (CFG 2.0) equal, video and audio (or first apart
    at a tie of the CPU's top-2 logits, by sampling order)."""
    (ids_g, logits_g, loss_g, samp_g, _), (ids_c, logits_c, loss_c, samp_c, gaps) = (
        dual_side("cuda"), refs.result("dual"))
    if not torch.equal(ids_g, ids_c):
        fail(f"dual codec ids differ between GPU and CPU: {(ids_g != ids_c).sum().item()}")
    for what, a, b in zip(("video", "audio"), logits_g, logits_c):
        rel = (a - b).abs().max().item() / b.abs().max().item()
        print(f"dual fp32 {what} logits GPU vs CPU: max error {rel:.3e} of the max abs "
              f"(tolerance {LOGITS_ATOL:.0e})", flush=True)
        if not rel <= LOGITS_ATOL:
            fail(f"dual {what} logits differ between GPU and CPU")
    print(f"dual fp32 loss GPU vs CPU: {loss_g:.6f} vs {loss_c:.6f} (tolerance "
          f"{LOSS_ATOL:.0e})", flush=True)
    if not abs(loss_g - loss_c) <= LOSS_ATOL:
        fail("the dual loss differs between GPU and CPU")
    vtpf = (DUAL["image_size"] // 2 ** DUAL_VAE["num_layers"]) ** 2
    atpf = DUAL["num_audio_tokens_per_video_frame"]
    order = []  # sampling index of the first difference in each modality
    for a, b, n, offset in ((samp_g[0], samp_c[0], vtpf, 0), (samp_g[1], samp_c[1], atpf, vtpf)):
        diff = (a != b).nonzero()
        if len(diff):
            p = diff[0, 1].item()
            order.append((p // n) * (vtpf + atpf) + offset + p % n)
    if not order:
        print(f"dual greedy generate fp32 ids GPU vs CPU: all {samp_c[0].numel()} video and "
              f"{samp_c[1].numel()} audio ids equal", flush=True)
        return
    first = min(order)
    print(f"dual greedy ids differ first at sample {first}; CPU top-2 logit gap there "
          f"{gaps[first]:.3e} (a tie below {TIE_GAP:.0e})", flush=True)
    if not gaps[first] < TIE_GAP:
        fail("dual greedy generate ids differ between GPU and CPU")



# ---------------------------------------------------------------------------
# NUWAVideoAudio training: the backward kernels in the audio geometry, and
# BASELINE config 5's train step
# ---------------------------------------------------------------------------

# the audio backward's shapes on the main path, (b, height, t): the depth-64
# train step scores 4 x 32 audio tokens less the last at H = 4; and at H = 1
# a window of 3 x 32 less one at b = 2
AUDIO_BWD_SHAPES = {"train step, H=4": (1, 4, 127), "H=1": (2, 1, 95)}
DUAL_TRAIN_STEPS = 4


def audio_bwd_against_plain(knda, args, g, kw, dtype, what):
    """The query-side and key-side kernels against their plain versions on
    ``args`` and the cotangent ``g`` (each backward given the plain
    forward's lse, the key side the plain query side's dS and mix), and
    every output of two calls of each kernel equal bit for bit. Errors over
    each reference's max abs (at least 1): the type's tolerance for the
    outputs in q's dtype, fp32's for the fp32 ones. Fails on a miss;
    returns {(kernel, rounded): (relative error, absolute error)}."""
    _, lse = knda.sparse_3dna_fwd_plain(*args, **kw)
    want = knda.sparse_3dna_bwd_q_plain(*args, g, lse, **kw)
    want += knda.sparse_3dna_bwd_kv_plain(args[0], g, *want[1:3], **kw)
    runs = []
    for _ in range(2):
        got = knda.sparse_3dna_bwd_q(*args, g, lse, **kw)
        runs.append(got + knda.sparse_3dna_bwd_kv(args[0], g, *want[1:3], **kw))
    torch.cuda.synchronize()
    errs = {}
    for name, a, a2, w in zip(BWD_NAMES, *runs, want):
        if w is None:
            if a is not None:
                fail(f"{what} {name}: None expected without a bias")
            continue
        if a.dtype != w.dtype or a.shape != w.shape:
            fail(f"{what} {name}: {a.dtype} {tuple(a.shape)} != {w.dtype} {tuple(w.shape)}")
        if not torch.equal(a, a2):
            fail(f"{what} {name}: two calls differ")
        err = (a.float() - w.float()).abs().max().item()
        rel = err / max(1.0, w.float().abs().max().item())
        rounded = name in ROUNDED
        tol = TOL[dtype if rounded else torch.float32]
        if not rel <= tol:
            fail(f"sparse_3dna backward {what} {name}: error {rel} of the max abs > {tol}")
        key = ("bwd_kv" if name in ("dk", "dv") else "bwd_q", rounded)
        old = errs.get(key, (0.0, 0.0))
        errs[key] = max(old[0], rel), max(old[1], err)
    return errs


def check_audio_bwd(knda):
    """The backward kernels in the audio geometry against their plain
    versions over check_audio's 144 cases (heights 1, 4, 5, 9 and 32,
    kernels 7 and 5, dilations 1 and 2, whole or ragged last timesteps, the
    bias on and off, fp32 and bf16, b = 2, 8 heads of 64), every output
    equal bit for bit across two calls. Returns the largest absolute error
    of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    worst, worst_abs, count = {}, {}, 0
    for dtype, height, kernel, dil, ragged, bias in itertools.product(
            (torch.float32, torch.bfloat16), (1, 4, 5, 9, 32), (7, 5), (1, 2), (False, True),
            (False, True)):
        if ragged and height == 1:
            continue
        t = 12 * height - (height // 2 if ragged else 0)
        args, g = nda_inputs(2, t, dtype, bias, gen, (kernel, 1, height))
        errs = audio_bwd_against_plain(
            knda, args, g, audio_kw(height, kernel, dil), dtype,
            f"audio H={height} K={kernel} dil={dil} t={t} bias={bias} {dtype}")
        count += 1
        for (kname, rounded), (rel, err) in errs.items():
            key = (str(dtype), kname, rounded)
            worst[key] = max(worst.get(key, 0.0), rel)
            worst_abs[kname] = max(worst_abs.get(kname, 0.0), err)
    for (dtype, kname, rounded), rel in sorted(worst.items()):
        tol = TOL[getattr(torch, dtype.split(".")[1]) if rounded else torch.float32]
        which = f"outputs in {dtype}" if rounded else "fp32 outputs"
        print(f"sparse_3dna_{kname} audio geometry vs plain, {dtype} inputs, {which}: max "
              f"error {rel:.3e} of the reference's max abs (tolerance {tol:.0e}; {count} "
              f"cases over both types: H 1, 4, 5, 9, 32, K 7 and 5, dilations 1 and 2, "
              f"ragged last timesteps, bias on and off; two calls equal bit for bit)",
              flush=True)
    return worst_abs


def check_audio_autograd(knda):
    """The autograd function in the audio geometry (forward and backward
    kernels) against torch.autograd of the plain forward, fp32, at the
    shapes of AUDIO_BWD_SHAPES with the bias: every input's gradient within
    1e-5 of its max abs (at least 1)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    worst = 0.0
    for b, height, t in AUDIO_BWD_SHAPES.values():
        kw = audio_kw(height)
        args, g = nda_inputs(b, t, torch.float32, True, gen, kw["kernel"])
        args = [x.detach().requires_grad_() for x in args]
        out, _ = knda.sparse_3dna_fwd_plain(*args, **kw)
        want = torch.autograd.grad(out, args, g)
        got = torch.autograd.grad(knda.sparse_3dna(*args, **kw), args, g)
        for name, a, w in zip(("q", "k", "v", "k_bos", "v_bos", "talking_heads", "rel_bias"),
                              got, want):
            rel = (a - w).abs().max().item() / max(1.0, w.abs().max().item())
            if not rel <= 1e-5:
                fail(f"sparse_3dna autograd, audio H={height}: d{name} error {rel} > 1e-5")
            worst = max(worst, rel)
    print(f"sparse_3dna autograd function vs autograd of the plain forward, audio geometry, "
          f"fp32, {', '.join(f'b={b} H={h} t={t}' for b, h, t in AUDIO_BWD_SHAPES.values())}: "
          f"max error {worst:.3e} of the max abs (tolerance 1e-5)", flush=True)


def time_audio_bwd(knda):
    """The two backward kernels in the audio geometry at AUDIO_BWD_SHAPES:
    bf16, 8 heads of 64, kernel 7, dilation 1, the rel-pos bias; held
    against their plain versions on the same inputs, then timed beside them
    and the bounds of their valid pairs (and of the backward as one
    function)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    rows = {}
    for name, (b, height, t) in AUDIO_BWD_SHAPES.items():
        kw, dtype = audio_kw(height), torch.bfloat16
        args, g = nda_inputs(b, t, dtype, True, gen, kw["kernel"])
        errs = audio_bwd_against_plain(knda, args, g, kw, dtype, f"audio ({name}) b={b} t={t}")
        _, lse = knda.sparse_3dna_fwd(*args, **kw)
        _, ds, mix, *_ = knda.sparse_3dna_bwd_q(*args, g, lse, **kw)
        bounds = nda_bounds(knda, b, t, kw["dilation"], dtype, True, kw["fmap"], kw["kernel"],
                            "audio")
        print(f"audio geometry ({name}) b={b} t={t}: "
              f"{tiles_text(knda, args[0], kw, ('bwd_q', 'bwd_kv'))}", flush=True)
        for kname, kernel, plain in (
            ("bwd_q", lambda: knda.sparse_3dna_bwd_q(*args, g, lse, **kw),
             lambda: knda.sparse_3dna_bwd_q_plain(*args, g, lse, **kw)),
            ("bwd_kv", lambda: knda.sparse_3dna_bwd_kv(args[0], g, ds, mix, **kw),
             lambda: knda.sparse_3dna_bwd_kv_plain(args[0], g, ds, mix, **kw)),
        ):
            ms, plain_ms = device_ms(kernel), device_ms(plain, iters=5)
            bound, by = bounds[kname]
            err = max(e for (k, _), (_, e) in errs.items() if k == kname)
            rows[kname, name] = dict(b=b, height=height, t=t, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound, bound_by=by, max_abs_err=err,
                                     backward_bound_ms=bounds["bwd"][0])
            print(f"sparse_3dna_{kname} audio geometry ({name}) bf16 b={b} t={t} kernel "
                  f"({AUDIO_KERNEL}, 1, {height}): kernel {ms:.4f} ms (device), plain "
                  f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}), kernel / bound "
                  f"{ms / bound:.1f}x; max abs error vs plain {err:.3e}", flush=True)
        both = rows["bwd_q", name]["ms"] + rows["bwd_kv", name]["ms"]
        print(f"sparse_3dna backward (bwd_q + bwd_kv) audio geometry ({name}): {both:.4f} ms, "
              f"bound of the whole backward {bounds['bwd'][0]:.6f} ms ({bounds['bwd'][1]})",
              flush=True)
    return rows


def dual_train_step(model, opt, params, batch, gen):
    """One train step as scripts/bench_dual_flagship.py:104-113 jits it:
    the loss with condition dropout (0.2, drawn from ``gen``), its backward,
    the global-norm clip (0.5) and the AdamW step. Returns the loss."""
    from nuwa_tpu_torch.train import clip_by_global_norm_

    opt.zero_grad(set_to_none=True)
    loss = model(*batch, return_loss=True, train=True, generator=gen)
    loss.backward()
    clip_by_global_norm_(params, 0.5)
    opt.step()
    return loss.detach()


def train_dual(NUWAVideoAudio, VQGanVAE, knda, dropout=0.0):
    """BASELINE config 5 at full width and depth (DUAL: depth 64), bf16,
    b = 1, seeded token ids (1,024 video, 128 audio), AdamW (lr 3e-4, weight
    decay 0.01) after the clip: DUAL_TRAIN_STEPS steps with the counts set
    to 0 before each and read after. Per step the reversible decoder runs
    each self quad's video Sparse3DNA and audio SparseCausal2DNA once in the
    forward (under no grad) and again in the backward's recompute, then
    their backward: B1 4 x depth (2 x depth audio), B2 and B3 2 x depth
    (depth audio); the text encoder and the cross and inter-modality blocks
    launch none. With ``dropout`` (the model's ``attn_dropout`` and
    ``ff_dropout``) every launch is a dropout one. Returns the launches of
    all steps and the step's rates."""
    from nuwa_tpu_torch.train import get_optimizer

    depth = DUAL["dec_depth"]
    drop = 2 * depth if dropout else 0
    expect = expect_launches(fwd=4 * depth, fwd_audio=2 * depth, bwd_q=2 * depth,
                             bwd_q_audio=depth, bwd_kv=2 * depth, bwd_kv_audio=depth,
                             fwd_dropout=2 * drop, bwd_q_dropout=drop, bwd_kv_dropout=drop)
    label = f"dual train, dropout {dropout}" if dropout else "dual train"
    gen_cpu = torch.Generator().manual_seed(SEED + 73)
    text = request_text(1, gen_cpu)
    frames, atpf = DUAL["max_video_frames"], DUAL["num_audio_tokens_per_video_frame"]
    torch.cuda.reset_peak_memory_stats()
    model = dual_model(NUWAVideoAudio, VQGanVAE, DUAL, DUAL_VAE, seed=SEED + 74,
                       attn_dropout=dropout, ff_dropout=dropout)
    nv, na = frames * model.tokens_per_frame, frames * atpf
    batch = (text, torch.randint(0, DUAL_VAE["vq_codebook_size"], (1, nv), generator=gen_cpu),
             torch.randint(0, DUAL["num_audio_tokens"], (1, na), generator=gen_cpu))
    params = [p for p in model.parameters() if p.requires_grad]
    opt = get_optimizer(params, lr=3e-4, wd=0.01)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 75)
    losses, times, total = [], [], {k: 0 for k in expect}
    for step in range(DUAL_TRAIN_STEPS):
        reset_launches(knda)
        loss, ms = timed(lambda: dual_train_step(model, opt, params, batch, gen))
        got = launch_counts(knda)
        if got != expect:
            fail(f"{label} step {step}: launches {got}, expected {expect}")
        total = {k: total[k] + got[k] for k in total}
        losses.append(loss.item())
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(math.isfinite, losses)):
        fail(f"{label} losses not finite: {losses}")
    ms = statistics.median(times[1:])
    rate = (nv + na) / (ms / 1e3)
    n_params = sum(p.numel() for p in params)
    print(f"{label}: losses {', '.join(f'{x:.4f}' for x in losses)} (finite)", flush=True)
    print(f"{label}: launches per step read {got} (as expected, every step: B1 "
          f"{4 * depth}, {2 * depth} audio; B2 and B3 {2 * depth}, {depth} audio; "
          f"dropout ones B1 {2 * drop}, B2 and B3 {drop})", flush=True)
    print(f"{label} step (BASELINE config 5, depth {depth}, {n_params / 1e6:.1f} M trained "
          f"parameters, b=1, {nv} video + {na} audio tokens): {ms:.1f} ms median of steps "
          f"1-{DUAL_TRAIN_STEPS - 1} (step 0: {times[0]:.1f} ms), {rate:.0f} tokens/s, peak "
          f"memory {peak:.2f} GiB", flush=True)
    share(lambda: dual_train_step(model, opt, params, batch, gen),
          f"{label} step, depth {depth}", wall=ms)
    del model, opt, params
    torch.cuda.empty_cache()
    return total, dict(ms=ms, tokens_per_s=rate, peak_gib=peak)


def dual_train_model(device, dropout):
    from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE

    cfg = dict(DUAL, dec_depth=2, max_video_frames=2, cross_modality_attn_every=2)
    return dual_model(NUWAVideoAudio, VQGanVAE, cfg, DUAL_VAE, device=device, dtype=None,
                      seed=SEED + 77, attn_dropout=dropout, ff_dropout=dropout)


def dual_train_side(device, dropout, reference=False):
    """dual_train_against_cpu's run on ``device``: the fp32 loss and every
    trained parameter's gradient. Returns (the model, its loss, its
    gradients, None); the ``reference`` run (the CPU's) returns no model
    and, without dropout, the parameters after one clip-and-AdamW step from
    its gradients in place of None."""
    from nuwa_tpu_torch.train import clip_by_global_norm_, get_optimizer

    gen = torch.Generator().manual_seed(SEED + 76)
    text = torch.cat([request_text(1, gen), request_text(1, gen)])
    nv = 2 * (DUAL["image_size"] // 2 ** DUAL_VAE["num_layers"]) ** 2
    video = torch.randint(0, DUAL_VAE["vq_codebook_size"], (2, nv), generator=gen)
    audio = torch.randint(0, DUAL["num_audio_tokens"], (2, 64), generator=gen)
    model = dual_train_model(device, dropout)
    start = time.perf_counter()
    loss = model(text, video, audio, return_loss=True, train=True,
                 uncond=torch.tensor([False, True]),
                 generator=torch.Generator().manual_seed(SEED + 78))
    loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.requires_grad}
    print(f"dual fp32 train{f', dropout {dropout},' if dropout else ''} forward and "
          f"backward on {device}: {time.perf_counter() - start:.1f} s", flush=True)
    if not reference:
        return model, loss.item(), grads, None
    after = None
    if not dropout:  # the step from the reference's own gradients
        params = [p for p in model.parameters() if p.requires_grad]
        for name, p in model.named_parameters():
            if p.requires_grad:  # a copy: the clip scales it in place
                p.grad = grads[name].clone()
        clip_by_global_norm_(params, 0.5)
        get_optimizer(params, lr=3e-4, wd=0.01).step()
        after = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    return None, loss.item(), grads, after


def dual_train_against_cpu(refs, dropout=0.0):
    """The flagship's widths and codec in fp32 at depth 2, 2 frames, H = 4,
    cross-modality attention every 2 depths (one xmod block), b = 2 with a
    fixed condition-dropout mask (row 1 unconditional), the same weights on
    the GPU (kernels) and the CPU (plain path, ``refs``): the loss within
    LOSS_ATOL, every parameter's gradient within GRAD_REL of its max abs;
    then one clip-and-AdamW step (lr 3e-4, weight decay 0.01) on each, both
    fed the CPU's gradients (Adam's first step is sign-like and would
    magnify the gradients' rounding where they are near 0): every parameter
    within 1e-5 of its max abs. With ``dropout`` (the model's
    ``attn_dropout`` and ``ff_dropout``) both draw their one dropout seed
    from the same CPU generator, so they drop the same pairs, and the step
    is not repeated."""
    from nuwa_tpu_torch.train import clip_by_global_norm_, get_optimizer

    (gpu, loss_gpu, g_gpu, _), (_, loss_cpu, g_cpu, after) = (
        dual_train_side("cuda", dropout), refs.result(("dual train", dropout)))
    worst, where = 0.0, None
    for name, ref in g_cpu.items():
        rel = (g_gpu[name] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, name
    print(f"dual fp32 train{f', dropout {dropout},' if dropout else ''} GPU vs CPU: loss "
          f"{loss_gpu:.6f} vs {loss_cpu:.6f} (tolerance {LOSS_ATOL:.0e}); {len(g_cpu)} "
          f"gradients, largest error {worst:.3e} of the gradient's max abs at {where} "
          f"(tolerance {GRAD_REL:.0e})", flush=True)
    if not abs(loss_gpu - loss_cpu) <= LOSS_ATOL:
        fail("the dual training loss differs between GPU and CPU")
    if not worst <= GRAD_REL:
        fail("dual training gradients differ between GPU and CPU")
    if dropout:
        return
    params = [p for p in gpu.parameters() if p.requires_grad]
    for (name, p) in ((n, p) for n, p in gpu.named_parameters() if p.requires_grad):
        p.grad = g_cpu[name].to(p.device).clone()
    clip_by_global_norm_(params, 0.5)
    get_optimizer(params, lr=3e-4, wd=0.01).step()
    worst, where = 0.0, None
    for name, p in gpu.named_parameters():
        if p.requires_grad:
            ref = after[name]
            rel = (p.detach().cpu() - ref).abs().max().item() / max(ref.abs().max().item(),
                                                                    1e-30)
            if rel > worst:
                worst, where = rel, name
    print(f"dual fp32 clip-and-AdamW step GPU vs CPU, same gradients: largest parameter "
          f"error {worst:.3e} of its max abs at {where} (tolerance 1e-05)", flush=True)
    if not worst <= 1e-5:
        fail("the dual AdamW step differs between GPU and CPU")



# ---------------------------------------------------------------------------
# attention and feed-forward dropout
# ---------------------------------------------------------------------------

DROP_RATE, DROP_SEED = 0.1, 1234567
# the main path's shapes of the three kernels, (b, t, geometry, bias): the
# fmap-16 training shape (dilation 2), the centered sketch encoder's
# (dilation 1, no bias), the fmap-32 training shape and the config-5 train
# step's audio at H = 4, with H = 1 beside it
DROPOUT_SHAPES = {
    "causal, fmap 16": (TRAIN_BATCH, TRAIN_T, dict(fmap=TRAIN_FMAP, kernel=TRAIN_KERNEL,
                                                  dilation=(2, 2, 2), mode="causal"), True),
    "centered": (TRAIN_BATCH, 2 * SKETCH_FMAP**2 - 1,
                 dict(fmap=(SKETCH_FMAP,) * 2, kernel=TRAIN_KERNEL, dilation=(1, 1, 1),
                      mode="centered"), False),
    "fmap 32": (TRAIN_BATCH, T128, dict(fmap=(FMAP128,) * 2, kernel=TRAIN_KERNEL,
                                        dilation=(2, 2, 2), mode="causal"), True),
    "audio, H=4": (1, 127, audio_kw(4), True),
    "audio, H=1": (2, 95, audio_kw(1), True),
}


def dropout_rows(knda, cross=True):
    """The three kernels with attention dropout at DROP_RATE and a seed, at
    each shape of DROPOUT_SHAPES, fp32 and bf16: against their plain versions
    on the same inputs (the same counter-hash mask; errors over each
    reference's max abs, the type's tolerance for outputs in q's dtype and
    fp32's for the fp32 ones), every backward output equal bit for bit
    across two calls, and the dropped share of the valid pairs' mixed
    probabilities; then, in bf16, each kernel's device time with and
    without dropout beside its plain version's with dropout; then the same
    for the three cross kernels (``cross_dropout_rows``) where ``cross``.
    Returns {(kernel, shape): row}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    rows = {}
    drop = (DROP_RATE, DROP_SEED)
    for name, (b, t, kw, bias) in DROPOUT_SHAPES.items():
        dkw = dict(kw, dropout=drop)
        for dtype in (torch.float32, torch.bfloat16):
            args, g = nda_inputs(b, t, dtype, bias, gen, kw["kernel"])
            out, lse = knda.sparse_3dna_fwd(*args, **dkw)
            ref, ref_lse = knda.sparse_3dna_fwd_plain(*args, **dkw)
            want = knda.sparse_3dna_bwd_q_plain(*args, g, ref_lse, **dkw)
            want += knda.sparse_3dna_bwd_kv_plain(args[0], g, *want[1:3], **dkw)
            runs = []
            for _ in range(2):
                got = knda.sparse_3dna_bwd_q(*args, g, ref_lse, **dkw)
                runs.append(got + knda.sparse_3dna_bwd_kv(args[0], g, *want[1:3], **dkw))
            torch.cuda.synchronize()
            errs = {}
            for oname, a, a2, w in zip(("out", "lse", *BWD_NAMES), (out, lse, *runs[0]),
                                       (out, lse, *runs[1]), (ref, ref_lse, *want)):
                if w is None:
                    continue
                if a.dtype != w.dtype or a.shape != w.shape:
                    fail(f"dropout {name} {oname}: {a.dtype} {tuple(a.shape)} != "
                         f"{w.dtype} {tuple(w.shape)}")
                if not torch.equal(a, a2):
                    fail(f"dropout {name} {oname} {dtype}: two calls differ")
                err = (a.float() - w.float()).abs().max().item()
                rel = err / max(1.0, w.float().abs().max().item())
                tol = TOL[dtype if oname in ROUNDED else torch.float32]
                if not rel <= tol:
                    fail(f"dropout {name} {oname} {dtype}: error {rel} of the max abs > {tol}")
                kname = ("fwd" if oname in ("out", "lse") else
                         "bwd_kv" if oname in ("dk", "dv") else "bwd_q")
                old = errs.get(kname, (0.0, 0.0))
                errs[kname] = max(old[0], rel), max(old[1], err)
            # the share of the valid pairs' mixed probabilities dropped
            nodrop_mix = knda.sparse_3dna_bwd_q(*args, g, ref_lse, **kw)[2]
            valid = nodrop_mix != 0
            share = ((runs[0][2] == 0) & valid).sum().item() / valid.sum().item()
            n = valid.sum().item()
            if not abs(share - DROP_RATE) <= 4 * (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5:
                fail(f"dropout {name} {dtype}: dropped share {share} of {n} pairs is more "
                     f"than 4 binomial standard deviations from the rate {DROP_RATE}")
            print(f"dropout {DROP_RATE} {name} b={b} t={t} {dtype} vs plain: "
                  + ", ".join(f"sparse_3dna_{k} max error {rel:.3e} of the max abs"
                              for k, (rel, _) in errs.items())
                  + f" (tolerances {TOL[dtype]:.0e} for outputs in {dtype}, 1e-05 for fp32 "
                  f"ones); backward equal bit for bit across two calls; {share:.4f} of "
                  f"{n} valid pairs dropped (within 4 binomial standard deviations)",
                  flush=True)
            del out, lse, ref, ref_lse, want, runs, got, nodrop_mix, valid
            for kname, (_, err) in errs.items():
                row = rows.setdefault((kname, name), dict(b=b, t=t, max_abs_err=0.0))
                row["max_abs_err"] = max(row["max_abs_err"], err)
        # times, bf16: with and without dropout, and the plain version with it
        args, g = nda_inputs(b, t, torch.bfloat16, bias, gen, kw["kernel"])
        print(f"dropout {name} b={b} t={t}: {tiles_text(knda, args[0], kw)}", flush=True)
        _, lse = knda.sparse_3dna_fwd(*args, **dkw)
        _, ds, mix, *_ = knda.sparse_3dna_bwd_q(*args, g, lse, **dkw)
        plain_iters = 2 if t > 4096 else 5
        for kname, call, plain in (
            ("fwd", lambda k, **o: k.sparse_3dna_fwd(*args, **o), knda.sparse_3dna_fwd_plain),
            ("bwd_q", lambda k, **o: k.sparse_3dna_bwd_q(*args, g, lse, **o),
             knda.sparse_3dna_bwd_q_plain),
            ("bwd_kv", lambda k, **o: k.sparse_3dna_bwd_kv(args[0], g, ds, mix, **o),
             knda.sparse_3dna_bwd_kv_plain),
        ):
            ms = device_ms(lambda: call(knda, **dkw))
            base = device_ms(lambda: call(knda, **kw))
            plain_args = {"fwd": args, "bwd_q": (*args, g, lse),
                          "bwd_kv": (args[0], g, ds, mix)}[kname]
            plain_ms = device_ms(lambda: plain(*plain_args, **dkw), iters=plain_iters)
            bound, by = nda_bounds(knda, b, t, kw["dilation"], torch.bfloat16, bias, kw["fmap"],
                                   kw["kernel"], kw["mode"])[kname]
            rows[kname, name].update(ms=ms, no_dropout_ms=base, plain_ms=plain_ms,
                                     bound_ms=bound, bound_by=by)
            print(f"sparse_3dna_{kname} dropout {DROP_RATE} {name} bf16 b={b} t={t}: kernel "
                  f"{ms:.4f} ms (device), {base:.4f} ms without dropout "
                  f"({100 * (ms / base - 1):+.1f}%), plain {plain_ms:.4f} ms, bound "
                  f"{bound:.6f} ms ({by})", flush=True)
        del args, g, lse, ds, mix
        torch.cuda.empty_cache()
    return {**rows, **cross_dropout_rows()} if cross else rows


# the cross kernels' shapes on the main path, (b, t, context frames), the
# second context frame masked in row 1: the sketch forward's and the sketch
# training step's, at one and two context frames
CROSS_DROPOUT_SHAPES = {
    "forward, Lc 256": (2, SKETCH_T, 1),
    "forward, Lc 512": (2, SKETCH_T, 2),
    "train, Lc 256": (SKETCH_TRAIN_BATCH, SKETCH_TRAIN_T, 1),
    "train, Lc 512": (SKETCH_TRAIN_BATCH, SKETCH_TRAIN_T, 2),
}
CROSS_NAMES = ("out", "lse", *CROSS_BWD_NAMES)
CROSS_WRAPPERS = dict(zip(CROSS, ("sparse_cross_2dna_fwd", "sparse_cross_2dna_bwd_q",
                                  "sparse_cross_2dna_bwd_kv")))


def cross_dropout_rows():
    """The cross forward and both backward kernels with attention dropout
    at DROP_RATE and a seed, at each shape of CROSS_DROPOUT_SHAPES, fp32 and
    bf16, as ``dropout_rows`` holds the Sparse3DNA kernels: against their
    plain versions on the same inputs (each backward given the lse of its
    own forward, as the autograd function gives it), every backward output
    equal bit for bit across two calls, the dropped share of the valid
    pairs' mixed probabilities within 4 binomial standard deviations of the
    rate; then, in bf16, each kernel's device time with and without dropout
    beside its plain version's with dropout and its bound. Returns
    {(kernel, shape): row}."""
    from nuwa_tpu_torch.kernels import cross as kcross

    gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
    rows = {}
    kw = dict(fmap=SKETCH_FMAP, kernel_size=3, dilation=1)
    dkw = dict(kw, dropout=(DROP_RATE, DROP_SEED))
    for name, (b, t, frames) in CROSS_DROPOUT_SHAPES.items():
        mask = torch.ones(b, frames * SKETCH_FMAP**2, dtype=torch.bool, device="cuda")
        mask[1, SKETCH_FMAP**2:] = False  # no-op at one frame
        for dtype in (torch.float32, torch.bfloat16):
            args = cross_inputs(b, t, frames, SKETCH_FMAP, dtype, gen)
            g = torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype)
            out, lse = kcross.sparse_cross_2dna_fwd(*args, mask, **dkw)
            ref, ref_lse = kcross.sparse_cross_2dna_fwd_plain(*args, mask, **dkw)
            want = kcross.sparse_cross_2dna_bwd_q_plain(*args, mask, g, ref_lse, **dkw)
            want += kcross.sparse_cross_2dna_bwd_kv_plain(args[0], g, *want[1:3], **dkw)
            runs = []
            for _ in range(2):
                got = kcross.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **dkw)
                runs.append(got + kcross.sparse_cross_2dna_bwd_kv(args[0], g, *want[1:3],
                                                                  **dkw))
            torch.cuda.synchronize()
            errs = {}
            for oname, a, a2, w in zip(CROSS_NAMES, (out, lse, *runs[0]), (out, lse, *runs[1]),
                                       (ref, ref_lse, *want)):
                if a.dtype != w.dtype or a.shape != w.shape:
                    fail(f"cross dropout {name} {oname}: {a.dtype} {tuple(a.shape)} != "
                         f"{w.dtype} {tuple(w.shape)}")
                if not torch.equal(a, a2):
                    fail(f"cross dropout {name} {oname} {dtype}: two calls differ")
                err = (a.float() - w.float()).abs().max().item()
                rel = err / max(1.0, w.float().abs().max().item())
                tol = TOL[dtype if oname in ROUNDED else torch.float32]
                if not rel <= tol:
                    fail(f"cross dropout {name} {oname} {dtype}: error {rel} of the max abs "
                         f"> {tol}")
                kname = ("cross" if oname in ("out", "lse") else
                         "cross_bwd_kv" if oname in ("dk", "dv") else "cross_bwd_q")
                old = errs.get(kname, (0.0, 0.0))
                errs[kname] = max(old[0], rel), max(old[1], err)
            nodrop_mix = kcross.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **kw)[2]
            valid = nodrop_mix != 0
            n = valid.sum().item()
            share = ((runs[0][2] == 0) & valid).sum().item() / n
            if not abs(share - DROP_RATE) <= 4 * (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5:
                fail(f"cross dropout {name} {dtype}: dropped share {share} of {n} pairs is "
                     f"more than 4 binomial standard deviations from the rate {DROP_RATE}")
            print(f"cross dropout {DROP_RATE} {name} b={b} t={t} {dtype} vs plain: "
                  + ", ".join(f"{CROSS_WRAPPERS[k]} max error {rel:.3e} of the max abs"
                              for k, (rel, _) in errs.items())
                  + f" (tolerances {TOL[dtype]:.0e} for outputs in {dtype}, 1e-05 for fp32 "
                  f"ones); backward equal bit for bit across two calls; {share:.4f} of "
                  f"{n} valid pairs dropped (within 4 binomial standard deviations)",
                  flush=True)
            del out, lse, ref, ref_lse, want, runs, got, nodrop_mix, valid
            for kname, (_, err) in errs.items():
                row = rows.setdefault((kname, name), dict(b=b, t=t, context_frames=frames,
                                                          max_abs_err=0.0))
                row["max_abs_err"] = max(row["max_abs_err"], err)
        # times, bf16: with and without dropout, and the plain version with it
        args = cross_inputs(b, t, frames, SKETCH_FMAP, torch.bfloat16, gen)
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(torch.bfloat16)
        print(f"cross dropout {name} b={b} t={t}: "
              f"{cross_tiles_text(kcross, args[0], frames * SKETCH_FMAP**2, kw)}", flush=True)
        _, lse = kcross.sparse_cross_2dna_fwd(*args, mask, **dkw)
        _, ds, mix, *_ = kcross.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **dkw)
        bwd_bounds = cross_bwd_bounds(kcross, b, t, frames, mask, torch.bfloat16)
        bounds = {"cross": cross_bound(kcross, b, t, frames, mask, torch.bfloat16),
                  "cross_bwd_q": bwd_bounds["bwd_q"], "cross_bwd_kv": bwd_bounds["bwd_kv"]}
        for kname, call, plain, plain_args in (
            ("cross", lambda k, **o: k.sparse_cross_2dna_fwd(*args, mask, **o),
             kcross.sparse_cross_2dna_fwd_plain, (*args, mask)),
            ("cross_bwd_q", lambda k, **o: k.sparse_cross_2dna_bwd_q(*args, mask, g, lse, **o),
             kcross.sparse_cross_2dna_bwd_q_plain, (*args, mask, g, lse)),
            ("cross_bwd_kv", lambda k, **o: k.sparse_cross_2dna_bwd_kv(args[0], g, ds, mix, **o),
             kcross.sparse_cross_2dna_bwd_kv_plain, (args[0], g, ds, mix)),
        ):
            ms = device_ms(lambda: call(kcross, **dkw))
            base = device_ms(lambda: call(kcross, **kw))
            plain_ms = device_ms(lambda: plain(*plain_args, **dkw), iters=5)
            bound, by = bounds[kname]
            rows[kname, name].update(ms=ms, no_dropout_ms=base, plain_ms=plain_ms,
                                     bound_ms=bound, bound_by=by)
            print(f"{CROSS_WRAPPERS[kname]} dropout {DROP_RATE} {name} "
                  f"bf16 b={b} t={t}: kernel {ms:.4f} ms (device), {base:.4f} ms without "
                  f"dropout ({100 * (ms / base - 1):+.1f}%), plain {plain_ms:.4f} ms, bound "
                  f"{bound:.6f} ms ({by})", flush=True)
        del args, g, lse, ds, mix
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the rest of the surface: causal dense attention, method="full", int8
# weights, checkpoints and resume
# ---------------------------------------------------------------------------

# BASELINE.json config 2 ("NUWA tiny: full attention path, non-reversible") at
# full width: the dense causal decoder with cross-attention over the tokens of
# 4 frames of 64 px through config 1's 2-layer codec (fmap 16, 1,024 tokens),
# b = 2, a 256-token text context whose second row masks its last 128
DENSE = dict(dim=512, depth=4, heads=8, dim_head=64, causal=True, cross_attend=True)
DENSE_B, DENSE_N, DENSE_CTX = 2, 4 * 16**2, 256
DENSE_STEPS = 64  # teacher-forced cached steps after a prefill of the rest
# greedy ids of two bf16 paths (full and cached) may part at a near-tie of the
# top two logits: a gap of at most BF16_TIE_ULPS bf16 ulps of the step's top
# logit (8 significant bits; CFG 2.0 triples a rounding carried through 6
# layers)
BF16_TIE_ULPS = 4
# the NUWAVideoAudio of the full-method and int8 phases: bench.py's depth-12
# config's widths (dim 512, 8 heads of 64, fmap 8 through a 2-layer codec on
# 32-px frames, 32 audio tokens a frame) at depth 3, so one cross-modality
# block, one frame a generate
DUAL_FULL = dict(DUAL12, dec_depth=3)
RESUME_TOL = 1e-6  # parameters after the resumed step (expected: equal)


def greedy_thres(vocab):
    return 1 - 0.5 / vocab  # top-k keeps k = max(int(0.5), 1) = 1: greedy


def counted(name, knda, tally, call, expect):
    """One request with the counts set to 0 just before it and read just
    after, held to ``expect_launches(**expect)`` and added to ``tally`` (a
    Counter of the surface phases' launches); returns (output, ms, launches
    read)."""
    reset_launches(knda)
    out, ms = timed(call)
    got = launch_counts(knda)
    if got != expect_launches(**expect):
        fail(f"{name}: launches {got}, expected {expect_launches(**expect)}")
    tally.update(got)
    return out, ms, got


def dense_causal(knda, tally):
    """BASELINE config 2 at full width: the fp32 forward on the GPU against
    the CPU, causality at position 10 (a later token changed, the earlier
    outputs unchanged), the cached decoder (a prefill, then teacher-forced
    steps) against the forward, and the bf16 forward's time. No kernel of
    the port is on this path (the JAX package runs it outside Pallas): every
    count stays 0."""
    import copy

    from nuwa_tpu_torch.core.layers import init_weights_
    from nuwa_tpu_torch.decode import TransformerDecoder
    from nuwa_tpu_torch.transformer import Transformer

    cpu = init_weights_(Transformer(**DENSE), SEED + 80)
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(SEED + 81)
    x = torch.randn(DENSE_B, DENSE_N, DENSE["dim"], generator=gen)
    ctx = torch.randn(DENSE_B, DENSE_CTX, DENSE["dim"], generator=gen)
    cmask = torch.ones(DENSE_B, DENSE_CTX, dtype=torch.bool)
    cmask[1, DENSE_CTX // 2:] = False
    xg, cg, mg = x.cuda(), ctx.cuda(), cmask.cuda()
    with torch.no_grad():
        out, _, got = counted("dense causal forward fp32", knda, tally,
                              lambda: gpu(xg, context=cg, context_mask=mg), {})
        ref = cpu(x, context=ctx, context_mask=cmask)
        err = (out.cpu() - ref).abs().max().item()
        x2 = xg.clone()
        x2[:, 10] = 3.0
        out2 = gpu(x2, context=cg, context_mask=mg)
        causal_err = (out2[:, :10] - out[:, :10]).abs().max().item()
        moved = (out2[:, 10:] - out[:, 10:]).abs().max().item()
        dec = TransformerDecoder(gpu, total_in=DENSE_N)
        caches = dec.init_cache(DENSE_B, cg, mg)
        split = DENSE_N - DENSE_STEPS
        dec.prefill(caches, xg[:, :split])
        steps = torch.stack([dec.step(caches, xg[:, i], i) for i in range(split, DENSE_N)],
                            dim=1)
        step_err = (steps - out[:, split:]).abs().max().item()
    print(f"dense causal decoder (BASELINE config 2, dim {DENSE['dim']}, depth {DENSE['depth']}, "
          f"b={DENSE_B}, "
          f"{DENSE_N} tokens, context {DENSE_CTX}): fp32 GPU vs CPU max abs err {err:.3e} "
          f"(tolerance {LOGITS_ATOL:.0e}); position 10 changed: outputs before it moved "
          f"{causal_err:.1e} (tolerance {TOL[torch.float32]:.0e}), after it {moved:.2e}; "
          f"prefill of {split} + {DENSE_STEPS} cached steps vs the forward {step_err:.3e} "
          f"(tolerance {LOGITS_ATOL:.0e}); no kernel launched", flush=True)
    if not (err <= LOGITS_ATOL and causal_err <= TOL[torch.float32] and moved > 0
            and step_err <= LOGITS_ATOL):
        fail("the dense causal decoder differs from the CPU, leaks the future or "
             "its cached steps differ from its forward")
    xb, cb = xg.bfloat16(), cg.bfloat16()
    with torch.no_grad():
        ms = cuda_ms(lambda: gpu(xb, context=cb, context_mask=mg), iters=5, reps=3)
    tokens = DENSE_B * DENSE_N
    print(f"dense causal forward bf16 (b={DENSE_B}, {DENSE_N} tokens): {ms:.2f} ms, "
          f"{tokens / (ms / 1e3):.0f} tokens/s", flush=True)
    del gpu
    torch.cuda.empty_cache()
    return {"ms": ms, "fp32_err": err}


def check_near_tie(name, ids_a, ids_b, gap_at, tie):
    """Greedy ids of two paths: equal, or parting first at a step p whose
    top-2 logit gap ``gap_at(p)`` is below ``tie`` (or ``tie(p)``)."""
    diff = (ids_a.cpu() != ids_b.cpu()).nonzero()
    if len(diff) == 0:
        print(f"{name}: all {ids_a.numel()} greedy ids equal", flush=True)
        return None
    p = diff[0, -1].item()
    gap = gap_at(p)
    tie = tie(p) if callable(tie) else tie
    print(f"{name}: greedy ids part first at position {p}; top-2 logit gap there "
          f"{gap:.3e} (a tie below {tie:.3e})", flush=True)
    if not gap < tie:
        fail(f"{name}: greedy ids differ away from a near-tie")
    return p


def bf16_tie(top):
    """The near-tie limit at each step of two bf16 paths' greedy ids:
    BF16_TIE_ULPS bf16 ulps of the step's top logit ``top``."""
    return BF16_TIE_ULPS * torch.exp2(torch.floor(torch.log2(top.abs())) - 7)


def mix(row, cond_scale=2.0):
    """CFG-mixed logits of b = 1 from the doubled batch's rows, in the rows'
    dtype and in the order the samplers mix them."""
    return row[1:] + (row[:1] - row[1:]) * cond_scale


def full_rows(model, ctx, cmask, ids):
    """The rows (n, V) a b = 1 single-tower method="full" rollout ``ids`` (1,
    n) sampled from, recomputed by teacher-forced forwards of the same
    shapes: one over the first max_video_frames frames, then one over each
    later frame's window. CFG-mixed in the model's dtype, then fp32."""
    tpf, maxf = model.tokens_per_frame, model.max_video_frames
    ids = ids.to(model.device)
    n = ids.shape[1]
    chunks = [(0, 0, min(n, maxf * tpf))]  # (window start, first row, end)
    chunks += [((f - maxf + 1) * tpf, f * tpf, (f + 1) * tpf) for f in range(maxf, n // tpf)]
    rows = []
    with torch.no_grad():
        for start, first, end in chunks:
            inp = ids[:, start:end - 1].repeat(2, 1)
            rows.append(mix(model._decode_logits(inp, ctx, cmask)[:, first - start:]))
    return torch.cat(rows, dim=1)[0].float()


def check_full_rows(name, ids, rows, other=None):
    """A bf16 greedy method="full" rollout against ``rows``, the logits it
    sampled from (``full_rows``): each id is the top of its row, up to a
    bf16 near-tie. Prints the median top-2 gap over the steps and the share
    of steps at a near-tie, where two bf16 paths may part. With ``other``
    (the cached path's ids), the two are equal or part first at a near-tie
    (the gap from ``rows``)."""
    ids = ids.reshape(-1).to(rows.device)
    top2 = rows.topk(2, dim=-1).values
    gaps, tie = top2[:, 0] - top2[:, 1], bf16_tie(top2[:, 0])
    regret = top2[:, 0] - rows.gather(1, ids[:, None])[:, 0]
    print(f"{name}: {ids.numel()} steps, top-2 logit gap median {gaps.median().item():.3e} "
          f"(min {gaps.min().item():.3e}); near-tie limit ({BF16_TIE_ULPS} bf16 ulps of the "
          f"top logit) median {tie.median().item():.3e}, {(gaps < tie).float().mean().item():.1%}"
          f" of steps below it; each full id's logit below its row's top by at most "
          f"{regret.max().item():.3e} (at most the limit)", flush=True)
    if not bool((regret <= tie).all()):
        fail(f"{name}: method=full sampled an id away from the top of its row")
    if other is not None:
        check_near_tie(f"{name} full vs cached", ids, other.reshape(-1),
                       lambda p: gaps[p].item(), lambda p: tie[p].item())


def full_nuwa(model, texts, knda, tally):
    """method="full" on the serving model (bench.py's decode config, bf16,
    CFG 2.0, b = 1), greedy: generate (4 frames: 256 full re-forwards, each
    6 launches of the forward kernel) and generate_long one frame past the
    window (256 + 64 re-forwards), each against method="cached" on the card
    with the near-tie rule; tokens/s of both."""
    depth, tpf, maxf = FULL["dec_depth"], model.tokens_per_frame, model.max_video_frames
    text = texts[1]
    ids = torch.as_tensor(text, device=model.device)
    with torch.no_grad():
        ctx, cmask = model._cfg_context(model.embed_text(ids, ids != 0), ids != 0, True)
    kw = dict(filter_thres=greedy_thres(FULL["num_image_tokens"]), cond_scale=2.0)
    rates = {}
    for name, frames, call in (
        ("generate", maxf, lambda method: model.generate(text, method=method, **kw)),
        ("generate_long", maxf + 1, lambda method: model.generate_long(
            text, num_frames=maxf + 1, method=method, **kw)),
    ):
        n = frames * tpf
        want_full = n * depth
        full, full_ms, got = counted(f"{name} full", knda, tally, lambda: call("full"),
                                     {"fwd": want_full})
        cached, cached_ms, _ = counted(f"{name} cached", knda, tally, lambda: call("cached"),
                                       {"fwd": depth if frames > maxf else 0})
        check_ids(f"{name} full", full, (1, n))
        rates[name] = {"full": n / (full_ms / 1e3), "cached": n / (cached_ms / 1e3)}
        print(f"NUWA {name} b=1, {frames} frames, bf16: method=full {full_ms:.0f} ms "
              f"({rates[name]['full']:.1f} tokens/s, {got['fwd']} sparse_3dna_fwd launches "
              f"= {n} re-forwards x {depth}), cached {cached_ms:.0f} ms "
              f"({rates[name]['cached']:.1f} tokens/s)", flush=True)
        check_full_rows(f"NUWA {name}", full, full_rows(model, ctx, cmask, full), cached)
    return rates


def full_sketch(NUWASketch, VQGanVAE, knda, tally):
    """method="full" on the sketch serving model with a centered Sparse3DNA
    sketch encoder (BASELINE config 4's sketch side at the serving widths),
    bf16, a 2-frame sketch, CFG 2.0, greedy, one frame (256 re-forwards,
    each 6 launches of the forward kernel and 6 of the cross forward at two
    context frames; the encoder's 2 centered launches once): against
    method="cached" on the card with the near-tie rule."""
    model = sketch_models(NUWASketch, VQGanVAE, sketch_enc_use_sparse_3dna=True)
    sketch = sketch_request(1, 2, torch.Generator().manual_seed(SEED + 82))[0]
    depth, tpf = SKETCH["dec_depth"], SKETCH_FMAP**2
    enc = SKETCH["sketch_enc_depth"]
    kw = dict(filter_thres=greedy_thres(SKETCH_VAE["vq_codebook_size"]), cond_scale=2.0,
              num_frames=1, decode_video=False)
    full, full_ms, got = counted(
        "sketch generate full", knda, tally, lambda: model.generate(sketch, method="full", **kw),
        {"fwd": tpf * depth + enc, "fwd_centered": enc, "cross": tpf * depth})
    cached, cached_ms, _ = counted(
        "sketch generate cached", knda, tally, lambda: model.generate(sketch, **kw),
        {"fwd": enc, "fwd_centered": enc})
    rates = {"full": tpf / (full_ms / 1e3), "cached": tpf / (cached_ms / 1e3)}
    print(f"NUWASketch generate b=1, 1 frame, bf16: method=full {full_ms:.0f} ms "
          f"({rates['full']:.1f} tokens/s; launches sparse_3dna_fwd {got['fwd']} of which "
          f"centered {got['fwd_centered']}, sparse_cross_2dna_fwd {got['cross']}), cached "
          f"{cached_ms:.0f} ms ({rates['cached']:.1f} tokens/s)", flush=True)
    with torch.no_grad():
        ctx, cmask = model._sketch_context(sketch, None, True)
    check_full_rows("NUWASketch generate", full, full_rows(model, ctx, cmask, full), cached)
    del model
    torch.cuda.empty_cache()
    return rates


def dual_gap(model, text, vids, aids, p, video):
    """Top-2 logit gap of method="full" at the step that samples video (or
    audio) position p, from the ids sampled before it."""
    text = torch.as_tensor(text, device=model.device)
    ctx, cmask = model._text_context(text, True)
    vbuf, abuf = vids.clone().to(model.device), aids.clone().to(model.device)
    if video:
        vbuf[:, p:] = 0
        abuf[:, (p // model.tokens_per_frame) * model.audio_tokens_per_frame:] = 0
    else:
        abuf[:, p:] = 0
    with torch.no_grad():
        logits = model._decode(vbuf[:, :-1].repeat(2, 1), abuf[:, :-1].repeat(2, 1), ctx, cmask)
    top = mix(logits[0 if video else 1][:, p]).float().topk(2, dim=-1).values[0]
    return (top[0] - top[1]).item()


def dual_rows(model, text, vids, aids):
    """The video and audio rows a one-frame b = 1 method="full" rollout at
    H = 1 sampled from (see ``full_rows``): the video steps saw no audio of
    the frame, the audio steps the whole video; within a tower the forward
    is causal. CFG-mixed in the model's dtype, then fp32."""
    text = torch.as_tensor(text, device=model.device)
    vids, aids = vids.to(model.device), aids.to(model.device)
    with torch.no_grad():
        ctx, cmask = model._text_context(text, True)
        v_inp = vids[:, :-1].repeat(2, 1)
        vl, _ = model._decode(v_inp, torch.zeros_like(aids[:, :-1]).repeat(2, 1), ctx, cmask)
        _, al = model._decode(v_inp, aids[:, :-1].repeat(2, 1), ctx, cmask)
    return mix(vl)[0].float(), mix(al)[0].float()


def check_dual_ids(name, a, b, model_fn, text, tie):
    """Video then audio ids of two rollouts of one frame, held by the
    near-tie rule at the first step where they part: the video's, or, where
    the videos agree, the audio's (the gap from ``model_fn()``'s logits,
    built only there)."""
    (va, aa), (vb, ab) = a, b
    check_near_tie(f"{name} (video)", va, vb,
                   lambda p: dual_gap(model_fn(), text, va, aa, p, True), tie)
    if torch.equal(va.cpu(), vb.cpu()):  # else the audio saw other video tokens
        check_near_tie(f"{name} (audio)", aa, ab,
                       lambda p: dual_gap(model_fn(), text, va, aa, p, False), tie)


def full_dual(NUWAVideoAudio, VQGanVAE, knda, tally, refs):
    """method="full" on NUWAVideoAudio at width 512 (DUAL_FULL, CFG 2.0,
    greedy, one frame: 64 video and 32 audio steps, each a re-forward of both
    towers: 2 x depth launches of the forward kernel, depth of them audio):
    at H = 1, bf16, against method="cached" on the card (near-tie rule); at
    H = 4, fp32, against the CPU's method="full" ids (``refs``; the full
    forward sees the later tokens of a query's own timestep there, as the
    JAX one does).
    """
    depth, atpf = DUAL_FULL["dec_depth"], DUAL_FULL["num_audio_tokens_per_video_frame"]
    text = request_text(1, torch.Generator().manual_seed(SEED + 83))
    vocab = max(DUAL_FULL["num_audio_tokens"], DUAL12_VAE["vq_codebook_size"])
    kw = dict(filter_thres=greedy_thres(vocab), cond_scale=2.0, num_frames=1,
              decode_video=False)
    model = dual_model(NUWAVideoAudio, VQGanVAE, DUAL_FULL, DUAL12_VAE)
    steps = model.tokens_per_frame + atpf
    want = {"fwd": steps * 2 * depth, "fwd_audio": steps * depth}
    full, full_ms, got = counted("dual generate full", knda, tally,
                                 lambda: model.generate(text, method="full", **kw), want)
    cached, cached_ms, _ = counted("dual generate cached", knda, tally,
                                   lambda: model.generate(text, **kw), {})
    rates = {"full": steps / (full_ms / 1e3), "cached": steps / (cached_ms / 1e3)}
    print(f"NUWAVideoAudio generate b=1, 1 frame, H=1, depth {depth}, bf16: method=full "
          f"{full_ms:.0f} ms ({rates['full']:.1f} tokens/s; launches sparse_3dna_fwd "
          f"{got['fwd']} of which audio {got['fwd_audio']}), cached {cached_ms:.0f} ms "
          f"({rates['cached']:.1f} tokens/s)", flush=True)
    vrows, arows = dual_rows(model, text, *full)
    check_full_rows("NUWAVideoAudio H=1 generate (video)", full[0], vrows, cached[0])
    check_full_rows("NUWAVideoAudio H=1 generate (audio)", full[1], arows,
                    cached[1] if torch.equal(full[0].cpu(), cached[0].cpu()) else None)
    del model
    torch.cuda.empty_cache()

    model = full_dual_h4_model("cuda")
    start = time.perf_counter()
    out, _, _ = counted("dual generate full H=4 fp32", knda, tally,
                        lambda: model.generate(text, method="full", **kw), want)
    print(f"NUWAVideoAudio H=4 method=full fp32 on cuda: {time.perf_counter() - start:.1f} s",
          flush=True)
    del model
    torch.cuda.empty_cache()
    check_dual_ids("NUWAVideoAudio H=4 full, GPU vs CPU fp32", out, refs.result("dual full"),
                   lambda: full_dual_h4_model("cpu"), text, TIE_GAP)
    return rates


def full_dual_h4_model(device):
    from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE

    return dual_model(NUWAVideoAudio, VQGanVAE, dict(DUAL_FULL, audio_tokens_per_timestep=4),
                      DUAL12_VAE, device=device, dtype=None, seed=SEED + 84)


def full_dual_side(device):
    """full_dual's H = 4 run on ``device``: the greedy method="full" ids of
    one frame (CFG 2.0), fp32."""
    text = request_text(1, torch.Generator().manual_seed(SEED + 83))
    vocab = max(DUAL_FULL["num_audio_tokens"], DUAL12_VAE["vq_codebook_size"])
    model = full_dual_h4_model(device)
    start = time.perf_counter()
    out = model.generate(text, method="full", filter_thres=greedy_thres(vocab), cond_scale=2.0,
                         num_frames=1, decode_video=False)
    print(f"NUWAVideoAudio H=4 method=full fp32 on {device}: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return out


def int8_fp32_model(device):
    from nuwa_tpu_torch import NUWA
    from nuwa_tpu_torch.utils.quantize import quantize_int8_

    return quantize_int8_(NUWA(**FULL, device=device, seed=SEED + 7))


def int8_dual_inputs():
    """(video ids, audio ids) of the int8 NUWAVideoAudio forward."""
    frames = DUAL_FULL["max_video_frames"]
    fmap = DUAL12_VAE["image_size"] // 2 ** DUAL12_VAE["num_layers"]
    gen = torch.Generator().manual_seed(SEED + 87)
    ids = torch.randint(0, DUAL12_VAE["vq_codebook_size"], (1, frames * fmap**2), generator=gen)
    audio = torch.randint(0, DUAL_FULL["num_audio_tokens"],
                          (1, frames * DUAL_FULL["num_audio_tokens_per_video_frame"]),
                          generator=gen)
    return ids, audio


def int8_dual_model(device):
    from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE
    from nuwa_tpu_torch.utils.quantize import quantize_int8_

    return quantize_int8_(dual_model(NUWAVideoAudio, VQGanVAE, DUAL_FULL, DUAL12_VAE,
                                     device=device, dtype=None, seed=SEED + 89))


def int8_side(text, video):
    """int8_serving's fp32 runs on the CPU: the int8 serving model's forward
    logits and greedy cached ids, and the int8 NUWAVideoAudio's forward
    logits."""
    start = time.perf_counter()
    model = int8_fp32_model("cpu")
    with torch.no_grad():
        logits = model(text, video)
    ids = model.generate(text, filter_thres=greedy_thres(FULL["num_image_tokens"]))
    with torch.no_grad():
        dual = list(int8_dual_model("cpu")(text, *int8_dual_inputs()))
    print(f"int8 fp32 forwards and greedy generate on cpu: {time.perf_counter() - start:.1f} s",
          flush=True)
    return logits, ids, dual


def int8_video():
    """The int8 forward's video ids."""
    return torch.randint(0, FULL["num_image_tokens"],
                         (1, FULL["max_video_frames"] * FULL["image_size"] ** 2),
                         generator=torch.Generator().manual_seed(SEED + 86))


def int8_serving(NUWA, knda, bf16_model, texts, tally, refs):
    """int8 weight-only serving (utils.quantize.quantize_int8_): the serving
    model quantised (bf16 activations) against the bf16 one, cached generate
    b = 8: weights held, tokens/s and peak memory; its forward launches the
    forward kernel as the bf16 model does (6, and none in generate). Then
    the same weights in fp32, quantised on the GPU and on the CPU: forward
    logits and greedy cached ids (near-tie rule), and NUWAVideoAudio's
    forward logits (DUAL_FULL, from token ids); the CPU's from ``refs``."""
    from nuwa_tpu_torch.utils.quantize import quantize_int8_

    depth = FULL["dec_depth"]
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    q = quantize_int8_(NUWA(**FULL, compute_dtype="bfloat16", seed=SEED))
    torch.cuda.empty_cache()
    q_bytes = torch.cuda.memory_allocated() - before
    bf16_bytes = sum(t.numel() * t.element_size()
                     for t in itertools.chain(bf16_model.parameters(), bf16_model.buffers()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 85)
    video = int8_video()
    counted("int8 forward b=1", knda, tally, torch.no_grad()(lambda: q(texts[1], video)),
            {"fwd": depth})
    stats = {}
    for name, model in (("bf16", bf16_model), ("int8", q)):
        model.generate(texts[8], generator=gen)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # both models and earlier phases' tensors
        ids, ms, _ = counted(f"{name} generate b=8", knda, tally,
                             lambda: model.generate(texts[8], generator=gen), {})
        check_ids(f"{name} generate b=8", ids, (8, model.max_video_tokens))
        stats[name] = {"tokens_per_s": 8 * model.max_video_tokens / (ms / 1e3),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "request_mib": (torch.cuda.max_memory_allocated() - base) / 2**20}
    print(f"int8 vs bf16 serving (cached generate b=8, 4 frames, CFG 2.0): "
          f"{stats['int8']['tokens_per_s']:.1f} vs {stats['bf16']['tokens_per_s']:.1f} "
          f"tokens/s; peak memory {stats['int8']['peak_gib']:.3f} vs "
          f"{stats['bf16']['peak_gib']:.3f} GiB with both models resident, of which the "
          f"request's own {stats['int8']['request_mib']:.1f} vs "
          f"{stats['bf16']['request_mib']:.1f} MiB; weights held {q_bytes / 2**20:.1f} vs "
          f"{bf16_bytes / 2**20:.1f} MiB (the bf16 model keeps fp32 weights and casts them)",
          flush=True)
    del q
    torch.cuda.empty_cache()

    gpu = int8_fp32_model("cuda")
    text = texts[1]
    with torch.no_grad():
        logits = gpu(text, video).cpu()
    ids_gpu = gpu.generate(text, filter_thres=greedy_thres(FULL["num_image_tokens"])).cpu()
    del gpu
    cpu_logits, ids_cpu, cpu_dual = refs.result("int8")
    err = (logits - cpu_logits).abs().max().item()
    print(f"int8 fp32 forward logits GPU vs CPU: max abs err {err:.3e} (tolerance "
          f"{LOGITS_ATOL:.0e})", flush=True)
    if not err <= LOGITS_ATOL:
        fail("int8 logits differ between GPU and CPU")
    check_near_tie("int8 fp32 greedy generate GPU vs CPU", ids_gpu, ids_cpu,
                   lambda p: cpu_top2_gap(int8_fp32_model("cpu"), text, ids_cpu, p, 2.0),
                   TIE_GAP)

    model = int8_dual_model("cuda")
    with torch.no_grad():
        out, _, _ = counted("int8 dual forward fp32", knda, tally,
                            lambda: model(text, *int8_dual_inputs()),
                            {"fwd": 2 * DUAL_FULL["dec_depth"],
                             "fwd_audio": DUAL_FULL["dec_depth"]})
    del model
    errs = [(a.cpu() - b).abs().max().item() for a, b in zip(out, cpu_dual)]
    print(f"int8 NUWAVideoAudio fp32 forward GPU vs CPU: video logits {errs[0]:.3e}, audio "
          f"logits {errs[1]:.3e} (tolerance {LOGITS_ATOL:.0e})", flush=True)
    if not max(errs) <= LOGITS_ATOL:
        fail("int8 NUWAVideoAudio logits differ between GPU and CPU")
    torch.cuda.empty_cache()
    return stats


def resume_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally):
    """Checkpoints and resume at 128 px (BASELINE config 3, train_128's model
    and batch, bf16): NUWATrainer with save_model_every=1 takes 2 steps; a
    fresh trainer over a model of other weights resumes from the folder; both
    take step 3 on the same batch: the same loss and parameters. The file's
    size and the save and load times."""
    import os
    import tempfile

    from nuwa_tpu_torch.train import checkpoint

    depth = NUWA128["dec_depth"]
    per_step = {"fwd": 2 * depth, "bwd_q": depth, "bwd_kv": depth}
    text = nuwa128_text(tokenizer, NUWA128_BATCH).numpy()
    video = moving_squares(NUWA128_BATCH, NUWA128["max_video_frames"], SIZE128,
                           np.random.default_rng(SEED + 45))
    with tempfile.TemporaryDirectory() as folder:
        def trainer(model, **kw):
            t = NUWATrainer(
                nuwa=model, dataset=list(zip(text, video)), num_train_steps=3, lr=3e-4,
                wd=0.01, batch_size=NUWA128_BATCH, grad_accum_every=1, max_grad_norm=0.5,
                cond_dropout_prob=0.2, save_results_every=1000, num_sampled_frames=1,
                seed=SEED, results_folder=folder, **kw)
            # the step-0 sample (about 22 s of 1,024 tokens) is train_128's check
            t._sample = lambda *a: None
            return t

        def step(t, name):
            return counted(name, knda, tally, t.train_step, per_step)[0]["loss"]

        first = trainer(nuwa128_model(NUWA, VQGanVAE), save_model_every=1)
        for i in range(2):
            step(first, f"128 px train step {i}, saving")
        path = checkpoint.latest_checkpoint(folder, "nuwa_trainstate")[1]
        size = os.path.getsize(path)
        torch.cuda.synchronize()
        start = time.perf_counter()
        first.save(99)
        save_s = time.perf_counter() - start
        os.remove(os.path.join(folder, "nuwa_trainstate.99.ckpt"))
        os.remove(os.path.join(folder, "nuwa_trainstate.LATEST"))  # the scan finds step 1
        model = nuwa128_model(NUWA, VQGanVAE, seed=SEED + 1)
        torch.cuda.synchronize()
        start = time.perf_counter()
        resumed = trainer(model, resume=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        if resumed.step != 2:
            fail(f"resume restored step {resumed.step}, expected 2")
        want, got = step(first, "128 px train step 2"), step(resumed, "128 px resumed step 2")
        diff = max((a - b).abs().max().item()
                   for a, b in zip(first.nuwa.parameters(), resumed.nuwa.parameters()))
    print(f"resume at 128 px (BASELINE config 3, bf16, b={NUWA128_BATCH}): step 3 loss "
          f"{got:.6f} resumed vs {want:.6f} uninterrupted ({'equal' if got == want else 'DIFFER'}"
          f"); parameters after it: max abs difference {diff:.3e} (tolerance {RESUME_TOL:.0e}, "
          f"{'bit-equal' if diff == 0 else 'not bit-equal'}); checkpoint "
          f"{size / 2**20:.1f} MiB, save {1e3 * save_s:.0f} ms, load (a trainer with "
          f"resume=True) {1e3 * load_s:.0f} ms", flush=True)
    if got != want or not diff <= RESUME_TOL:
        fail("the resumed step differs from the uninterrupted one")
    del first, resumed, model
    torch.cuda.empty_cache()
    return {"mib": size / 2**20, "save_ms": 1e3 * save_s, "load_ms": 1e3 * load_s}


# ---------------------------------------------------------------------------
# codec training (VQGanVAETrainer)
# ---------------------------------------------------------------------------

# README.md:12-14: the codec and its trainer, every other option at its
# default (GAN on, VGG16 perceptual loss with random weights, attention and a
# res block on the last layer, a 256-dim cosine codebook of 8,192 with
# k-means init, hinge loss, fp32)
README_VAE = dict(dim=256, image_size=256, num_layers=4, vq_codebook_size=8192)
README_TRAINER = dict(lr=3e-4, batch_size=8, grad_accum_every=4)
CODEC_FRAMES, CODEC_STEPS = 64, 3
# BASELINE config 1 with the GAN on and the random-feature perceptual loss
CONFIG1_GAN = dict(dim=64, image_size=64, num_layers=2, vq_codebook_size=512,
                   perceptual="random_vgg")
# fp32 GPU vs CPU codec losses, relative: the gradient penalty of a random
# discriminator is in the tens of thousands
CODEC_LOSS_REL = 1e-5


def codec_frames(n, size, seed):
    """n seeded moving-square frames (n // 4 clips of 4), (n, 3, size, size)."""
    video = moving_squares(n // 4, 4, size, np.random.default_rng(seed))
    return video.reshape(n, 3, size, size)


LOADER_BATCH, LOADER_REPEATS = 32, 5


def check_loader(mm):
    """The batch loader (``nuwa_tpu_torch/native``, host C++ built with g++)
    on the codec phase's memmap: its build, ``gather_normalize_f32`` of
    LOADER_BATCH seeded indices and ``rot90_f32`` of every gathered image at
    each k from -1 to 4, bit for bit against their numpy versions, and the
    host time of one gather and of one dataset read (an image gathered and
    rotated), native against numpy (medians of LOADER_REPEATS)."""
    from nuwa_tpu_torch import native
    from nuwa_tpu_torch.native import loader

    found = loader.library_path().exists()
    start = time.perf_counter()
    path = native.build_library()
    build_s = time.perf_counter() - start
    if not native.library_available():
        fail(f"the batch loader {path} does not load")
    idx = np.random.default_rng(SEED + 68).integers(0, len(mm), size=LOADER_BATCH)
    times = {"native": [], "numpy": []}
    for _ in range(LOADER_REPEATS):
        outs = {}
        for name, fn in (("native", native.gather_normalize_f32),
                         ("numpy", loader.gather_normalize_f32_plain)):
            start = time.perf_counter()
            outs[name] = fn(mm, idx)
            times[name].append(1e3 * (time.perf_counter() - start))
        got, want = outs["native"], outs["numpy"]
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
            fail("the batch loader's gather_normalize_f32 differs from its numpy version")
    ks = range(-1, 5)
    rot_equal = all(np.array_equal(native.rot90_f32(img, k), loader.rot90_f32_plain(img, k))
                    for img in got for k in ks)
    # the dataset's own read: one index gathered, then rotated (k cycling)
    reads = {"native": [], "numpy": []}
    for _ in range(LOADER_REPEATS):
        for name, gather, rot in (
                ("native", native.gather_normalize_f32, native.rot90_f32),
                ("numpy", loader.gather_normalize_f32_plain, loader.rot90_f32_plain)):
            start = time.perf_counter()
            for i in range(len(mm)):
                rot(gather(mm, np.asarray([i]))[0], i % 4)
            reads[name].append(1e3 * (time.perf_counter() - start) / len(mm))
    native_ms, plain_ms, read_ms, plain_read_ms = (
        statistics.median(d[n]) for d in (times, reads) for n in ("native", "numpy"))
    threads = min(os.cpu_count() or 1, 8)
    print(f"batch loader (g++ -O3, host): {os.path.relpath(path)} "
          f"{'found built' if found else f'built in {build_s:.2f} s'}; gather_normalize_f32 "
          f"of {LOADER_BATCH} of the {len(mm)} frames {tuple(mm.shape[1:])} bit-equal to its "
          f"numpy version ({LOADER_REPEATS} times); rot90_f32 of each at k {ks[0]}..{ks[-1]} "
          f"bit-equal: {rot_equal}; one {LOADER_BATCH}-image gather {native_ms:.2f} ms native "
          f"({threads} threads) against {plain_ms:.2f} ms numpy (median of {LOADER_REPEATS}; "
          f"{plain_ms / native_ms:.2f}x); one dataset read (an image gathered and rotated, "
          f"k cycling over the {len(mm)} frames) {read_ms:.3f} ms native against "
          f"{plain_read_ms:.3f} ms numpy (median of {LOADER_REPEATS})", flush=True)
    if not rot_equal:
        fail("the batch loader's rot90_f32 differs from its numpy version")
    return {"build_s": None if found else build_s, "native_ms": native_ms,
            "plain_ms": plain_ms, "read_ms": read_ms, "plain_read_ms": plain_read_ms,
            "threads": threads}


def train_codec(VQGanVAE, VQGanVAETrainer, knda):
    """The README's codec and trainer at full width, fp32, on CODEC_FRAMES
    256-px frames read from a uint8 memmap (MemmappedImageDataset, random
    90-degree rotations, through the batch loader, which ``check_loader``
    builds and checks first), no results folder: CODEC_STEPS steps with the
    EMA on from step 0. Step 0 runs k-means and the gradient penalty.
    Launches no kernel of the port (the JAX package runs the codec outside
    Pallas)."""
    import tempfile

    from nuwa_tpu_torch import native

    frames = codec_frames(CODEC_FRAMES, README_VAE["image_size"], SEED + 60)
    with tempfile.TemporaryDirectory() as folder:
        path = os.path.join(folder, "frames.u8")
        mm = np.memmap(path, mode="w+", dtype=np.uint8, shape=frames.shape)
        mm[:] = np.round(frames * 255).astype(np.uint8)
        mm.flush()
        loader_figures = check_loader(mm)
        reads = collections.Counter()

        def counted(name):
            fn = getattr(native, name)

            def call(*args, **kwargs):
                reads[name] += 1
                return fn(*args, **kwargs)
            return call

        torch.cuda.reset_peak_memory_stats()
        vae = VQGanVAE(**README_VAE, device="cuda", seed=SEED + 61)
        trainer = VQGanVAETrainer(
            vae, num_train_steps=CODEC_STEPS, **README_TRAINER, images_memmap_path=path,
            images_memmap_shape=frames.shape, ema_update_after_step=0, ema_update_every=1,
            seed=SEED)
        counts = {"codec": sum(p.numel() for p in vae.parameters()),
                  "discriminator": sum(p.numel() for p in trainer.gan.discr.parameters()),
                  "vgg": sum(p.numel() for p in trainer.gan.vgg.parameters())}
        times = {"gen": [], "discr": []}

        def timed_part(name, fn):
            def call(*args):
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - start))
                return out
            return call

        trainer.gen_step = timed_part("gen", trainer.gen_step)
        trainer.discr_step = timed_part("discr", trainer.discr_step)
        initted = [vae.vq.initted.item()]
        logs = []
        reset_launches(knda)
        # the dataset imports the loader's functions from nuwa_tpu_torch.native
        # at each read: count the trainer's reads through them
        with contextlib.ExitStack() as stack:
            for name in ("gather_normalize_f32", "rot90_f32"):
                stack.callback(setattr, native, name, getattr(native, name))
                setattr(native, name, counted(name))
            for _ in range(CODEC_STEPS):
                logs.append(trainer.train_step())
                initted.append(vae.vq.initted.item())
        got = launch_counts(knda)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ema_gap = max((trainer.ema[n] - p).abs().max().item()
                      for n, p in vae.named_parameters())
    window = README_TRAINER["batch_size"] * README_TRAINER["grad_accum_every"]
    for i, log in enumerate(logs):
        print(f"codec train step {i} (README codec, fp32, b={README_TRAINER['batch_size']} x "
              f"{README_TRAINER['grad_accum_every']}): generator loss {log['loss']:.6f}, "
              f"discriminator loss {log['discr_loss']:.6f}"
              f"{' (gradient penalty)' if i % trainer.apply_grad_penalty_every == 0 else ''}, "
              f"codebook usage {log['codebook_usage']:.4f}; generator {times['gen'][i]:.1f} ms, "
              f"discriminator {times['discr'][i]:.1f} ms", flush=True)
    step_ms = [g + d for g, d in zip(times["gen"], times["discr"])]
    steady = statistics.mean(step_ms[1:])
    print(f"codec training: k-means initted {initted[0]:.0f} -> {initted[1]:.0f} at step 0; EMA "
          f"max abs distance from the parameters {ema_gap:.3e}; steps 1-{CODEC_STEPS - 1}: "
          f"{steady:.1f} ms a step (generator {statistics.mean(times['gen'][1:]):.1f}, "
          f"discriminator {statistics.mean(times['discr'][1:]):.1f}), "
          f"{1e3 * window / steady:.2f} images/s ({window} images a step); peak memory "
          f"{peak:.2f} GiB; parameters: codec {counts['codec'] / 1e6:.1f} M, discriminator "
          f"{counts['discriminator'] / 1e6:.1f} M, VGG16 {counts['vgg'] / 1e6:.1f} M; "
          f"kernel launches {sum(got.values())}; images read through the batch loader "
          f"{reads['gather_normalize_f32']} (rot90_f32 {reads['rot90_f32']})", flush=True)
    if not all(math.isfinite(log[k]) for log in logs for k in ("loss", "discr_loss")):
        fail("codec training gave a non-finite loss")
    if not reads["gather_normalize_f32"] >= CODEC_STEPS * window or \
            reads["rot90_f32"] != reads["gather_normalize_f32"]:
        fail(f"the codec trainer did not read its images through the batch loader: {reads}")
    if initted != [0.0] + [1.0] * CODEC_STEPS:
        fail(f"k-means did not run once at step 0: initted {initted}")
    if not ema_gap > 0:
        fail("the EMA did not move away from the parameters")
    if not 0 < logs[-1]["codebook_usage"] <= 1:
        fail(f"codebook usage {logs[-1]['codebook_usage']}")
    if got != expect_launches():
        fail(f"codec training launched kernels of the port: {got}")
    result = {"step_ms": steady, "gen_ms": statistics.mean(times["gen"][1:]),
              "discr_ms": statistics.mean(times["discr"][1:]), "first_step_ms": step_ms[0],
              "images_per_s": 1e3 * window / steady, "peak_gib": peak, **counts,
              "loader": loader_figures, "loader_reads": dict(reads)}
    del trainer, vae
    torch.cuda.empty_cache()
    return result


def grad_error(got, want):
    """(largest error, where) of {name: gradient} against {name: reference},
    each over its reference's max abs, or over 1e-3 of the largest max abs
    for a gradient that is zero but for rounding (the position bias's last
    bias, which the softmax cancels)."""
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    worst, where = 0.0, None
    for name, ref in want.items():
        rel = (got[name] - ref).abs().max().item() / max(ref.abs().max().item(), floor)
        if rel > worst:
            worst, where = rel, name
    return worst, where


def codec_against_cpu(VQGanVAE):
    """BASELINE config 1 with the GAN on (random-feature VGG), b = 2, fp32:
    the generator loss (k-means on the first update) with every gradient and
    the updated codebook state, then the discriminator loss with the gradient
    penalty and every discriminator gradient, on the GPU against the CPU."""
    img = torch.from_numpy(codec_frames(4, CONFIG1_GAN["image_size"], SEED + 62)[:2])
    runs = []
    for device in ("cuda", "cpu"):
        vae = VQGanVAE(**CONFIG1_GAN, device=device, seed=SEED + 63)
        gan = vae.gan_parts(seed=SEED + 64)
        start = time.perf_counter()
        loss = vae(img, gan=gan, return_loss=True, generator=torch.Generator().manual_seed(0))
        loss.backward()
        grads = {n: p.grad.cpu() for m in (vae, gan) for n, p in m.named_parameters()
                 if p.grad is not None}
        state = {n: b.cpu().clone() for n, b in vae.vq.named_buffers()}
        vae.zero_grad(set_to_none=True)
        gan.zero_grad(set_to_none=True)
        dloss = vae(img, gan=gan, return_discr_loss=True, apply_grad_penalty=True)
        dloss.backward()
        dgrads = {n: p.grad.cpu() for n, p in gan.discr.named_parameters()}
        runs.append((loss.item(), grads, state, dloss.item(), dgrads))
        print(f"config 1 codec loss, discriminator loss and their gradients on {device}: "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        del vae, gan
    (loss_g, g_g, s_g, d_g, dg_g), (loss_c, g_c, s_c, d_c, dg_c) = runs
    worst, where = grad_error(g_g, g_c)
    dworst, dwhere = grad_error(dg_g, dg_c)
    state_err = max((s_g[n] - s_c[n]).abs().max().item() for n in s_c)
    print(f"codec fp32 GPU vs CPU (BASELINE config 1, GAN, random VGG, b=2): generator loss "
          f"{loss_g:.6f} vs {loss_c:.6f}, {len(g_c)} gradients, largest error {worst:.3e} of "
          f"the max abs at {where}; codebook state after the update (k-means) max abs err "
          f"{state_err:.3e}; discriminator loss with the penalty {d_g:.6f} vs {d_c:.6f}, "
          f"{len(dg_c)} gradients, largest error {dworst:.3e} at {dwhere} (tolerances: losses "
          f"{CODEC_LOSS_REL:.0e} relative, gradients {GRAD_REL:.0e}, state {LOSS_ATOL:.0e})",
          flush=True)
    if set(g_g) != set(g_c) or not worst <= GRAD_REL or not dworst <= GRAD_REL:
        fail("codec training gradients differ between GPU and CPU")
    if not all(abs(a - b) <= CODEC_LOSS_REL * abs(b) for a, b in ((loss_g, loss_c), (d_g, d_c))):
        fail("codec training losses differ between GPU and CPU")
    if not state_err <= LOSS_ATOL or s_g["initted"].item() != 1.0:
        fail("the codebook state after the update differs between GPU and CPU")
    torch.cuda.empty_cache()
    return {"max_grad_err": max(worst, dworst), "state_err": state_err}


def codec_resume(VQGanVAE, VQGanVAETrainer):
    """VQGanVAETrainer at BASELINE config 1 (GAN, random VGG, b = 2, fp32)
    with save_model_every=1 on one frame repeated (every batch the same: a
    resume starts the data order again from the seed) takes 2 steps; a
    fresh trainer over other weights resumes the newest file, which holds
    the step count from before its step, as the JAX trainer writes it; both
    take a step: the same losses and parameters, bit for bit. cuDNN runs
    its deterministic algorithms here (its weight gradients otherwise sum
    with atomics; the codec's upsample has a fixed-order backward), so any
    difference is the resume's. The file's size, the second step's save and
    the load times."""
    import os
    import tempfile

    frame = codec_frames(4, CONFIG1_GAN["image_size"], SEED + 65)[0]
    saves = []
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as folder:
        def trainer(seed, **kw):
            return VQGanVAETrainer(
                VQGanVAE(**CONFIG1_GAN, device="cuda", seed=seed), num_train_steps=4, lr=3e-4,
                batch_size=2, grad_accum_every=1, dataset=[frame] * 2, valid_frac=0.0,
                results_folder=folder, seed=SEED, **kw)

        def timed_save(save):
            def call(steps):
                torch.cuda.synchronize()
                start = time.perf_counter()
                path = save(steps)
                saves.append((time.perf_counter() - start, os.path.getsize(path)))
                return path
            return call

        first = trainer(SEED + 66, save_model_every=1)
        first.save = timed_save(first.save)
        for _ in range(2):
            first.train_step()
        first.save_model_every = 1000  # the step compared below writes nothing
        torch.cuda.synchronize()
        start = time.perf_counter()
        resumed = trainer(SEED + 67, resume=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        if resumed.step != 1:
            fail(f"codec resume restored step {resumed.step}, expected 1")
        want, got = first.train_step(), resumed.train_step()
        diff = max((a - b).abs().max().item() for a, b in zip(
            first.gen_params + first.discr_params, resumed.gen_params + resumed.discr_params))
    torch.backends.cudnn.deterministic = False
    save_s, size = saves[-1]
    loss_diff = max(abs(want[k] - got[k]) for k in ("loss", "discr_loss"))
    print(f"codec resume (BASELINE config 1, GAN, random VGG, b=2, fp32, deterministic cuDNN): "
          f"the step after it generator loss {got['loss']:.6f} resumed vs {want['loss']:.6f} "
          f"uninterrupted, discriminator {got['discr_loss']:.6f} vs {want['discr_loss']:.6f} "
          f"(max diff {loss_diff:.3e}); parameters after it: max abs difference {diff:.3e} "
          f"({'bit-equal' if diff == 0 else 'NOT bit-equal'}); checkpoint "
          f"{size / 2**20:.1f} MiB, save {1e3 * save_s:.0f} ms (step 1's, with its EMA file), "
          f"load (a trainer with resume=True) {1e3 * load_s:.0f} ms", flush=True)
    if loss_diff != 0 or diff != 0:
        fail("the resumed codec step differs from the uninterrupted one")
    del first, resumed
    torch.cuda.empty_cache()
    return {"mib": size / 2**20, "save_ms": 1e3 * save_s, "load_ms": 1e3 * load_s}


# ---------------------------------------------------------------------------
# data and tensor parallelism on torch.distributed (world size 1 over NCCL),
# the tracing and timing helpers, and the token shift along time
# ---------------------------------------------------------------------------

# meshed against unmeshed training on one card: the JAX package's tolerances
# (tests/test_parallel.py), held when the two are not bit-equal
MESH_LOSS_RTOL, MESH_PARAM_ATOL, MESH_PARAM_RTOL = 2e-4, 3e-5, 3e-4
MESH_STEPS, MESH_CODEC_STEPS = 3, 2


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def params_diff(a, b):
    """(max abs difference, whether every pair is within the mesh
    tolerances) of two parameter lists."""
    worst, ok = 0.0, True
    for x, y in zip(a, b, strict=True):
        worst = max(worst, (x - y).abs().max().item())
        ok = ok and torch.allclose(x, y, atol=MESH_PARAM_ATOL, rtol=MESH_PARAM_RTOL)
    return worst, ok


def mesh_against_unmeshed(name, losses, want, diff, ok):
    """Print and hold a meshed run against the unmeshed one."""
    equal = losses == want and diff == 0
    print(f"{name}: losses {', '.join(f'{x:.6f}' for x in losses)} meshed vs "
          f"{', '.join(f'{x:.6f}' for x in want)} unmeshed; parameters max abs difference "
          f"{diff:.3e} ({'bit-equal' if equal else 'NOT bit-equal'}; tolerances losses rtol "
          f"{MESH_LOSS_RTOL:.0e}, parameters atol {MESH_PARAM_ATOL:.0e} / rtol "
          f"{MESH_PARAM_RTOL:.0e})", flush=True)
    if not (ok and np.allclose(losses, want, rtol=MESH_LOSS_RTOL, atol=0)):
        fail(f"{name}: the meshed run is not the unmeshed one")


def mesh_train_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally, mesh):
    """NUWATrainer at 128 px (train_128's model and batch, bf16) with and
    without ``mesh`` on copies of one seeded model, MESH_STEPS steps each,
    in turns (unmeshed first, then meshed first, ...), the step-0 sample
    left out (train_128 has it): the losses and parameters; the meshed
    steps' CUDA-event ms beside the unmeshed ones, StepTimer's and
    device_rate's."""
    import copy

    from nuwa_tpu_torch.utils.profiling import StepTimer
    from nuwa_tpu_torch.utils.timing import device_rate

    depth = NUWA128["dec_depth"]
    per_step = {"fwd": 2 * depth, "bwd_q": depth, "bwd_kv": depth}
    text = nuwa128_text(tokenizer, NUWA128_BATCH).numpy()
    video = moving_squares(NUWA128_BATCH, NUWA128["max_video_frames"], SIZE128,
                           np.random.default_rng(SEED + 45))
    model = nuwa128_model(NUWA, VQGanVAE)
    runs = {}
    for label, m in (("unmeshed", None), ("meshed", mesh)):
        t = NUWATrainer(nuwa=copy.deepcopy(model), dataset=list(zip(text, video)),
                        num_train_steps=10**9, lr=3e-4, wd=0.01, batch_size=NUWA128_BATCH,
                        grad_accum_every=1, max_grad_norm=0.5, cond_dropout_prob=0.2,
                        seed=SEED, mesh=m)
        t._sample = lambda *a: None  # 1,024 sampled tokens: train_128's
        runs[label] = (t, [], [])
    del model
    timer = StepTimer(warmup=1)
    for i in range(MESH_STEPS):
        for label in ("unmeshed", "meshed")[::1 if i % 2 == 0 else -1]:
            t, losses, ms = runs[label]
            with timer if label == "meshed" else contextlib.nullcontext():
                logs, step_ms, _ = counted(f"128 px {label} train step {i}", knda, tally,
                                           t.train_step, per_step)
            losses.append(logs["loss"])
            ms.append(step_ms)
    (plain, want, plain_ms), (meshed, losses, ms) = runs.pop("unmeshed"), runs.pop("meshed")
    diff, ok = params_diff(list(meshed.nuwa.parameters()), list(plain.nuwa.parameters()))
    mesh_against_unmeshed(f"128 px NUWATrainer, mesh (data 1, model 1) over NCCL, "
                          f"{MESH_STEPS} steps", losses, want, diff, ok)
    del plain
    steps = [0]

    def dispatch():
        steps[0] += 1
        return torch.tensor(meshed.train_step()["loss"])

    reset_launches(knda)
    rate_s = device_rate(dispatch, k_lo=1, k_hi=3, reps=1)
    got = launch_counts(knda)
    want_launches = expect_launches(**{k: v * steps[0] for k, v in per_step.items()})
    if got != want_launches:
        fail(f"device_rate's {steps[0]} meshed steps: launches {got}, expected {want_launches}")
    tally.update(got)
    summary = timer.summary()
    print(f"128 px train step (b={NUWA128_BATCH}), CUDA events, steps 1-{MESH_STEPS - 1} in "
          f"turns: meshed {', '.join(f'{x:.1f}' for x in ms[1:])} ms, unmeshed "
          f"{', '.join(f'{x:.1f}' for x in plain_ms[1:])} ms (step 0: {ms[0]:.1f}, "
          f"{plain_ms[0]:.1f}); meshed StepTimer {summary['steps']} steps p50 "
          f"{1e3 * summary['p50_s']:.1f} ms, mean {1e3 * summary['mean_s']:.1f} ms; "
          f"device_rate (k 1 and 3, {steps[0]} steps) {1e3 * rate_s:.1f} ms", flush=True)
    return meshed


def mesh_trace(meshed, knda, tally):
    """One meshed step under utils.profiling.trace with an annotate region:
    the region's name in the trace file, and the trace's CUDA time."""
    import glob
    import tempfile

    from nuwa_tpu_torch.utils.profiling import annotate, trace

    depth = NUWA128["dec_depth"]
    with tempfile.TemporaryDirectory() as logdir:
        reset_launches(knda)
        with trace(logdir) as prof:
            with annotate("mesh_train_step"):
                meshed.train_step()
        got = launch_counts(knda)
        files = glob.glob(f"{logdir}/*.pt.trace.json")
        text = open(files[0]).read() if len(files) == 1 else ""
        size = sum(os.path.getsize(f) for f in files)
    if got != expect_launches(fwd=2 * depth, bwd_q=depth, bwd_kv=depth):
        fail(f"the traced step's launches {got}")
    tally.update(got)
    if '"mesh_train_step"' not in text:
        fail(f"the annotate region is not in the trace ({files})")
    cuda_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    print(f"trace of one meshed 128 px step: one file of {size / 2**20:.1f} MiB holding the "
          f"'mesh_train_step' region; its ops' self CUDA time {cuda_ms:.1f} ms", flush=True)


def mesh_generate(model, texts, knda, tally, mesh):
    """Cached generate of the NUWA serving model (b = 8, one frame, bf16,
    CFG 2.0) under the mesh (this rank's rows: every row at one rank)
    against the same call without it: the same ids."""
    from nuwa_tpu_torch.parallel.sharding import data_rows

    text = texts[8]

    def generate(rows):
        return lambda: model.generate(
            text[rows], generator=torch.Generator("cuda").manual_seed(SEED + 90), num_frames=1,
            decode_video=False)

    want, plain_ms, _ = counted("generate b=8 unmeshed", knda, tally, generate(slice(None)), {})
    got, ms, _ = counted("generate b=8 meshed", knda, tally,
                         generate(data_rows(mesh, text.shape[0])), {})
    print(f"NUWA serving model, cached generate b=8 (one frame, {want.shape[1]} tokens a row) "
          f"under the mesh: ids {'equal' if torch.equal(got, want) else 'DIFFER'} to the "
          f"unmeshed ones; {ms:.1f} ms against {plain_ms:.1f} ms", flush=True)
    if not torch.equal(got, want):
        fail("meshed generate ids differ from the unmeshed ones")


def mesh_codec(VQGanVAE, VQGanVAETrainer, mesh):
    """VQGanVAETrainer at BASELINE config 1 (GAN, random VGG, k-means, b = 2,
    fp32, deterministic cuDNN) with and without the mesh, MESH_CODEC_STEPS
    steps each: the losses and the parameters."""
    frames = list(codec_frames(8, CONFIG1_GAN["image_size"], SEED + 91))
    torch.backends.cudnn.deterministic = True
    runs = {}
    for label, m in (("unmeshed", None), ("meshed", mesh)):
        t = VQGanVAETrainer(VQGanVAE(**CONFIG1_GAN, device="cuda", seed=SEED + 92),
                            num_train_steps=MESH_CODEC_STEPS, lr=3e-4, batch_size=2,
                            grad_accum_every=1, dataset=frames, valid_frac=0.0, seed=SEED,
                            mesh=m)
        losses = []
        t.train(log_fn=lambda logs: losses.extend((logs["loss"], logs["discr_loss"])))
        runs[label] = (t, losses)
    torch.backends.cudnn.deterministic = False
    (plain, want), (meshed, losses) = runs["unmeshed"], runs["meshed"]
    diff, ok = params_diff(meshed.gen_params + meshed.discr_params,
                           plain.gen_params + plain.discr_params)
    mesh_against_unmeshed(f"VQGanVAETrainer (BASELINE config 1), mesh (data 1, model 1), "
                          f"{MESH_CODEC_STEPS} steps (generator, discriminator)",
                          losses, want, diff, ok)


def shift_on_the_card():
    """shift_video_tokens on the card at its four flag settings against the
    CPU: the same values (data movement)."""
    from nuwa_tpu_torch.ops.shift import shift_video_tokens

    x = torch.randn(2, 1 + 10 * FMAP128**2 - 37, 512, generator=torch.Generator().manual_seed(5))
    for space, time_ in ((False, False), (True, False), (False, True), (True, True)):
        got = shift_video_tokens(x.cuda(), FMAP128, space, time_).cpu()
        if not torch.equal(got, shift_video_tokens(x, FMAP128, space, time_)):
            fail(f"shift_video_tokens(shift_space={space}, shift_time={time_}) on the card "
                 "differs from the CPU")
    print(f"shift_video_tokens on the card at shift_space / shift_time = (0, 0), (1, 0), "
          f"(0, 1), (1, 1), (2, {x.shape[1]}, 512) at fmap {FMAP128}: equal to the CPU",
          flush=True)


def mesh_phase(NUWA, VQGanVAE, NUWATrainer, VQGanVAETrainer, tokenizer, knda, tally, model,
               texts):
    """A process group of one rank over NCCL and make_mesh(data=1, model=1)
    on the card: the 128-px NUWATrainer, the serving model's generate and
    the config-1 codec trainer under it against the same without it; the
    tracing and timing helpers; the token shift along time. The group is
    destroyed at the end."""
    import torch.distributed as dist

    from nuwa_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    start = time.perf_counter()

    def took(what):
        print(f"  ({what}: {time.perf_counter() - start:.1f} s into the phase)", flush=True)

    try:
        mesh = make_mesh(data=1, model=1, device="cuda")
        print(f"process group: backend {dist.get_backend()}, world size "
              f"{dist.get_world_size()}; mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{mesh.device_type}", flush=True)
        took("the group and the mesh")
        meshed = mesh_train_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally, mesh)
        took("the 128 px trainers")
        mesh_trace(meshed, knda, tally)
        del meshed
        torch.cuda.empty_cache()
        took("the trace")
        mesh_generate(model, texts, knda, tally, mesh)
        took("generate")
        mesh_codec(VQGanVAE, VQGanVAETrainer, mesh)
        took("the codec trainers")
        shift_on_the_card()
        took("the shift")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 19. context parallelism: the kernels' query window and the CP trainer
# ---------------------------------------------------------------------------

# the 128-px and fmap-16 training shapes (b = 2, kernel (5, 3, 3), bias);
# at context 4, dilation 2 looks 8 frames back, past 3 ranks' 3 frames
CP_SHAPES = {"fmap 32": ((FMAP128, FMAP128), T128), "fmap 16": (TRAIN_FMAP, TRAIN_T)}
CP_CONTEXTS, CP_DILATIONS, CP_STEPS = (2, 4), (1, 2), 2
CP_RUNS = ((torch.float32, 0.0), (torch.bfloat16, 0.0), (torch.float32, DROP_RATE),
           (torch.bfloat16, DROP_RATE))
# the outputs of the three kernels in order: the forward's, B2's, B3's
CP_NAMES = ("out", "lse", *BWD_NAMES)
CP_KERNEL_OF = {"out": "fwd", "lse": "fwd", "dk": "bwd_kv", "dv": "bwd_kv"}


def cp_layout(t, fmap, size, dil):
    """Each virtual rank's ((lo, hi), (k_lo, k_hi)) of a causal layer with
    the training kernel at ``dil``: its queries and its key buffer."""
    from nuwa_tpu_torch.parallel.context_parallel import shard_layout

    return shard_layout(t, fmap[0] * fmap[1], size, (TRAIN_KERNEL[0] - 1) * dil, 0)[1]


def shard_args(args, g, kw, lo, hi, k_lo, k_hi):
    """One shard's kernel arguments: its queries over its key buffer, its
    cotangent rows, the forward's and query side's keywords (the window and
    tok0) and the key side's (the window and the keys)."""
    q, k, v, *rest = args
    a = (q[:, :, lo:hi], k[:, :, k_lo:k_hi], v[:, :, k_lo:k_hi], *rest)
    return (a, g[:, :, lo:hi], dict(kw, q_lo=lo - k_lo, tok0=k_lo),
            dict(kw, q_lo=lo - k_lo, t=k_hi - k_lo))


def kernel_chain(knda, a, g, win, kv_win):
    """The forward, query-side and key-side kernels in a row: CP_NAMES."""
    out, lse = knda.sparse_3dna_fwd(*a, **win)
    bq = knda.sparse_3dna_bwd_q(*a, g, lse, **win)
    return (out, lse, *bq, *knda.sparse_3dna_bwd_kv(a[0], g, *bq[1:3], **kv_win))


def reassembled(parts, b, t):
    """The shards' outputs (CP_NAMES each) as the whole sequence's: the
    per-query ones concatenated, the sums over queries summed, each key's
    dk and dv summed over the buffers that hold it (its owner's and the
    halos')."""
    whole = {}
    for i, name in enumerate(CP_NAMES):
        xs = [p[i] for _, p in parts]
        if name in ("dk", "dv"):
            acc = xs[0].new_zeros(b, HEADS, t, DIM_HEAD)
            for ((_, _, k_lo, k_hi), _), x in zip(parts, xs):
                acc[:, :, k_lo:k_hi] += x
            whole[name] = acc
        elif name in ("dk_bos", "dv_bos", "dth", "dbias"):
            whole[name] = torch.stack(xs).sum(0)
        else:
            whole[name] = torch.cat(xs, dim=2)
    return whole


def cp_kernels(knda):
    """(a) B1-B3 over each virtual shard's query window (its own tokens
    over a key buffer that adds its lookback halo, ``q_lo`` and ``tok0``)
    against their windowed plain versions, at context 2 and 4 (the last
    shard ragged; at context 4 and dilation 2 the halo spans 3 ranks), the
    fmap-32 and fmap-16 training shapes, dilations 1 and 2, fp32 and bf16,
    with and without dropout 0.1: errors over each reference's max abs as
    check_nda_cases holds them. (b) In fp32 the shards' kernel outputs
    reassembled (reassembled) against one unsharded launch of each kernel:
    every output within fp32's tolerance of its max abs, and with dropout
    the dropped pairs (mix == 0) equal. Returns the largest absolute error
    of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 95)
    worst_abs = dict.fromkeys(("fwd", "bwd_q", "bwd_kv"), 0.0)
    worst_rel, worst_whole, shards, masks = {}, 0.0, 0, 0
    for (shape, (fmap, t)), dil, (dtype, rate) in itertools.product(
            CP_SHAPES.items(), CP_DILATIONS, CP_RUNS):
        args, g = nda_inputs(TRAIN_BATCH, t, dtype, True, gen, TRAIN_KERNEL)
        kw = dict(fmap=fmap, kernel=TRAIN_KERNEL, dilation=(dil,) * 3,
                  dropout=(rate, SEED + 96) if rate else None)
        whole = (dict(zip(CP_NAMES, kernel_chain(knda, args, g, kw, kw)))
                 if dtype == torch.float32 else None)
        for size in CP_CONTEXTS:
            parts = []
            for (lo, hi), (k_lo, k_hi) in cp_layout(t, fmap, size, dil):
                a, gs, win, kv_win = shard_args(args, g, kw, lo, hi, k_lo, k_hi)
                out, lse = knda.sparse_3dna_fwd(*a, **win)
                ref, ref_lse = knda.sparse_3dna_fwd_plain(*a, **win)
                got = knda.sparse_3dna_bwd_q(*a, gs, ref_lse, **win)
                want = knda.sparse_3dna_bwd_q_plain(*a, gs, ref_lse, **win)
                got += knda.sparse_3dna_bwd_kv(a[0], gs, *want[1:3], **kv_win)
                want += knda.sparse_3dna_bwd_kv_plain(a[0], gs, *want[1:3], **kv_win)
                for name, x, w in zip(CP_NAMES, (out, lse, *got), (ref, ref_lse, *want)):
                    err = (x.float() - w.float()).abs().max().item()
                    rel = err / max(1.0, w.float().abs().max().item())
                    tol = TOL[dtype if name in ROUNDED else torch.float32]
                    if x.shape != w.shape or not rel <= tol:
                        fail(f"windowed {name} {shape} dilation {dil} {dtype} rate {rate} "
                             f"context {size} shard [{lo}, {hi}) keys [{k_lo}, {k_hi}): "
                             f"{tuple(x.shape)} against {tuple(w.shape)}, error {rel} of the "
                             f"max abs > {tol}")
                    kname = CP_KERNEL_OF.get(name, "bwd_q")
                    worst_abs[kname] = max(worst_abs[kname], err)
                    key = (kname, dtype, name in ROUNDED)
                    worst_rel[key] = max(worst_rel.get(key, 0.0), rel)
                shards += 1
                if whole is not None:
                    parts.append(((lo, hi, k_lo, k_hi), kernel_chain(knda, a, gs, win, kv_win)))
            if whole is None:
                continue
            got = reassembled(parts, TRAIN_BATCH, t)
            for name in CP_NAMES:
                w = whole[name]
                rel = ((got[name] - w).abs().max() / w.abs().max().clamp(min=1.0)).item()
                if not rel <= TOL[torch.float32]:
                    fail(f"reassembled {name} {shape} dilation {dil} rate {rate} context "
                         f"{size}: error {rel} of the max abs against the unsharded launch")
                worst_whole = max(worst_whole, rel)
            if rate:
                if not torch.equal(got["mix"] == 0, whole["mix"] == 0):
                    fail(f"{shape} dilation {dil} context {size}: the shards' dropout masks "
                         "are not the unsharded launch's")
                masks += 1
        del args, g, whole
    torch.cuda.synchronize()
    for (kname, dtype, rounded), rel in sorted(worst_rel.items(), key=str):
        which = f"outputs in {dtype}" if rounded else "fp32 outputs"
        print(f"windowed sparse_3dna_{kname} vs its windowed plain version, {dtype} inputs, "
              f"{which}: max error {rel:.3e} of the reference's max abs (tolerance "
              f"{TOL[dtype if rounded else torch.float32]:.0e})", flush=True)
    print(f"query windows: {shards} shards (contexts {CP_CONTEXTS}, {list(CP_SHAPES)}, "
          f"dilations {CP_DILATIONS}, fp32 and bf16, dropout 0 and {DROP_RATE}); fp32 "
          f"shards reassembled against one unsharded launch of each kernel: max error "
          f"{worst_whole:.3e} of the max abs (tolerance {TOL[torch.float32]:.0e}), the "
          f"dropout masks equal in {masks} of {masks} runs", flush=True)
    return worst_abs


def time_cp_kernels(knda, rb_rows):
    """B1-B3 of each shard at context 2 and 4 at the fmap-32 training
    shape, dilation 2, bf16 (CUDA-graph replay, device_ms), each beside the
    unsharded kernel's time (``rb_rows``) and its own bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 97)
    fmap, t = CP_SHAPES["fmap 32"]
    dil, dtype = 2, torch.bfloat16
    args, g = nda_inputs(TRAIN_BATCH, t, dtype, True, gen, TRAIN_KERNEL)
    kw = dict(fmap=fmap, kernel=TRAIN_KERNEL, dilation=(dil,) * 3)
    whole = {r["name"]: r["ms"] for r in rb_rows if r["dilation"] == dil}
    rows = []
    for size in CP_CONTEXTS:
        for rank, ((lo, hi), (k_lo, k_hi)) in enumerate(cp_layout(t, fmap, size, dil)):
            a, gs, win, kv_win = shard_args(args, g, kw, lo, hi, k_lo, k_hi)
            _, lse = knda.sparse_3dna_fwd(*a, **win)
            _, ds, mix, *_ = knda.sparse_3dna_bwd_q(*a, gs, lse, **win)
            bounds = nda_bounds(knda, TRAIN_BATCH, hi - lo, dil, dtype, True, fmap, TRAIN_KERNEL,
                                keys=k_hi - k_lo, q_lo=lo - k_lo)
            for name, call in (
                ("fwd", lambda: knda.sparse_3dna_fwd(*a, **win)),
                ("bwd_q", lambda: knda.sparse_3dna_bwd_q(*a, gs, lse, **win)),
                ("bwd_kv", lambda: knda.sparse_3dna_bwd_kv(a[0], gs, ds, mix, **kv_win)),
            ):
                ms = device_ms(call)
                bound, by = bounds[name]
                rows.append(dict(name=name, context=size, rank=rank, queries=hi - lo,
                                 keys=k_hi - k_lo, ms=ms, bound_ms=bound, bound_by=by,
                                 of_unsharded=ms / whole[name]))
                print(f"sparse_3dna_{name} bf16 context {size} rank {rank}: {hi - lo} queries "
                      f"over {k_hi - k_lo} keys, {ms:.4f} ms (device) against the unsharded "
                      f"{whole[name]:.4f} ms ({ms / whole[name]:.3f} of it), bound "
                      f"{bound:.5f} ms ({by})", flush=True)
    return rows


def one_rank_trainer_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally, label,
                         make_mesh_fn, steps, **options):
    """NUWATrainer(**options) at 128 px (train_128's model and batch, bf16)
    on a one-rank NCCL group's mesh (``make_mesh_fn()``) against the
    unmeshed trainer on a copy of one seeded model, ``steps`` steps each in
    turns (the step-0 sample left out), each step's launches checked: the
    losses and the parameters bit-equal. Returns the meshed steps'
    launches."""
    import copy

    import torch.distributed as dist

    depth = NUWA128["dec_depth"]
    per_step = {"fwd": 2 * depth, "bwd_q": depth, "bwd_kv": depth}
    text = nuwa128_text(tokenizer, NUWA128_BATCH).numpy()
    video = moving_squares(NUWA128_BATCH, NUWA128["max_video_frames"], SIZE128,
                           np.random.default_rng(SEED + 98))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh_fn()
        model = nuwa128_model(NUWA, VQGanVAE)
        runs, launches = {}, collections.Counter()
        for name, m in (("unmeshed", None), (label, mesh)):
            t = NUWATrainer(nuwa=copy.deepcopy(model), dataset=list(zip(text, video)),
                            num_train_steps=10**9, lr=3e-4, wd=0.01, batch_size=NUWA128_BATCH,
                            grad_accum_every=1, max_grad_norm=0.5, cond_dropout_prob=0.2,
                            seed=SEED, mesh=m, **(options if m is not None else {}))
            t._sample = lambda *a: None
            runs[name] = (t, [], [])
        del model
        for i in range(steps):
            for name in ("unmeshed", label)[::1 if i % 2 == 0 else -1]:
                t, losses, ms = runs[name]
                logs, step_ms, got = counted(f"128 px {name} train step {i}", knda, tally,
                                             t.train_step, per_step)
                losses.append(logs["loss"])
                ms.append(step_ms)
                if t.mesh is not None:
                    launches.update(got)
        (plain, want, plain_ms), (meshed, losses, ms) = runs["unmeshed"], runs[label]
        equal = losses == want and all(torch.equal(a, b) for a, b in zip(
            meshed.nuwa.parameters(), plain.nuwa.parameters(), strict=True))
        sizes = ", ".join(f"{n} {k}" for n, k in zip(mesh.mesh_dim_names, mesh.shape))
        shown = ", ".join(f"{k}={v}" for k, v in options.items())
        print(f"128 px NUWATrainer({shown}), mesh ({sizes}) over NCCL, "
              f"{steps} steps in turns: losses {', '.join(f'{x:.6f}' for x in losses)} "
              f"against {', '.join(f'{x:.6f}' for x in want)} unmeshed, parameters "
              f"{'bit-equal' if equal else 'NOT bit-equal'}; step ms "
              f"{', '.join(f'{x:.1f}' for x in ms)} against "
              f"{', '.join(f'{x:.1f}' for x in plain_ms)}", flush=True)
        if not equal:
            fail(f"the {label} trainer at one rank is not the unmeshed one bit for bit")
        del runs, plain, meshed
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches


def cp_train_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally):
    """NUWATrainer(context_parallel=True) on make_mesh(data=1, model=1), the
    frames over 'data', against the unmeshed trainer (one_rank_trainer_128)."""
    from nuwa_tpu_torch.parallel import make_mesh

    return one_rank_trainer_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally,
                                "context parallel",
                                lambda: make_mesh(data=1, model=1, device="cuda"), CP_STEPS,
                                context_parallel=True)


def cp_phase(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally, rb_rows):
    """Phase 19: the query window of B1-B3 (cp_kernels, time_cp_kernels) and
    the context-parallel trainer at one rank (cp_train_128). Returns (each
    kernel's largest error, the timed shards, the trainer's launches)."""
    start = time.perf_counter()
    errs = cp_kernels(knda)
    rows = time_cp_kernels(knda, rb_rows)
    print(f"  (the windows: {time.perf_counter() - start:.1f} s into the phase)", flush=True)
    launches = cp_train_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally)
    print(f"  (the trainers: {time.perf_counter() - start:.1f} s into the phase)", flush=True)
    return errs, rows, launches



# ---------------------------------------------------------------------------
# pipeline parallelism: the stage body on one card
# ---------------------------------------------------------------------------

PP_STAGES, PP_MICROBATCHES, PP_STEPS = 2, 2, 2
# config 5's dual decoder at the least depth that splits into 2 statically
# identical stages: 2 x lcm(xmod every 3, dilations (1, 2)) (CHECK_DEPTH does not)
PP_DUAL_DEPTH = 12


def pp_inputs(dim, shapes, dtype, seed):
    """Seeded stream(s) and loss weights of ``shapes`` and a text context of
    b = 2 (32 tokens, the second row's last 12 masked) on the card."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    streams = [rnd(NUWA128_BATCH, n, dim) for n in shapes]
    weights = [rnd(NUWA128_BATCH, n, dim).float() for n in shapes]
    cmask = torch.ones(NUWA128_BATCH, 32, dtype=torch.bool, device="cuda")
    cmask[1, 20:] = False
    return streams, weights, rnd(NUWA128_BATCH, 32, dim), cmask


def pp_step(knda, stack, streams, weights, ctx, cmask, seed, chained):
    """One forward and backward of ``stack`` (a NUWA decoder or a dual
    decoder) on the streams, unpipelined or as PP_STAGES stages of
    PP_MICROBATCHES microbatches chained in this process
    (parallel.pipeline.chained_*, each rank's stage function and schedule):
    the outputs, {name: gradient} of the parameters and the inputs, and the
    launches, the counts set to 0 just before and read just after."""
    from nuwa_tpu_torch.parallel import pipeline

    streams = [x.detach().requires_grad_() for x in streams]
    ctx = ctx.detach().requires_grad_()
    kw = dict(context=ctx, context_mask=cmask, seed=seed)
    reset_launches(knda)
    dual = len(streams) == 2
    if chained:
        run = pipeline.chained_dual_decoder if dual else pipeline.chained_transformer
        outs = run(stack, *streams, PP_STAGES, num_microbatches=PP_MICROBATCHES, **kw)
    else:
        outs = stack(*streams, **kw)
    outs = outs if dual else (outs,)
    sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
    torch.cuda.synchronize()
    launches = launch_counts(knda)
    grads = {n: p.grad.float() for n, p in stack.named_parameters()}
    grads.update({f"input {i}": x.grad.float() for i, x in enumerate(streams)})
    grads["context"] = ctx.grad.float()
    stack.zero_grad(set_to_none=True)
    return [o.detach().float() for o in outs], grads, launches


def pp_compare(label, knda, stack, streams, weights, ctx, cmask, seed, tol, fp32=None):
    """The chained stages against the unpipelined stack: the outputs within
    ``tol`` (absolute, or of the reference's max abs in bf16), every
    gradient within ``GRAD_REL`` of its max abs and the chained launches
    PP_MICROBATCHES x the unpipelined ones. In bf16 the reversible
    backward's rebuilt activations make each run's gradients differ from
    the fp32 ones (``fp32``: the fp32 unpipelined gradients of the same
    weights and inputs) by far more than ``tol``, and by different amounts
    at another batch split; there each chained gradient must be no farther
    from the fp32 one than twice the unpipelined bf16 gradient is, plus
    ``tol``. Returns (both runs' launches, the unpipelined gradients)."""
    runs = [pp_step(knda, stack, streams, weights, ctx, cmask, seed, chained)
            for chained in (False, True)]
    (want, g_want, l_want), (got, g_got, l_got) = runs
    out_err = max((g - w).abs().max().item() / (w.abs().max().item() if fp32 else 1.0)
                  for g, w in zip(got, want))

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    if fp32 is None:
        worst, where = max((rel(g_got[n], ref), n) for n, ref in g_want.items())
        grads = (f"{len(g_want)} gradients, largest error {worst:.3e} of the gradient's max "
                 f"abs at {where} (tolerance {GRAD_REL:.0e})")
        ok = worst <= GRAD_REL
    else:
        excess, where = max((rel(g_got[n], ref) - 2 * rel(g_want[n], ref), n)
                            for n, ref in fp32.items())
        chained = max(rel(g_got[n], ref) for n, ref in fp32.items())
        plain = max(rel(g_want[n], ref) for n, ref in fp32.items())
        grads = (f"{len(g_want)} gradients against the fp32 ones: largest error {chained:.3e} "
                 f"of the max abs chained, {plain:.3e} unpipelined; chained less twice "
                 f"unpipelined at most {excess:.3e} (at {where}; tolerance {tol:.0e})")
        ok = excess <= tol
    kernels = {k: v for k, v in l_want.items() if v}
    print(f"{label}: {PP_STAGES} stages x {PP_MICROBATCHES} microbatches chained against the "
          f"unpipelined stack: output error {out_err:.3e} (tolerance {tol:.0e}"
          f"{' of its max abs' if fp32 else ''}); {grads}; launches "
          f"{({k: l_got[k] for k in kernels})} against {kernels} unpipelined", flush=True)
    if not (out_err <= tol and ok):
        fail(f"{label}: the chained stages are not the unpipelined stack")
    if not kernels or l_got != {k: PP_MICROBATCHES * v for k, v in l_want.items()}:
        fail(f"{label}: chained launches {l_got}, expected {PP_MICROBATCHES} x {l_want}")
    return (l_want, l_got), g_want


def pp_stage_bytes(stack):
    """Each stage's parameter and AdamW moment bytes beside the whole
    stack's: an optimizer over each stage's parameters (and one over all)
    takes a step on zero gradients, and its state is counted."""
    from nuwa_tpu_torch.parallel.pipeline import stage_param_slots
    from nuwa_tpu_torch.train.optimizer import get_optimizer

    L = stage_param_slots(stack, PP_STAGES)
    groups = [[p for layer in stack.layers[s * L:(s + 1) * L] for p in layer.parameters()]
              for s in range(PP_STAGES)]
    rows = []
    for params in (*groups, [p for g in groups for p in g]):
        opt = get_optimizer(params, lr=3e-4, wd=0.01)
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.step()
        moments = sum(v.numel() * v.element_size() for st in opt.state.values()
                      for k, v in st.items() if k != "step")
        rows.append((sum(p.numel() * p.element_size() for p in params), moments))
        stack.zero_grad(set_to_none=True)
        del opt
    *stages, (whole_p, whole_m) = rows
    for s, (p_bytes, m_bytes) in enumerate(stages):
        print(f"pipeline stage {s} of {PP_STAGES}: {p_bytes / 2**20:.2f} MiB of parameters "
              f"({p_bytes / whole_p:.4f} of the stack's {whole_p / 2**20:.2f} MiB), "
              f"{m_bytes / 2**20:.2f} MiB of AdamW moments ({m_bytes / whole_m:.4f} of "
              f"{whole_m / 2**20:.2f} MiB)", flush=True)
        if p_bytes * PP_STAGES != whole_p or m_bytes * PP_STAGES != whole_m:
            fail(f"pipeline stage {s} does not hold 1/{PP_STAGES} of the stack")
    return {"stage_param_bytes": [p for p, _ in stages], "stage_moment_bytes":
            [m for _, m in stages], "stack_param_bytes": whole_p, "stack_moment_bytes": whole_m}


def pp_phase(NUWA, NUWAVideoAudio, VQGanVAE, NUWATrainer, tokenizer, knda, tally):
    """Phase 20: (a) the stage body at full width, stages chained in one
    process, against the unpipelined decoder: phase 8's 128-px reversible
    decoder (fp32 without and with dropout DROP_RATE, bf16), its plain
    (dec_reversible=False) stack (fp32), config 5's reversible dual decoder
    (the quad carry, the audio geometry, fp32, PP_DUAL_DEPTH); each stage's
    parameter and moment bytes; the chained step's CUDA-event ms beside the
    unpipelined one's (bf16). (b) NUWATrainer(pipeline_parallel=True,
    pipeline_microbatches=2) on a one-rank NCCL ('data', 'pipe') mesh
    against the unmeshed trainer. Returns {"chained": {run: (unpipelined,
    chained launches)}, "ms", "kernel_ms": {chained: ms}, "bytes", "trainer":
    launches}."""
    from torch.distributed.device_mesh import init_device_mesh

    start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    shapes = (T128 + 1,)  # bos and the 10,239 shifted video tokens
    out, fp32 = {"chained": {}}, None
    for label, dtype, rev, dropout, tol in (
            ("128 px reversible decoder, fp32", None, True, 0.0, LOGITS_ATOL),
            (f"128 px reversible decoder, fp32, dropout {DROP_RATE}", None, True, DROP_RATE,
             LOGITS_ATOL),
            ("128 px reversible decoder, bf16", "bfloat16", True, 0.0, TOL[torch.bfloat16]),
            ("128 px plain decoder, fp32", None, False, 0.0, LOGITS_ATOL)):
        # the same weights and inputs in every run (the bf16 inputs rounded)
        model = nuwa128_model(NUWA, VQGanVAE, dtype=dtype, seed=SEED + 120, dec_reversible=rev,
                              attn_dropout=dropout, ff_dropout=dropout)
        stack = model.video_transformer
        torch_dtype = torch.bfloat16 if dtype else torch.float32
        streams, weights, ctx, cmask = pp_inputs(NUWA128["dim"], shapes, torch_dtype,
                                                 SEED + 121)
        seed = 1234 if dropout else None
        out["chained"][label], grads = pp_compare(label, knda, stack, streams, weights, ctx,
                                                  cmask, seed, tol, fp32 if dtype else None)
        fp32 = grads if fp32 is None else fp32
        if dtype:
            times = {chained: cuda_ms(lambda c=chained: pp_step(
                knda, stack, streams, weights, ctx, cmask, None, c), iters=1, reps=3, warmup=1)
                     for chained in (False, True)}
            print(f"128 px reversible decoder bf16 forward and backward (b = {NUWA128_BATCH}, "
                  f"{shapes[0]} tokens): chained {times[True]:.1f} ms against unpipelined "
                  f"{times[False]:.1f} ms ({times[True] / times[False]:.3f} of it; CUDA events, "
                  f"{smi})", flush=True)
            busy = {chained: share(lambda c=chained: pp_step(
                knda, stack, streams, weights, ctx, cmask, None, c),
                f"{'chained' if chained else 'unpipelined'} bf16 step", wall=times[chained])
                for chained in (False, True)}
            if None not in busy.values():
                print(f"kernel time of the chained step {busy[True] / busy[False]:.3f} of the "
                      f"unpipelined one's", flush=True)
            out["ms"] = times
            out["kernel_ms"] = busy
            out["bytes"] = pp_stage_bytes(stack)
        del model, stack
        torch.cuda.empty_cache()
    model = dual_model(NUWAVideoAudio, VQGanVAE, dict(DUAL, dec_depth=PP_DUAL_DEPTH), DUAL_VAE,
                       dtype=None, seed=SEED + 122)
    fmap = DUAL["image_size"] // 2 ** DUAL_VAE["num_layers"]
    frames = DUAL["max_video_frames"]
    dual_shapes = (frames * fmap**2, frames * DUAL["num_audio_tokens_per_video_frame"])
    streams, weights, ctx, cmask = pp_inputs(DUAL["dim"], dual_shapes, torch.float32,
                                             SEED + 123)
    label = f"config 5 reversible dual decoder, depth {PP_DUAL_DEPTH}, fp32"
    out["chained"][label], _ = pp_compare(label, knda, model.video_audio_transformer, streams,
                                          weights, ctx, cmask, None, LOGITS_ATOL)
    del model, fp32
    torch.cuda.empty_cache()
    print(f"  (the chained stages: {time.perf_counter() - start:.1f} s into the phase)",
          flush=True)
    out["trainer"] = one_rank_trainer_128(
        NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, tally, "pipeline parallel",
        lambda: init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "pipe")), PP_STEPS,
        pipeline_parallel=True, pipeline_microbatches=PP_MICROBATCHES)
    print(f"  (the trainers: {time.perf_counter() - start:.1f} s into the phase)", flush=True)
    print(smi, flush=True)
    return out

def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    from nuwa_tpu_torch import NUWA, NUWASketch, NUWAVideoAudio, VQGanVAE, tokenizer
    from nuwa_tpu_torch.kernels import build
    from nuwa_tpu_torch.kernels import cross as kcross
    from nuwa_tpu_torch.kernels import nda as knda
    from nuwa_tpu_torch.train import NUWATrainer, VQGanVAETrainer

    # fp32 matmuls in full fp32 (no TF32) for every fp32 comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    # the CPU sides of the GPU-vs-CPU checks, in the order the checks read them
    refs = CpuRefs()
    text128 = nuwa128_text(tokenizer, 1)
    for key, fn, *args in (
            ("serving", serving_side, "cpu"), ("train", train_side, "cpu"),
            ("sketch", sketch_side, "cpu"),
            (("sketch train", 0.0), sketch_train_side, "cpu", 0.0),
            ("128 px", nuwa128_side, "cpu", text128),
            (("128 px train", 0.0), train_128_side, "cpu", text128, 0.0),
            ("dual", dual_side, "cpu"),
            (("dual train", 0.0), dual_train_side, "cpu", 0.0, True),
            (("128 px train", DROP_RATE), train_128_side, "cpu", text128, DROP_RATE),
            (("dual train", DROP_RATE), dual_train_side, "cpu", DROP_RATE, True),
            (("sketch train", DROP_RATE), sketch_train_side, "cpu", DROP_RATE),
            ("dual full", full_dual_side, "cpu")):
        refs.submit(key, fn, *args)

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    def phase(name):  # seconds since the build started
        print(f"[{time.perf_counter() - t0:.1f} s] {name} done", flush=True)

    fwd_err = check_nda(knda)
    errs = check_bwd(knda)
    check_autograd(knda)
    time_nda(knda)
    train_rows = time_train_kernels(knda)
    # centered mode at the centered sketch encoder's shape (2 frames of fmap
    # 16 less one token, its dilations 1 and 2, no bias), its own bound
    centered_rows = time_train_kernels(knda, fmap=(SKETCH_FMAP,) * 2, t=2 * SKETCH_FMAP**2 - 1,
                                       mode="centered", bias=False, dilations=(1, 2))
    cross_err = check_cross(kcross)
    cross_rows = time_cross(kcross)
    cross_bwd_err = check_cross_bwd(kcross)
    check_cross_autograd(kcross)
    cross_bwd_rows = time_cross_bwd(kcross)
    phase("kernel checks and times")
    model, texts, serve_launches, serve_ms = serve(NUWA, knda)
    refs.submit("int8", int8_side, texts[1], int8_video())
    check_against_cpu(refs)
    phase("NUWA serving")
    train_launches, _ = train(NUWA, NUWATrainer, knda)
    train_against_cpu(refs)
    phase("NUWA training")
    sketch, inputs, cross_launches, sketch_fwd, sketch_ms = serve_sketch(NUWASketch, VQGanVAE,
                                                                         knda)
    sketch_against_cpu(refs)
    phase("NUWASketch serving")
    sketch_train_launches, sketch_train_ms = train_sketch(NUWASketch, VQGanVAE, knda)
    sketch_train_against_cpu(refs)
    phase("NUWASketch training")
    rb_errs = check_rb(knda)
    check_determinism(knda, kcross)
    rb_rows = time_train_kernels(knda, fmap=(FMAP128, FMAP128), t=T128, plain_iters=2)
    phase("Sparse3DNA kernels at fmap 32 and determinism")
    serve128_launches, _ = serve_128(NUWA, VQGanVAE, tokenizer, knda)
    nuwa128_against_cpu(refs, tokenizer)
    phase("NUWA serving at 128 px")
    train128_launches, train128_ms = train_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda)
    train_128_against_cpu(refs, tokenizer)
    phase("NUWA training at 128 px")
    audio_err = check_audio(knda)
    dual_errs = check_dual_video(knda)
    audio_rows = time_audio(knda)
    dual_launches, _ = serve_dual(NUWAVideoAudio, VQGanVAE, knda)
    dual_against_cpu(refs)
    phase("NUWAVideoAudio serving and the audio geometry")
    audio_bwd_err = check_audio_bwd(knda)
    check_audio_autograd(knda)
    audio_bwd_rows = time_audio_bwd(knda)
    dual_train_launches, dual_train = train_dual(NUWAVideoAudio, VQGanVAE, knda)
    dual_train_against_cpu(refs)
    phase("NUWAVideoAudio training and the audio backward")
    drop_rows = dropout_rows(knda)
    drop128_launches, drop128_ms = train_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda,
                                             dropout=DROP_RATE)
    print(f"128 px train step with attn_dropout = ff_dropout = {DROP_RATE}: {drop128_ms:.1f} ms "
          f"against {train128_ms:.1f} ms without ({100 * (drop128_ms / train128_ms - 1):+.1f}%)",
          flush=True)
    train_128_against_cpu(refs, tokenizer, dropout=DROP_RATE)
    drop_dual_launches, drop_dual = train_dual(NUWAVideoAudio, VQGanVAE, knda,
                                               dropout=DROP_RATE)
    print(f"dual train step with attn_dropout = ff_dropout = {DROP_RATE}: "
          f"{drop_dual['ms']:.1f} ms against {dual_train['ms']:.1f} ms without "
          f"({100 * (drop_dual['ms'] / dual_train['ms'] - 1):+.1f}%), peak memory "
          f"{drop_dual['peak_gib']:.2f} against {dual_train['peak_gib']:.2f} GiB", flush=True)
    dual_train_against_cpu(refs, dropout=DROP_RATE)
    drop_sketch_launches, drop_sketch_ms = train_sketch(NUWASketch, VQGanVAE, knda,
                                                        dropout=DROP_RATE)
    for variant, ms in drop_sketch_ms.items():
        base = sketch_train_ms[variant]
        print(f"sketch train step ({variant}) with attn_dropout = ff_dropout = {DROP_RATE}: "
              f"{ms:.1f} ms against {base:.1f} ms without ({100 * (ms / base - 1):+.1f}%)",
              flush=True)
    sketch_train_against_cpu(refs, dropout=DROP_RATE)
    phase("training with attention and feed-forward dropout")
    surface = collections.Counter()  # the surface phases' launches
    dense_causal(knda, surface)
    phase("dense causal decoder (BASELINE config 2)")
    full_nuwa(model, texts, knda, surface)
    full_sketch(NUWASketch, VQGanVAE, knda, surface)
    full_dual(NUWAVideoAudio, VQGanVAE, knda, surface, refs)
    phase('method="full"')
    int8_serving(NUWA, knda, model, texts, surface, refs)
    phase("int8 serving")
    resume_128(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda, surface)
    phase("checkpoint and resume at 128 px")
    throughput(model, serve_ms)
    device_share(model, texts)
    sketch_throughput(sketch, inputs, sketch_ms)
    phase("throughput")
    mesh_phase(NUWA, VQGanVAE, NUWATrainer, VQGanVAETrainer, tokenizer, knda, surface, model,
               texts)
    phase("mesh (NCCL, world size 1), tooling and the token shift along time")
    cp_errs, cp_rows, cp_launches = cp_phase(NUWA, VQGanVAE, NUWATrainer, tokenizer, knda,
                                             surface, rb_rows)
    phase("context parallelism: the query window and the CP trainer")
    pp = pp_phase(NUWA, NUWAVideoAudio, VQGanVAE, NUWATrainer, tokenizer, knda, surface)
    phase("pipeline parallelism: the chained stages and the PP trainer")
    del model, sketch
    torch.cuda.empty_cache()
    train_codec(VQGanVAE, VQGanVAETrainer, knda)
    codec_against_cpu(VQGanVAE)
    codec_resume(VQGanVAE, VQGanVAETrainer)
    phase("codec training (VQGanVAETrainer)")
    refs.close()

    # launches: the NUWA serving run's, the training run's, the sketch
    # serving run's, the sketch training runs', the 128-px runs', the
    # NUWAVideoAudio serving and training runs' (their audio launches under
    # "audio") and the surface phases' (method="full", int8, resume);
    # Sparse3DNA times at the fmap-16 training shape, dilation 2, and under
    # "fmap_32" at the fmap-32 one, where the JAX package runs its
    # row-blocked kernels (rows 4-6 of the table); the cross forward's at the
    # sketch forward shape, the cross backward's at the sketch training
    # shape; no single PyTorch call computes the talking-heads attention or
    # its backward, so library_ms is null
    serve_counts = {"fwd": serve_launches + sketch_fwd + dual_launches["fwd"], "bwd_q": 0,
                    "bwd_kv": 0}
    sketch_train_total = {k: sketch_train_launches[1][k] + sketch_train_launches[2][k]
                          for k in sketch_train_launches[1]}
    drop_sketch_total = {k: drop_sketch_launches[1][k] + drop_sketch_launches[2][k]
                         for k in drop_sketch_launches[1]}
    fmap32_launches = {"fwd": serve128_launches, "bwd_q": 0, "bwd_kv": 0}
    entries = []
    for name, source, line, rb_line, err in (
        ("fwd", "sparse3dna_fwd.cu", 239, 403,
         max(fwd_err, errs["fwd"], rb_errs["fwd"], dual_errs["fwd"])),
        ("bwd_q", "sparse3dna_bwd_q.cu", 865, 580,
         max(errs["bwd_q"], rb_errs["bwd_q"], dual_errs["bwd_q"])),
        ("bwd_kv", "sparse3dna_bwd_kv.cu", 1029, 745,
         max(errs["bwd_kv"], rb_errs["bwd_kv"], dual_errs["bwd_kv"])),
    ):
        row = next(r for r in train_rows if r["name"] == name and r["dilation"] == 2)
        rb_row = next(r for r in rb_rows if r["name"] == name and r["dilation"] == 2)
        rb_launches = fmap32_launches[name] + train128_launches[name]
        entries.append({
            "name": f"sparse_3dna_{name}", "route": "cuda",
            "source": f"nuwa_tpu_torch/kernels/csrc/{source}",
            "replaces": f"nuwa_tpu/kernels/nda_pallas.py:{line}",
            "launches": (serve_counts[name] + train_launches[name] + sketch_train_total[name]
                         + rb_launches + dual_train_launches[name] + drop128_launches[name]
                         + drop_dual_launches[name] + drop_sketch_total[name]
                         + surface[name]),
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            # causal windows (the video decoder), centered ones (the sketch encoder)
            "modes": "causal, centered and audio, with and without attention dropout",
            "centered_launches": (sketch_train_total[f"{name}_centered"]
                                  + surface[f"{name}_centered"]),
            # frames past 256 tokens: the row-blocked TPU kernel's shapes
            "fmap_32": {
                "replaces": f"nuwa_tpu/kernels/nda_pallas.py:{rb_line}", "b": TRAIN_BATCH,
                "t": T128, "launches": rb_launches, "max_abs_err": rb_errs[name],
                **{k: rb_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": None,
            },
        })
        # centered mode at the sketch encoder's shape, dilation 1
        c_row = next(r for r in centered_rows if r["name"] == name and r["dilation"] == 1)
        entries[-1]["centered"] = {
            "b": TRAIN_BATCH, "t": 2 * SKETCH_FMAP**2 - 1,
            **{k: c_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
        if "backward_bound_ms" in row:  # the bound of B2 and B3 together
            entries[-1]["backward_bound_ms"] = row["backward_bound_ms"]
            entries[-1]["fmap_32"]["backward_bound_ms"] = rb_row["backward_bound_ms"]
            entries[-1]["centered"]["backward_bound_ms"] = c_row["backward_bound_ms"]
        # phase 19: the CP trainer's launches (counted in "launches" too), the
        # windowed kernel against its windowed plain version, each shard's
        # time at the fmap-32 shape, dilation 2, beside the unsharded one
        entries[-1]["context_parallel"] = {
            "launches": cp_launches[name], "max_abs_err": cp_errs[name],
            "unsharded_ms": rb_row["ms"],
            "shards": [{k: r[k] for k in ("context", "rank", "queries", "keys", "ms", "bound_ms",
                                          "bound_by", "of_unsharded")}
                       for r in cp_rows if r["name"] == name],
        }
        # phase 20: the PP trainer's launches (counted in "launches" too), and
        # the chained stages' launches beside the unpipelined decoder's
        entries[-1]["pipeline_parallel"] = {
            "trainer_launches": pp["trainer"][name],
            # the bf16 128-px reversible decoder's forward and backward
            "chained_ms": pp["ms"][True], "unpipelined_ms": pp["ms"][False],
            "chained_kernel_ms": pp["kernel_ms"][True],
            "unpipelined_kernel_ms": pp["kernel_ms"][False], **pp["bytes"],
            "chained": {label: {"launches": got[name], "unpipelined_launches": want[name]}
                        for label, (want, got) in pp["chained"].items()},
        }
    # the audio geometry of SparseCausal2DNA (TPU kernels 1-3 through
    # _audio_core_op, 4-6 through _audio_rb_core_op): the forward at the
    # depth-64 forward's shape (H = 4) and, under "at_h1", the generate_long
    # prefill's (H = 1); the backward kernels at the depth-64 train step's
    # (H = 4) and, under "at_h1", at H = 1
    timed_keys = ("b", "t", "ms", "plain_ms", "bound_ms", "bound_by")
    fwd_audio = audio_rows["forward, H=4"]
    entries[0]["audio"] = {
        "replaces": "nuwa_tpu/kernels/nda_pallas.py:2251 and :2455",
        "launches": (dual_launches["fwd_audio"] + dual_train_launches["fwd_audio"]
                     + surface["fwd_audio"]),
        "max_abs_err": max(audio_err, *(r["max_abs_err"] for r in audio_rows.values())),
        **{k: fwd_audio[k] for k in timed_keys},
        "library_ms": None,
        "at_h1": {k: audio_rows["generate_long prefill, H=1"][k] for k in timed_keys},
    }
    for entry, name in zip(entries[1:3], ("bwd_q", "bwd_kv")):
        row, row1 = audio_bwd_rows[name, "train step, H=4"], audio_bwd_rows[name, "H=1"]
        entry["audio"] = {
            "replaces": "nuwa_tpu/kernels/nda_pallas.py:2251 and :2455",
            "launches": dual_train_launches[f"{name}_audio"],
            "max_abs_err": max(audio_bwd_err[name], row["max_abs_err"], row1["max_abs_err"]),
            **{k: row[k] for k in timed_keys}, "library_ms": None,
            "backward_bound_ms": row["backward_bound_ms"],
            "at_h1": {k: row1[k] for k in (*timed_keys, "backward_bound_ms")},
        }
    # attention dropout (the training runs with attn_dropout = ff_dropout =
    # DROP_RATE): its launches there, the times at the fmap-16 training shape
    # and under "shapes" at each of DROPOUT_SHAPES, each beside the time
    # without dropout
    timed_keys = ("ms", "no_dropout_ms", "plain_ms", "bound_ms", "bound_by")
    for entry, name in zip(entries[:3], ("fwd", "bwd_q", "bwd_kv")):
        row = drop_rows[name, "causal, fmap 16"]
        entry["dropout"] = {
            "rate": DROP_RATE,
            "launches": (drop128_launches[f"{name}_dropout"]
                         + drop_dual_launches[f"{name}_dropout"]
                         + drop_sketch_total[f"{name}_dropout"]),
            "max_abs_err": max(drop_rows[name, shape]["max_abs_err"]
                               for shape in DROPOUT_SHAPES),
            **{k: row[k] for k in timed_keys}, "library_ms": None,
            "shapes": {shape: {k: drop_rows[name, shape][k]
                               for k in ("b", "t", "max_abs_err", *timed_keys)}
                       for shape in DROPOUT_SHAPES},
        }
    # the cross kernels' dropout (the sketch training runs with attn_dropout =
    # ff_dropout = DROP_RATE): its launches there, the times at the entry's
    # own shape and under "shapes" at the others of CROSS_DROPOUT_SHAPES
    def cross_dropout(kname, timed_at, shapes, launches):
        return {
            "rate": DROP_RATE, "launches": launches,
            "max_abs_err": max(drop_rows[kname, shape]["max_abs_err"] for shape in shapes),
            **{k: drop_rows[kname, timed_at][k] for k in timed_keys}, "library_ms": None,
            "shapes": {shape: {k: drop_rows[kname, shape][k]
                               for k in ("b", "t", "context_frames", "max_abs_err",
                                         *timed_keys)}
                       for shape in shapes},
        }

    # one CUDA kernel replaces both fused TPU kernels: at two context frames
    # (_xfused_kernel) and at one (_xfused1_kernel)
    for frames, line in ((2, 2731), (1, 2810)):
        row = cross_rows[frames]
        lc = f"Lc {frames * SKETCH_FMAP**2}"
        entries.append({
            "name": "sparse_cross_2dna_fwd", "context_frames": frames, "route": "cuda",
            "source": "nuwa_tpu_torch/kernels/csrc/sparse_cross2dna_fwd.cu",
            "replaces": f"nuwa_tpu/kernels/nda_pallas.py:{line}",
            # the surface phases' cross launches are all at two context frames
            "launches": (cross_launches[frames] + sketch_train_launches[frames]["cross"]
                         + drop_sketch_launches[frames]["cross"]
                         + (surface["cross"] if frames == 2 else 0)),
            "max_abs_err": cross_err[frames],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "tiles": row["tiles"],
            "dropout": cross_dropout("cross", f"forward, {lc}", (f"forward, {lc}",
                                                                 f"train, {lc}"),
                                     drop_sketch_launches[frames]["cross_dropout"]),
        })
    # two CUDA kernels replace the fused cross backward; times at Lc 256
    # (model (a), one context frame), and at Lc 512 (model (b)) beside them
    for name, source in (("bwd_q", "sparse_cross2dna_bwd_q.cu"),
                         ("bwd_kv", "sparse_cross2dna_bwd_kv.cu")):
        row, row2 = cross_bwd_rows[name, 1], cross_bwd_rows[name, 2]
        entries.append({
            "name": f"sparse_cross_2dna_{name}", "route": "cuda",
            "source": f"nuwa_tpu_torch/kernels/csrc/{source}",
            "replaces": "nuwa_tpu/kernels/nda_pallas.py:2879",
            "launches": sketch_train_total[f"cross_{name}"] + drop_sketch_total[f"cross_{name}"],
            "max_abs_err": cross_bwd_err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "context_frames": 1, "backward_bound_ms": row["backward_bound_ms"],
            "tiles": row["tiles"],
            "at_context_frames_2": {k: row2[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "backward_bound_ms", "tiles")},
            "dropout": cross_dropout(f"cross_{name}", "train, Lc 256", CROSS_DROPOUT_SHAPES,
                                     drop_sketch_total[f"cross_{name}_dropout"]),
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
