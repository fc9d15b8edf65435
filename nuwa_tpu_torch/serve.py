"""Serving example: batched, cached text-to-video generation on one device,
optionally with int8 weight-only projections and logits head.

    python -m nuwa_tpu_torch.serve [--batch 8] [--int8] [--frames 4]

The port's counterpart of ``scripts/serve_example.py`` without its mesh:
the NUWA of that script (dim 512, fmap 8, depth 6, 8 heads of 64, a text
encoder of depth 2, bf16 activations) with random weights from seed 0,
captions through the port's tokenizer, classifier-free guidance 2.0 as a
doubled batch, and the cached decoder. ``--int8`` quantises the model with
``utils.quantize.quantize_int8_`` first. One warm request, then one timed;
the last line of output is JSON with the tokens/s, the time of the request
and, on a GPU, the peak memory. ``--device cpu`` runs the plain PyTorch
path on the CPU (slow at this width).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .models import NUWA
from .ops.utils import resolve_device
from .tokenizer import tokenizer
from .utils.quantize import quantize_int8_

PROMPT = "a red square moving right"


def build(*, dim=512, depth=6, frames=4, int8=False, device=None, seed=0):
    """The serving model of ``scripts/serve_example.py``, quantised with
    ``int8``."""
    model = NUWA(
        dim=dim, image_size=8, num_image_tokens=1024, max_video_frames=frames,
        text_num_tokens=tokenizer.vocab_size, text_max_seq_len=32, text_enc_depth=2,
        text_enc_dim_head=64, text_enc_heads=8, dec_depth=depth, dec_dim_head=64,
        dec_heads=8, sparse_3dna_kernel_size=3, sparse_3dna_dilation=2,
        shift_video_tokens=True, compute_dtype="bfloat16", device=device, seed=seed,
    )
    return quantize_int8_(model) if int8 else model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model, batch, *, seed=1):
    """One warm and one timed cached ``generate`` of ``batch`` captions;
    returns (token ids, the timed request's seconds)."""
    text = tokenizer.tokenize([PROMPT] * batch, context_length=32)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    model.generate(text, generator=gen, decode_video=False, cond_scale=2.0)
    _sync(model.device)
    start = time.perf_counter()
    ids = model.generate(text, generator=gen, decode_video=False, cond_scale=2.0)
    _sync(model.device)
    return ids, time.perf_counter() - start


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build(frames=args.frames, int8=args.int8, device=device)
    ids, seconds = serve(model, args.batch)
    tokens = ids.numel()
    out = {"batch": args.batch, "int8": args.int8, "device": str(device), "tokens": tokens,
           "seconds": seconds, "tokens_per_sec": tokens / seconds,
           "sample_shape": list(ids.shape)}
    if device.type == "cuda":
        out["gpu"] = torch.cuda.get_device_name(device)
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
