"""Attention and feed-forward dropout through NUWAVideoAudio's decoders, fp32
on the CPU: every recompute of a training step draws the forward's masks.

The tiny configuration of test_torch_video_audio.py (a two-layer codec on
8-pixel frames, dim 16, 2 heads of 8, 2 frames of 4 video tokens and 3
audio tokens, a text encoder of depth 1, a decoder of depth 2 with one
``xmod`` block) with ``attn_dropout = ff_dropout = 0.1``, so every module
of the schedule drops (Sparse3DNA, SparseCausal2DNA, the dense attention,
CrossModalityCrossAttention before its talking-heads mix, every
feed-forward), from token ids with one seed drawn from the same generator:

  * the reversible dual decoder (H = 2), whose backward rebuilds every
    activation and re-runs each module with its seed, against the same model
    under plain autograd (``reverse=False``): the loss within 1e-5 and every
    gradient within 1e-4 of its max abs (the subtraction's rounding);
  * the plain dual decoder (H = 1) with ``dec_remat``, which recomputes each
    block in the backward (``torch.utils.checkpoint``), against the same
    model without it: the loss and every gradient bit for bit;
  * in both, the loss differs from the loss without dropout.
"""
import functools

import numpy as np
import pytest
import torch

from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE

import test_torch_video_audio as base

torch.set_num_threads(1)
REL = 1e-4
VIDEO = np.random.default_rng(3).integers(0, 16, (2, 2 * 4))


def _model(name):
    cfg = dict(base.CFG, **base.CONFIGS[name], attn_dropout=0.1, ff_dropout=0.1)
    return NUWAVideoAudio(vae=VQGanVAE(**base.VAE, device="cpu", seed=1), **cfg,
                          device="cpu", seed=0)


def _loss_and_grads(model):
    model.zero_grad(set_to_none=True)
    loss = model(base.TEXT, VIDEO, base.AUDIO, return_loss=True, train=True,
                 uncond=torch.tensor([True, False]), generator=torch.Generator().manual_seed(2))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def _without_dropout(model):
    model.attn_dropout = model.ff_dropout = 0.0  # forward then draws no seed
    return _loss_and_grads(model)[0]


def test_reversible_dual_replays_its_dropout_masks(monkeypatch):
    model = _model("h2")
    loss, grads = _loss_and_grads(model)
    dec = model.video_audio_transformer
    monkeypatch.setattr(dec, "forward", functools.partial(dec.forward, reverse=False))
    want, want_grads = _loss_and_grads(model)
    assert abs(loss - want) < 1e-5
    assert sorted(grads) == sorted(want_grads)
    for name, ref in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), ref.numpy(), rtol=0, err_msg=name,
                                   atol=REL * max(1.0, ref.abs().max().item()))
    assert abs(_without_dropout(model) - want) > 1e-3


def test_remat_replays_its_dropout_masks():
    model = _model("h1")
    want, want_grads = _loss_and_grads(model)
    model.video_audio_transformer.remat = True
    loss, grads = _loss_and_grads(model)
    assert loss == want
    assert sorted(grads) == sorted(want_grads)
    for name, ref in want_grads.items():
        assert torch.equal(grads[name], ref), name
    assert abs(_without_dropout(model) - want) > 1e-3
