"""NUWATrainer: autoregressive text-to-video training on one device.

Counterpart of ``nuwa_tpu/train/trainer_nuwa.py`` without a mesh: gradient
accumulation (gradients averaged over ``grad_accum_every`` microbatches),
condition dropout, global-norm clipping, AdamW, and a periodic sample
through the cached ``generate``. With a VAE attached to the model the
batches may carry pixel videos, and the sample is a video: it is logged as
``sampled_video`` (with ``sampled_text`` through ``tokenizer``) and saved
as ``results_folder/{step}.png``, its frames stacked top to bottom; without
one the sample is logged as token ids, as the JAX trainer does. The JAX
trainer writes to ``./results-nuwa`` by default; here nothing is written
unless the caller names a ``results_folder``. Checkpoints, ``resume`` and
the EMA are not ported yet: ``save_model_every`` must stay None and
``resume`` False, and anything else raises.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.image import save_image_grid
from .data import DataLoader, accum_log, stack_microbatches
from .optimizer import clip_by_global_norm_, get_optimizer


def noop(*a, **k):
    pass


class NUWATrainer:
    def __init__(self, *, nuwa, dataset, num_train_steps, lr=3e-4, wd=0.01,
                 batch_size=4, grad_accum_every=8, max_grad_norm=0.5,
                 save_model_every=None, save_results_every=1000, results_folder=None,
                 num_sampled_frames=float("inf"), cond_dropout_prob=0.2, seed=0,
                 resume=False, tokenizer=None):
        if save_model_every is not None or resume:
            raise NotImplementedError("checkpoints and resume are not ported yet")
        self.nuwa = nuwa
        self.num_train_steps = num_train_steps
        self.grad_accum_every = grad_accum_every
        self.max_grad_norm = max_grad_norm
        self.cond_dropout_prob = cond_dropout_prob
        self.save_results_every = save_results_every
        self.num_sampled_frames = num_sampled_frames
        self.tokenizer = tokenizer
        self.results_folder = None
        if results_folder is not None:
            self.results_folder = Path(results_folder)
            self.results_folder.mkdir(parents=True, exist_ok=True)
        self.dl = stack_microbatches(
            DataLoader(dataset, batch_size, seed=seed).cycle(), grad_accum_every
        )
        # the frozen codec's parameters need no gradient and are not optimized
        self.params = [p for p in nuwa.parameters() if p.requires_grad]
        self.opt = get_optimizer(self.params, lr=lr, wd=wd)
        # condition dropout and sampling draw from this, on the model's device
        self.generator = torch.Generator(device=nuwa.device).manual_seed(seed)
        self.step = 0

    def train_step(self):
        steps = self.step
        texts, videos = (torch.as_tensor(x, device=self.nuwa.device) for x in next(self.dl))
        loss_sum = 0.0
        for text, video in zip(texts, videos):
            loss = self.nuwa(
                text, video, return_loss=True, cond_dropout_prob=self.cond_dropout_prob,
                train=True, generator=self.generator,
            )
            (loss / self.grad_accum_every).backward()
            loss_sum = loss_sum + loss.detach()
        if self.max_grad_norm is not None:
            clip_by_global_norm_(self.params, self.max_grad_norm)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1

        logs = accum_log({}, {"loss": float(loss_sum / self.grad_accum_every)})
        print(f"{steps} loss: {logs['loss']}")
        if steps % self.save_results_every == 0:
            self._sample(steps, texts, logs)
        return logs

    def _sample(self, steps, texts, logs):
        print(f"{steps} sampling")
        text = texts[0][:1]
        num_frames = int(min(self.nuwa.max_video_frames, self.num_sampled_frames))
        video = self.nuwa.generate(text, generator=self.generator, num_frames=num_frames)
        if video.ndim == 2:  # no VAE attached: token ids
            logs["sampled_indices"] = video[0].cpu().numpy()
            return
        one_video = video[0].float().clamp(0.0, 1.0).cpu().numpy()  # (f, c, h, w)
        if self.tokenizer is not None:
            logs["sampled_text"] = self.tokenizer.decode(np.asarray(text[0].cpu()))
        logs["sampled_video"] = one_video
        if self.results_folder is not None:
            # frames stacked top to bottom in one image
            save_image_grid(one_video, self.results_folder / f"{steps}.png", nrow=1)
            print(f"{steps}: saving to {self.results_folder}")

    def train(self, log_fn=noop):
        while self.step < self.num_train_steps:
            logs = self.train_step()
            log_fn(logs)
        print("training complete")
