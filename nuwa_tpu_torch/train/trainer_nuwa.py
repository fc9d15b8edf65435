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
unless the caller names a ``results_folder``.

Checkpoints: with ``save_model_every`` every step whose count before it is
a multiple writes ``results_folder/nuwa_trainstate.<that count>.ckpt``
(``train.checkpoint``, the JAX package's format) after the step: the
model's parameters and buffers under ``params`` at their JAX paths (the
frozen codec's too, as the JAX train state holds them), AdamW's moments and
per-parameter step under ``opt`` (``mu``, ``nu``, ``step``), the trainer's
``step`` and the generator's state. ``resume=True`` restores the newest
checkpoint of the folder, if there is one: the port's, or one the JAX
``NUWATrainer`` wrote (its parameters through ``convert``, optax's
``mu``/``nu``/``count`` as AdamW's ``exp_avg``/``exp_avg_sq``/``step``; its
PRNG key cannot carry over, so the generator starts again from ``seed``).
A file whose leaves are not this model's raises
``checkpoint.CheckpointMismatchError``. The data order starts again from
``seed`` on resume, as in the JAX trainer.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..convert import export_jax_params, jax_path, load_jax_params
from ..utils.image import save_image_grid
from . import checkpoint
from .data import DataLoader, accum_log, stack_microbatches
from .optimizer import clip_by_global_norm_, get_optimizer

CKPT_NAME = "nuwa_trainstate"
_OPT_LEAVES = {"mu": "exp_avg", "nu": "exp_avg_sq", "step": "step"}


def _parts(path):
    """A dotted JAX path's parts, list indices as ints."""
    return tuple(int(p) if p.isdigit() else p for p in path.split("."))


def noop(*a, **k):
    pass


class NUWATrainer:
    def __init__(self, *, nuwa, dataset, num_train_steps, lr=3e-4, wd=0.01,
                 batch_size=4, grad_accum_every=8, max_grad_norm=0.5,
                 save_model_every=None, save_results_every=1000, results_folder=None,
                 num_sampled_frames=float("inf"), cond_dropout_prob=0.2, seed=0,
                 resume=False, tokenizer=None):
        if (save_model_every is not None or resume) and results_folder is None:
            raise ValueError("save_model_every and resume need a results_folder")
        self.nuwa = nuwa
        self.save_model_every = save_model_every
        self.seed = seed
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
        if resume:
            step = self.restore()
            if step is not None:
                print(f"resumed from checkpoint at step {step}")

    # ---- checkpoints ------------------------------------------------------

    def _paths(self):
        """{JAX path: tensor} of the model's parameters and buffers in the
        JAX layout, and {JAX path: parameter} of the trained ones."""
        ids = {id(p) for p in self.params}
        trained = {jax_path(self.nuwa, name): p for name, p in self.nuwa.named_parameters()
                   if id(p) in ids}
        return export_jax_params(self.nuwa), trained

    def state_tree(self):
        """The train state as a tree of tensors, as ``save`` writes it."""
        tensors, trained = self._paths()
        opt = {leaf: {} for leaf in _OPT_LEAVES}
        for path, p in trained.items():
            # a parameter that no step has reached yet: AdamW's fresh state
            state = self.opt.state[p] or {"step": torch.tensor(0.0),
                                          "exp_avg": torch.zeros_like(p),
                                          "exp_avg_sq": torch.zeros_like(p)}
            for leaf, name in _OPT_LEAVES.items():
                opt[leaf][path] = state[name]
        flat = {checkpoint.keystr(("params",) + _parts(path)): t
                for path, t in tensors.items()}
        for leaf, values in opt.items():
            flat.update({checkpoint.keystr(("opt", leaf) + _parts(path)): t
                         for path, t in values.items()})
        flat["['step']"] = torch.tensor(self.step)
        flat["['generator']"] = self.generator.get_state()
        return checkpoint.unflatten(flat)

    def save(self, steps):
        """Write the train state as ``nuwa_trainstate.<steps>.ckpt``."""
        return checkpoint.save_checkpoint(self.results_folder, CKPT_NAME, steps,
                                          self.state_tree())

    @torch.no_grad()
    def restore(self):
        """Load the newest checkpoint of ``results_folder`` (the port's or the
        JAX trainer's); returns its step, or None when there is none."""
        found = checkpoint.latest_checkpoint(self.results_folder, CKPT_NAME)
        if found is None:
            return None
        path = found[1]
        leaves = checkpoint.load_checkpoint(path)
        tensors, trained = self._paths()
        params, moments = {}, {leaf: {} for leaf in _OPT_LEAVES}
        count = step = gen = None
        for key, value in leaves.items():
            parts = checkpoint.parse_keystr(key)
            if parts[0] == "params":
                params[".".join(map(str, parts[1:]))] = value
            elif parts[0] == "opt":
                at = next((i for i, p in enumerate(parts) if p in (*_OPT_LEAVES, "count")),
                          None)
                if at is None:
                    raise checkpoint.CheckpointMismatchError(f"{path}: no optimizer leaf {key}")
                if parts[at] == "count":  # optax: one count for every parameter
                    count = value
                else:
                    moments[parts[at]][".".join(map(str, parts[at + 1:]))] = value
            elif parts == ("step",):
                step = int(value)
            elif parts == ("generator",):
                gen = value
            elif parts != ("key",):  # the JAX PRNG key cannot carry over
                raise checkpoint.CheckpointMismatchError(f"{path}: unexpected leaf {key}")
        for what, got, want in (("params", params, tensors), ("mu", moments["mu"], trained),
                                ("nu", moments["nu"], trained)):
            if set(got) != set(want):
                raise checkpoint.CheckpointMismatchError(
                    f"{path}: its {what} are not this model's: missing "
                    f"{sorted(set(want) - set(got))[:5]}, unexpected "
                    f"{sorted(set(got) - set(want))[:5]}")
        if step is None or (count is None and set(moments["step"]) != set(trained)):
            raise checkpoint.CheckpointMismatchError(f"{path}: no step or optimizer count")
        load_jax_params(self.nuwa, {path: params[path] for path in tensors})
        for path, p in trained.items():
            p_step = moments["step"][path] if count is None else count
            self.opt.state[p] = {
                "step": torch.tensor(float(p_step), dtype=torch.float32),
                "exp_avg": moments["mu"][path].to(p.device, p.dtype).clone(),
                "exp_avg_sq": moments["nu"][path].to(p.device, p.dtype).clone(),
            }
        if gen is not None:
            self.generator.set_state(gen)
        else:
            self.generator.manual_seed(self.seed)
        self.step = step
        return step

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
        if self.save_model_every is not None and steps % self.save_model_every == 0:
            self.save(steps)
            print(f"{steps}: saving model to {self.results_folder}")
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
