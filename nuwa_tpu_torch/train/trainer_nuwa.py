"""NUWATrainer: autoregressive text-to-video training, on one device or,
with ``mesh=``, data- and tensor-parallel over a ``torch.distributed`` mesh
(``parallel.make_mesh``).

Counterpart of ``nuwa_tpu/train/trainer_nuwa.py``: gradient accumulation
(gradients averaged over ``grad_accum_every`` microbatches), condition
dropout, global-norm clipping, AdamW, and a periodic sample
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

With ``mesh`` every rank runs this trainer with the same arguments and
keeps JAX's global-batch semantics: each reads the same global batch (the
loader's ``seed``) and takes its rows (``batch_size`` divisible by the
'data' axis); the condition dropout is drawn for the global batch (as it is
without a mesh) and each rank takes its rows' draws, and the model's
forward keys the attention and feed-forward dropout masks by the global
rows (its ``row0``), so both are those of the global batch;
the model's parameters are split over 'model' by the TP rules
(``parallel.shard_params``); the gradients are averaged over 'data' before
the clip, whose norm is the whole model's. ``zero1=True`` splits AdamW's
moments over 'data' (``parallel.Zero1AdamW``; it needs a 'data' axis above
1). Every rank samples the global batch's first caption; rank 0 writes the
files. A checkpoint gathers every split tensor, rank 0 writes the file the
unmeshed trainer writes, and a resume loads it and splits it again, so a
meshed and an unmeshed trainer resume each other's files.
``context_parallel``, ``pipeline_parallel`` and ``pipeline_microbatches``
(context and pipeline parallelism, ROADMAP A8b) raise.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..convert import export_jax_params, jax_path, load_jax_params
from ..core.tp import shard_of
from ..ops.sampling import prob_mask_like
from ..parallel.mesh import axis_size
from ..parallel.sharding import (all_reduce_grads_, all_reduce_mean, data_rows, gathered,
                                 shard_params)
from ..parallel.zero import Zero1AdamW
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
                 resume=False, tokenizer=None, mesh=None, context_parallel=False,
                 pipeline_parallel=False, pipeline_microbatches=1, zero1=False):
        if (save_model_every is not None or resume) and results_folder is None:
            raise ValueError("save_model_every and resume need a results_folder")
        if context_parallel or pipeline_parallel or pipeline_microbatches != 1:
            raise NotImplementedError("context and pipeline parallelism are not in the port "
                                      "yet (ROADMAP A8b)")
        if zero1 and (mesh is None or axis_size(mesh, "data") <= 1):
            raise ValueError("zero1 requires a mesh with a 'data' axis > 1")
        if mesh is not None:
            dp = axis_size(mesh, "data")
            assert batch_size % dp == 0, f"batch_size {batch_size} not divisible by data axis {dp}"
            shard_params(nuwa, mesh)
        self.mesh = mesh
        self.main = mesh is None or dist.get_rank() == 0  # prints and writes the files
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
        if zero1:
            paths = {id(p): jax_path(nuwa, name) for name, p in nuwa.named_parameters()}
            self.opt = Zero1AdamW(self.params, [paths[id(p)] for p in self.params], mesh,
                                  lr=lr, wd=wd)
        else:
            self.opt = get_optimizer(self.params, lr=lr, wd=wd)
        # condition dropout and sampling draw from this, on the model's device
        self.generator = torch.Generator(device=nuwa.device).manual_seed(seed)
        self.step = 0
        if resume:
            step = self.restore()
            if step is not None and self.main:
                print(f"resumed from checkpoint at step {step}")

    # ---- checkpoints ------------------------------------------------------

    def _paths(self):
        """{JAX path: tensor} of the model's parameters and buffers in the
        JAX layout, and {JAX path: parameter} of the trained ones."""
        ids = {id(p) for p in self.params}
        trained = {jax_path(self.nuwa, name): p for name, p in self.nuwa.named_parameters()
                   if id(p) in ids}
        return export_jax_params(self.nuwa), trained

    def _whole(self):
        """The model's split tensors whole inside the block (a collective)."""
        return gathered(self.nuwa) if self.mesh is not None else contextlib.nullcontext()

    def _opt_state(self, p):
        """AdamW's state of ``p``, its moments whole over the mesh."""
        state = self.opt.state[p]
        if state and shard_of(p) is not None:
            state = {k: v if k == "step" else p.tp.gather(v) for k, v in state.items()}
        return state

    def state_tree(self):
        """The train state as a tree of tensors, as ``save`` writes it (a
        collective under a mesh: every rank calls it)."""
        with self._whole():
            return self._state_tree()

    def _state_tree(self):
        tensors, trained = self._paths()
        opt = {leaf: {} for leaf in _OPT_LEAVES}
        for path, p in trained.items():
            # a parameter that no step has reached yet: AdamW's fresh state
            state = self._opt_state(p) or {"step": torch.tensor(0.0),
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
        """Write the train state as ``nuwa_trainstate.<steps>.ckpt`` (rank 0
        under a mesh; returns the path there, None on the other ranks)."""
        tree = self.state_tree()
        path = (checkpoint.save_checkpoint(self.results_folder, CKPT_NAME, steps, tree)
                if self.main else None)
        if self.mesh is not None:
            dist.barrier()
        return path

    @torch.no_grad()
    def restore(self):
        """Load the newest checkpoint of ``results_folder`` (the port's or the
        JAX trainer's); returns its step, or None when there is none. Under
        a mesh every rank loads the file and keeps its parts."""
        with self._whole():
            return self._restore()

    def _restore(self):
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
            state = {"exp_avg": moments["mu"][path], "exp_avg_sq": moments["nu"][path]}
            if shard_of(p) is not None:  # this rank's part of the whole moments
                state = {k: p.tp.part(v) for k, v in state.items()}
            self.opt.state[p] = {
                "step": torch.tensor(float(p_step), dtype=torch.float32),
                **{k: v.to(p.device, p.dtype).clone() for k, v in state.items()},
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
        batch = texts.shape[1]
        # this rank's rows of the global batch
        rows = slice(None) if self.mesh is None else data_rows(self.mesh, batch)
        loss_sum = 0.0
        for text, video in zip(texts, videos):
            uncond = None  # the condition dropout, drawn for the global batch
            if self.cond_dropout_prob > 0:
                uncond = prob_mask_like((batch,), self.cond_dropout_prob,
                                        generator=self.generator, device=self.nuwa.device)[rows]
            loss = self.nuwa(text[rows], video[rows], return_loss=True, train=True,
                             cond_dropout_prob=self.cond_dropout_prob, generator=self.generator,
                             uncond=uncond, row0=rows.start or 0)
            (loss / self.grad_accum_every).backward()
            loss_sum = loss_sum + loss.detach()
        if self.mesh is not None:
            all_reduce_grads_(self.params, self.mesh)
            loss_sum = all_reduce_mean(loss_sum, self.mesh)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(self.params, self.max_grad_norm)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1

        logs = accum_log({}, {"loss": float(loss_sum / self.grad_accum_every)})
        self._print(f"{steps} loss: {logs['loss']}")
        if steps % self.save_results_every == 0:
            self._sample(steps, texts, logs)
        if self.save_model_every is not None and steps % self.save_model_every == 0:
            self.save(steps)
            self._print(f"{steps}: saving model to {self.results_folder}")
        return logs

    def _print(self, *args):
        if self.main:
            print(*args)

    def _sample(self, steps, texts, logs):
        self._print(f"{steps} sampling")
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
        if self.results_folder is not None and self.main:
            # frames stacked top to bottom in one image
            save_image_grid(one_video, self.results_folder / f"{steps}.png", nrow=1)
            print(f"{steps}: saving to {self.results_folder}")

    def train(self, log_fn=noop):
        while self.step < self.num_train_steps:
            logs = self.train_step()
            log_fn(logs)
        self._print("training complete")
