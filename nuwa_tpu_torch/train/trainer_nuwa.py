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

``context_parallel=True`` (it needs a mesh) splits the frames of the
decoder's Sparse3DNA layers over the mesh (``NUWA.forward(cp_mesh=)``), as
the JAX trainer does: on a ("data", "model") mesh the frames ride 'data'
and every rank takes the whole batch (its gradients are then the whole
batch's on every rank, and no average over 'data' follows); on a mesh with
a 'context' axis (``make_mesh(context=)``) the frames ride 'context' and the
batch is split over 'data' as above (DPxCP).

``pipeline_parallel=True`` (a mesh with a 'pipe' axis,
``make_mesh(pipe=)``; not with ``context_parallel``) runs the decoder as
GPipe stages over 'pipe' in ``pipeline_microbatches`` microbatches of each
rank's rows (``NUWA.forward(pp_mesh=)``, ``parallel.pipeline``). With more
than one stage each rank keeps only its stage's parameters of the decoder
stack, the other stages' tensors freed (``StageLayout``), and only those and
the replicated parameters go to the optimizer, so its stack parameter and
moment bytes are 1/S of the whole (``zero1`` splits its moments again over
'data'); the stage and the replicated gradients are averaged over 'data',
and the clip's norm adds the stages' squares over 'pipe'. A checkpoint
holds the stack in the JAX PP trainer's layout (each slot's leaves in
params, ``mu`` and ``nu`` with a leading (S,) axis, gathered over 'pipe');
a resume reads that layout or the flat one of an unmeshed trainer, JAX's
or the port's. The step-0 sample gathers the stack on every rank for the
cached ``generate`` and frees it after.
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
from ..parallel.pipeline import StageLayout
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
        if pipeline_parallel:
            if mesh is None or "pipe" not in mesh.mesh_dim_names:
                raise ValueError("pipeline_parallel requires a mesh with a 'pipe' axis")
            if context_parallel:
                raise ValueError("PP does not compose with CP")
            if axis_size(mesh, "model") > 1:
                raise ValueError("the pipelined trainer's mesh splits 'data' and 'pipe' only "
                                 "(make_mesh(pipe=))")
        if context_parallel and mesh is None:
            raise ValueError("context_parallel requires a mesh")
        if zero1 and (mesh is None or axis_size(mesh, "data") <= 1):
            raise ValueError("zero1 requires a mesh with a 'data' axis > 1")
        # the batch over 'data', but for CP on a mesh without 'context', whose
        # 'data' axis carries the frames
        self.data_parallel = mesh is not None and (
            not context_parallel or axis_size(mesh, "context") > 1)
        if self.data_parallel:
            dp = axis_size(mesh, "data")
            assert batch_size % dp == 0, f"batch_size {batch_size} not divisible by data axis {dp}"
        if mesh is not None:
            shard_params(nuwa, mesh)
        self.mesh = mesh
        self.cp_mesh = mesh if context_parallel else None
        self.pp = (dict(pp_mesh=mesh, pp_microbatches=pipeline_microbatches,
                        pp_data_axis="data" if "data" in mesh.mesh_dim_names else None)
                   if pipeline_parallel else {})
        # more than one stage: this rank keeps its stage of the decoder stack
        self.stages = (StageLayout(nuwa.video_transformer, mesh)
                       if pipeline_parallel and axis_size(mesh, "pipe") > 1 else None)
        freed = set(self.stages.shapes) if self.stages is not None else set()
        # {JAX path: trained} of the other stages' freed tensors
        self._freed = {jax_path(nuwa, name, buffer): not buffer and t.requires_grad
                       for buffer, named in ((False, nuwa.named_parameters()),
                                             (True, nuwa.named_buffers()))
                       for name, t in named if id(t) in freed}
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
        self.params = [p for p in nuwa.parameters() if p.requires_grad and id(p) not in freed]
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
        tensors = {path: t for path, t in export_jax_params(self.nuwa).items()
                   if path not in self._freed}
        return tensors, trained

    def _whole(self):
        """The model's split tensors whole inside the block (a collective)."""
        return gathered(self.nuwa) if self.mesh is not None else contextlib.nullcontext()

    def _stack(self, gather=True):
        """Every stage's tensors of the decoder stack held inside the block
        (``StageLayout.whole``)."""
        if self.stages is None:
            return contextlib.nullcontext()
        return self.stages.whole(gather)

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
        if self.stages is not None:  # the stack in JAX's PP layout, gathered over 'pipe'
            tensors = self.stages.stack(tensors)
            opt = {leaf: self.stages.stack(values, gather=leaf != "step")
                   for leaf, values in opt.items()}
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
        if self.stages is not None:  # JAX's PP layout, or a flat file
            leaves = self.stages.unstack(leaves)
        tensors, trained = self._paths()
        # the other stages' tensors are read too, and kept only inside ``whole``
        want = set(tensors) | set(self._freed)
        want_trained = set(trained) | {p for p, t in self._freed.items() if t}
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
        for what, got, paths in (("params", params, want), ("mu", moments["mu"], want_trained),
                                 ("nu", moments["nu"], want_trained)):
            if set(got) != paths:
                raise checkpoint.CheckpointMismatchError(
                    f"{path}: its {what} are not this model's: missing "
                    f"{sorted(paths - set(got))[:5]}, unexpected "
                    f"{sorted(set(got) - paths)[:5]}")
        if step is None or (count is None and set(moments["step"]) != want_trained):
            raise checkpoint.CheckpointMismatchError(f"{path}: no step or optimizer count")
        with self._stack(gather=False):
            load_jax_params(self.nuwa, {path: params[path] for path in want})
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
        rows = data_rows(self.mesh, batch) if self.data_parallel else slice(None)
        loss_sum = 0.0
        for text, video in zip(texts, videos):
            uncond = None  # the condition dropout, drawn for the global batch
            if self.cond_dropout_prob > 0:
                uncond = prob_mask_like((batch,), self.cond_dropout_prob,
                                        generator=self.generator, device=self.nuwa.device)[rows]
            loss = self.nuwa(text[rows], video[rows], return_loss=True, train=True,
                             cond_dropout_prob=self.cond_dropout_prob, generator=self.generator,
                             uncond=uncond, row0=rows.start or 0, cp_mesh=self.cp_mesh,
                             **self.pp)
            (loss / self.grad_accum_every).backward()
            loss_sum = loss_sum + loss.detach()
        if self.data_parallel:
            all_reduce_grads_(self.params, self.mesh)
            loss_sum = all_reduce_mean(loss_sum, self.mesh)
        if self.max_grad_norm is not None:
            staged = {}
            if self.stages is not None:  # the stages' squares add over 'pipe'
                staged = dict(stage_group=self.stages.group, staged=self.stages.own_parameters())
            clip_by_global_norm_(self.params, self.max_grad_norm, **staged)
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
        with self._stack():  # the plain cached decoder runs every layer
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
