"""VQGanVAETrainer: the codec's alternating GAN training on one device.

Counterpart of ``nuwa_tpu/train/trainer_vqgan.py`` without a mesh. Each
step: a generator step over ``grad_accum_every`` microbatches (gradients
summed, then divided by the count; each microbatch updates the codebook,
the next quantises with it; the discriminator held constant), then a
discriminator step over a window of its own (the codec without a graph,
the codebook as the generator step left it, the gradient penalty when
``step % apply_grad_penalty_every == 0``), each with its own Adam (AdamW
when ``wd > 0``), then the EMA of the codec's parameters. The valid split
comes from ``np.random.default_rng(random_split_seed)``; when it rounds to
no item, training and validation share the dataset.

As in the JAX trainer the generator's optimizer also trains the perceptual
net (its params are the codec's minus ``discr``), and recon grids and
checkpoints are written at every step whose count is a multiple of
``save_results_every`` / ``save_model_every``, step 0 included. Unlike it,
nothing is written unless the caller names a ``results_folder`` (the JAX
trainer writes to ``./results`` by default), and ``resume`` is off by
default. The recon grids draw validation items; with a dataset that draws
random flips or rotations, a run without a folder draws fewer of them than
the JAX trainer, which always writes.

Checkpoints use ``train.checkpoint`` (the JAX package's format) under the
JAX trainer's names and tree: ``vae_trainstate.<step>.ckpt`` holds
``params`` (the codec's, ``discr`` and ``vgg`` at their JAX paths, conv
weights HWIO), ``vq`` (the codebook state), ``gen_opt`` and ``discr_opt``
(optax's Adam state: ``[0][0].count``, ``.mu``, ``.nu``), ``ema_params`` and
``step``; ``vae_ema.<step>.ckpt`` the EMA alone. ``resume=True`` restores
the newest ``vae_trainstate`` of the folder, the port's or one the JAX
trainer wrote (whose PRNG key is not in its file: the k-means and dead-code
draws start again from ``seed``, as the JAX trainer's key does); the data
order starts again from ``seed`` too.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch

from ..convert import _tensors, jax_layout, load_vqgan_vae_train, port_layout
from ..utils.image import save_image_grid
from ..vqgan_vae import VQGanVAE
from . import checkpoint
from .checkpoint import Attr
from .data import DataLoader, MemmappedImageDataset, ImageDataset, accum_log, stack_microbatches
from .ema import ema_init, ema_update
from .optimizer import get_optimizer

CKPT_NAME, EMA_NAME = "vae_trainstate", "vae_ema"
ADAM = (Attr("count"), Attr("mu"), Attr("nu"))


def noop(*a, **k):
    pass


def _parts(path):
    """A dotted path's parts, list indices as ints."""
    return tuple(int(p) if p.isdigit() else p for p in path.split("."))


@contextlib.contextmanager
def _frozen(module):
    """``module``'s parameters need no gradient inside the block."""
    params = [p for p in module.parameters() if p.requires_grad] if module is not None else []
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class _Subset:
    def __init__(self, ds, indices):
        self.ds = ds
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[int(self.indices[i])]


class VQGanVAETrainer:
    def __init__(self, vae, *, num_train_steps, lr, batch_size, grad_accum_every, wd=0.0,
                 images_memmap_path=None, images_memmap_shape=None, folder=None, dataset=None,
                 save_results_every=100, save_model_every=1000, results_folder=None,
                 valid_frac=0.05, random_split_seed=42, ema_beta=0.995,
                 ema_update_after_step=2000, ema_update_every=10, apply_grad_penalty_every=4,
                 seed=0, resume=False, mesh=None):
        if not isinstance(vae, VQGanVAE):
            raise TypeError("vae must be a nuwa_tpu_torch VQGanVAE")
        if mesh is not None:
            raise NotImplementedError("mesh= belongs to the parallel layouts, which the port "
                                      "does not have yet")
        if resume and results_folder is None:
            raise ValueError("resume needs a results_folder")
        self.vae = vae
        self.num_train_steps = num_train_steps
        self.grad_accum_every = grad_accum_every
        self.apply_grad_penalty_every = apply_grad_penalty_every
        self.ema_kw = dict(beta=ema_beta, update_after_step=ema_update_after_step,
                           update_every=ema_update_every)
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.results_folder = None
        if results_folder is not None:
            self.results_folder = Path(results_folder)
            self.results_folder.mkdir(parents=True, exist_ok=True)

        if dataset is None:
            if (folder is None) == (images_memmap_path is None):
                raise ValueError("give exactly one of dataset, folder and images_memmap_path")
            if folder is not None:
                dataset = ImageDataset(folder, vae.image_size, channels=vae.channels)
            else:
                dataset = MemmappedImageDataset(path=images_memmap_path,
                                                shape=images_memmap_shape)
        n_valid = int(len(dataset) * valid_frac) if valid_frac > 0 else 0
        if n_valid > 0:  # an empty valid split would leave next(valid_dl) nothing to yield
            order = np.random.default_rng(random_split_seed).permutation(len(dataset))
            self.ds = _Subset(dataset, order[n_valid:])
            self.valid_ds = _Subset(dataset, order[:n_valid])
            print(f"training with dataset of {len(self.ds)} samples and validating"
                  f" with randomly splitted {len(self.valid_ds)} samples")
        else:
            self.ds = self.valid_ds = dataset
            print(f"training with shared training and valid dataset of {len(dataset)} samples")
        self.dl = stack_microbatches(
            DataLoader(self.ds, batch_size, shuffle=True, seed=seed).cycle(), grad_accum_every)
        self.valid_dl = DataLoader(self.valid_ds, batch_size, shuffle=True, seed=seed + 1,
                                   drop_last=False).cycle()

        self.seed = seed
        self.gan = vae.gan_parts(seed=seed + 1)
        vgg = self.gan.vgg if self.gan is not None else None
        self.gen_params = list(vae.parameters()) + (list(vgg.parameters()) if vgg else [])
        self.gen_opt = get_optimizer(self.gen_params, lr=lr, wd=wd)
        self.discr_params = list(self.gan.discr.parameters()) if self.gan is not None else []
        self.discr_opt = (get_optimizer(self.discr_params, lr=lr, wd=wd)
                          if self.gan is not None else None)
        self.ema = ema_init(vae.eval_params())
        # the codebook's k-means and dead-code draws (a CPU generator, so any
        # device draws the same)
        self.generator = torch.Generator().manual_seed(seed)
        self.step = 0
        if resume:
            step = self.restore()
            if step is not None:
                print(f"resumed from checkpoint at step {step}")

    # ---- the train state in the JAX trainer's tree -------------------------

    def _named(self):
        """{JAX path: (tensor, owner, leaf)} of every parameter (``params.``
        then its path in the JAX params tree) and codebook buffer
        (``vq.``)."""
        out = {}
        for path, entry in _tensors(self.vae).items():
            out[path.replace("state.vq.", "vq.", 1)] = entry
        if self.gan is not None:
            out.update({f"params.{path}": entry for path, entry in _tensors(self.gan).items()})
        return out

    @staticmethod
    def _param_paths(named):
        """{id(parameter): its dotted path in the JAX params tree}."""
        return {id(t): path[len("params."):] for path, (t, _, _) in named.items()
                if path.startswith("params.")}

    def _opts(self):
        """(name, optimizer, parameters, parts to drop from a parameter's
        path): the discriminator's optax tree is ``params["discr"]``'s."""
        return (("gen_opt", self.gen_opt, self.gen_params, 0),
                ("discr_opt", self.discr_opt, self.discr_params, 1))

    def state_tree(self):
        """The train state as the JAX trainer's tree of tensors."""
        named = self._named()
        by_id = self._param_paths(named)
        items = {_parts(path): jax_layout(owner, leaf, t.detach())
                 for path, (t, owner, leaf) in named.items()}
        for key, opt, params, skip in self._opts():
            if opt is None:
                continue
            count = 0
            for p in params:
                owner, leaf = named[f"params.{by_id[id(p)]}"][1:]
                state = opt.state[p]
                count = int(state["step"]) if state else 0
                for field, name in zip(ADAM[1:], ("exp_avg", "exp_avg_sq")):
                    value = state[name] if state else torch.zeros_like(p)
                    items[(key, 0, 0, field) + _parts(by_id[id(p)])[skip:]] = jax_layout(
                        owner, leaf, value)
            items[(key, 0, 0, ADAM[0])] = torch.tensor(count, dtype=torch.int32)
        items.update(self._ema_items())
        items[("step",)] = torch.tensor(self.step, dtype=torch.int32)
        return checkpoint.tree_of(items)

    def _ema_items(self, prefix=("ema_params",)):
        """{path: EMA tensor in the JAX layout} under ``prefix``."""
        named = self._named()
        return {prefix + _parts(name): jax_layout(*named[f"params.{name}"][1:], t)
                for name, t in self.ema.items()}

    def save(self, steps):
        """Write ``vae_trainstate.<steps>.ckpt`` and ``vae_ema.<steps>.ckpt``."""
        path = checkpoint.save_checkpoint(self.results_folder, CKPT_NAME, steps,
                                          self.state_tree())
        checkpoint.save_checkpoint(self.results_folder, EMA_NAME, steps,
                                   checkpoint.tree_of(self._ema_items(prefix=())))
        return path

    @torch.no_grad()
    def restore(self):
        """Load the newest ``vae_trainstate`` of ``results_folder`` (the
        port's or the JAX trainer's); returns its step, or None."""
        found = checkpoint.latest_checkpoint(self.results_folder, CKPT_NAME)
        if found is None:
            return None
        path = found[1]
        groups = {"params": {}, "vq": {}, "ema_params": {}}
        opt_leaves = {"gen_opt": {}, "discr_opt": {}}
        step = None
        for key, value in checkpoint.load_checkpoint(path).items():
            parts = checkpoint.parse_keystr(key)
            if parts[0] in groups:
                groups[parts[0]][parts[1:]] = value
            elif parts[0] in opt_leaves:
                at = next((i for i, p in enumerate(parts) if p in ADAM), None)
                if at is None:
                    raise checkpoint.CheckpointMismatchError(f"{path}: no Adam leaf {key}")
                opt_leaves[parts[0]][parts[at:]] = value
            elif parts == ("step",):
                step = int(value)
            else:
                raise checkpoint.CheckpointMismatchError(f"{path}: unexpected leaf {key}")
        if step is None:
            raise checkpoint.CheckpointMismatchError(f"{path}: no step")
        try:
            load_vqgan_vae_train(self.vae, self.gan, checkpoint.tree_of(groups["params"]),
                                 checkpoint.tree_of(groups["vq"]))
        except ValueError as err:
            raise checkpoint.CheckpointMismatchError(f"{path}: its params are not this "
                                                     f"codec's: {err}") from None
        named = self._named()
        ema = {_parts(name): t for name, t in self.ema.items()}
        if set(groups["ema_params"]) != set(ema):
            raise checkpoint.CheckpointMismatchError(f"{path}: its ema_params are not this "
                                                     "codec's")
        for name, t in self.ema.items():
            t.copy_(port_layout(*named[f"params.{name}"][1:], groups["ema_params"][_parts(name)]))
        by_id = self._param_paths(named)
        for key, opt, params, skip in self._opts():
            leaves = opt_leaves[key]
            if opt is None:
                if leaves:
                    raise checkpoint.CheckpointMismatchError(f"{path}: {key} without a GAN")
                continue
            want = {(f,) + _parts(by_id[id(p)])[skip:] for p in params for f in ADAM[1:]}
            if set(leaves) - {(ADAM[0],)} != want or (ADAM[0],) not in leaves:
                raise checkpoint.CheckpointMismatchError(f"{path}: its {key} is not this "
                                                         "codec's")
            count = float(leaves[(ADAM[0],)])
            for p in params:
                owner, leaf = named[f"params.{by_id[id(p)]}"][1:]
                rest = _parts(by_id[id(p)])[skip:]
                opt.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": port_layout(owner, leaf, leaves[(ADAM[1],) + rest]).to(
                        p.device, p.dtype).contiguous(),
                    "exp_avg_sq": port_layout(owner, leaf, leaves[(ADAM[2],) + rest]).to(
                        p.device, p.dtype).contiguous(),
                }
        self.generator.manual_seed(self.seed)
        self.step = step
        return step

    # ---- steps -------------------------------------------------------------

    @staticmethod
    def _apply(opt, params, accum):
        """Divide the summed gradients by ``accum`` and step: a parameter
        that got no gradient steps with zeros, as optax's does."""
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.div_(accum)
        opt.step()
        opt.zero_grad(set_to_none=True)

    def _window(self):
        return torch.as_tensor(next(self.dl), device=self.vae.device)

    def gen_step(self):
        """One generator step over an accumulation window; returns the mean
        loss (a device scalar)."""
        images = self._window()
        loss_sum = 0.0
        with _frozen(self.gan.discr if self.gan is not None else None):
            for img in images:
                loss = self.vae(img, gan=self.gan, return_loss=True, generator=self.generator)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
        self._apply(self.gen_opt, self.gen_params, len(images))
        return loss_sum / len(images)

    def discr_step(self, apply_gp):
        """One discriminator step over a window of its own; returns the
        mean loss."""
        images = self._window()
        loss_sum = 0.0
        for img in images:
            loss = self.vae(img, gan=self.gan, return_discr_loss=True,
                            apply_grad_penalty=apply_gp)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        self._apply(self.discr_opt, self.discr_params, len(images))
        return loss_sum / len(images)

    def train_step(self):
        steps = self.step
        logs = {}
        accum_log(logs, {"loss": float(self.gen_step())})
        accum_log(logs, {"codebook_usage": float(self.vae.vq.codebook_usage())})
        if self.gan is not None:
            apply_gp = steps % self.apply_grad_penalty_every == 0
            accum_log(logs, {"discr_loss": float(self.discr_step(apply_gp))})
            print(f"{steps}: vae loss: {logs['loss']} - discr loss: {logs['discr_loss']}")
        else:
            print(f"{steps}: vae loss: {logs['loss']}")
        new_step = steps + 1
        ema_update(self.ema, self.vae.eval_params(), new_step, **self.ema_kw)
        if self.results_folder is not None:
            if steps % self.save_results_every == 0:
                self._save_recon_grid(steps, logs)
            if steps % self.save_model_every == 0:
                self.save(steps)
                print(f"{steps}: saving model to {self.results_folder}")
        self.step = new_step
        return logs

    @torch.no_grad()
    def _save_recon_grid(self, steps, logs):
        imgs = torch.as_tensor(next(self.valid_dl), device=self.vae.device)
        for params, suffix in ((self.ema, "ema"), (None, "")):
            if params is None:
                recon = self.vae(imgs)
            else:
                recon = torch.func.functional_call(self.vae, params, (imgs,))
            pair = np.stack([imgs.cpu().numpy(), recon.cpu().numpy()], axis=1)
            pair = pair.reshape(-1, *pair.shape[2:]).clip(0.0, 1.0)
            name = f"{steps}.{suffix}" if suffix else f"{steps}"
            save_image_grid(pair, self.results_folder / f"{name}.png", nrow=2)
            logs["reconstructions"] = pair
        print(f"{steps}: saving to {self.results_folder}")

    def train(self, log_fn=noop):
        while self.step < self.num_train_steps:
            log_fn(self.train_step())
        print("training complete")
