"""Port parity: ``VQGanVAETrainer`` against the JAX package's, fp32 on the
CPU, on a tiny GAN codec (8 px, one layer, no perceptual net: its VGG is
held in tests/test_torch_vqgan_train.py).

Three steps from the JAX trainer's own initial state (written by the JAX
package's checkpoint and resumed by the port): the generator and
discriminator losses, the codebook usage, then the parameters, codebook
state, both Adam states and the EMA, with k-means and dead-code expiry on
and the draws of the JAX trainer's keys injected; the empty valid split;
the port's checkpoint in the JAX trainer's tree, which the JAX trainer
resumes; a port resume equal bit for bit to the uninterrupted run; a JAX
checkpoint resumed by the port, whose next losses are the resumed JAX
trainer's. Tolerance: 1e-4 absolute on losses, usage and every state leaf
(Adam steps of size lr = 1e-3 over three steps).
"""
import os

import jax
import numpy as np
import pytest
import torch

from nuwa_tpu.train import checkpoint as jckpt
from nuwa_tpu.train.trainer_vqgan import VQGanVAETrainer as JTrainer
from nuwa_tpu.vqgan_vae import VQGanVAE as JVAE
from nuwa_tpu_torch import VQGanVAE, VQGanVAETrainer
from nuwa_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)
TOL = 1e-4
CFG = dict(dim=8, image_size=8, num_layers=1, vq_codebook_size=16, vq_codebook_dim=8,
           resnet_groups=4, use_vgg_and_gan=True, perceptual="none", use_attn=False,
           num_resnet_blocks=0)
KW = dict(num_train_steps=3, lr=1e-3, batch_size=2, grad_accum_every=2, valid_frac=0.25,
          ema_update_after_step=0, ema_update_every=1, seed=3)


def _images(n=12, same=False):
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 1, (3, 8, 8)).astype(np.float32) for _ in range(1 if same else n)]
    return images * n if same else images


def _pair(folder, cfg=CFG, **kw):
    """A JAX trainer writing to ``folder/jax``, and a port trainer that
    resumes the JAX one's initial state from ``folder/port``."""
    kw = {**KW, "dataset": _images(), **kw}
    jt = JTrainer(JVAE(**cfg), results_folder=str(folder / "jax"), resume=False, **kw)
    jckpt.save_checkpoint(folder / "port", "vae_trainstate", 0, jt.state)
    tt = VQGanVAETrainer(VQGanVAE(**cfg, device="cpu", seed=7), results_folder=folder / "port",
                         resume=True, **kw)
    assert tt.step == 0
    return jt, tt


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_state_close(tt, jstate, tol=TOL):
    got = {ckpt.keystr(p): v.detach().numpy() for p, v in ckpt.flatten(tt.state_tree())}
    want = _flat(jstate)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=tol, rtol=0, err_msg=key)


def _jax_draws(seed, steps, accum, n, codebook_size):
    """The draws the JAX trainer's keys make: k-means at step 0's first
    microbatch, then a dead-code pick every microbatch."""
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    draws = []
    for step in range(steps):
        key, rng = jax.random.split(key)
        for m, mrng in enumerate(jax.random.split(rng, accum)):
            if step == 0 and m == 0:
                draws.append(("kmeans", jax.random.randint(mrng, (codebook_size,), 0, n)))
            draws.append(("dead_code", jax.random.randint(jax.random.fold_in(mrng, 1),
                                                          (codebook_size,), 0, n)))
    return draws


def test_three_steps_match_the_jax_trainer(tmp_path):
    """k-means init at the first microbatch, dead codes re-seeded every
    update, the codebook threading through the microbatches, the gradient
    penalty at step 0, the EMA every step."""
    cfg = dict(CFG, vq_kmeans_init=True, vq_threshold_ema_dead_code=0.5)
    jt, tt = _pair(tmp_path, cfg)
    queue = _jax_draws(3, 3, 2, 2 * 4 * 4, 16)

    def draw(high, generator, what):
        want, arr = queue.pop(0)
        assert want == what and int(arr.max()) < high
        return torch.from_numpy(np.array(arr)).long()

    tt.vae.vq.draw = draw
    for _ in range(3):
        want, got = jt.train_step(), tt.train_step()
        for key in ("loss", "discr_loss", "codebook_usage"):
            np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0, err_msg=key)
    assert not queue and tt.step == int(jt.state["step"]) == 3
    _assert_state_close(tt, jt.state)
    assert not np.allclose(tt.ema["enc.first.w"].numpy(), tt.vae.enc["first"].w.detach().numpy())
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "0.ema.png", "0.png", "vae_ema.0.ckpt", "vae_ema.LATEST", "vae_trainstate.0.ckpt",
        "vae_trainstate.LATEST"]


def test_empty_valid_split_shares_the_dataset(tmp_path):
    """int(8 * 0.05) == 0 valid items: training and validation share the
    dataset (a recon grid at step 0), in both packages; without a GAN the
    step is the generator's alone."""
    cfg = dict(CFG, use_vgg_and_gan=False)
    jt, tt = _pair(tmp_path, cfg, valid_frac=0.05, dataset=_images(8))
    assert len(tt.valid_ds) == len(tt.ds) == 8 and tt.gan is None and tt.discr_opt is None
    want, got = jt.train_step(), tt.train_step()
    assert "discr_loss" not in got
    np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL, rtol=0)
    assert (tmp_path / "port" / "0.png").exists()


def test_port_checkpoint_is_the_jax_tree_and_the_jax_trainer_resumes_it(tmp_path):
    """The same leaves in the same order and dtypes as the JAX trainer's
    file; the JAX trainer resumes the port's, exactly. As in the JAX
    trainer, a file holds the step count from before its step."""
    jt, tt = _pair(tmp_path)
    tt.train_step()
    path = tt.save(5)
    jfile = jckpt.save_checkpoint(tmp_path / "jax", "vae_trainstate", 5, jt.state)
    ours, theirs = (ckpt.load_checkpoint(p) for p in (path, jfile))
    assert list(ours) == list(theirs)
    assert all(ours[k].dtype == theirs[k].dtype for k in ours)
    resumed = JTrainer(JVAE(**CFG), results_folder=str(tmp_path / "port"), resume=True,
                       **dict(KW, dataset=_images()))
    assert int(resumed.state["step"]) == tt.step == 1
    _assert_state_close(tt, resumed.state, tol=0)


def test_port_resume_equals_the_uninterrupted_run(tmp_path):
    """One image repeated, so that every batch is the same (a resume starts
    the data order again from ``seed``): two steps with a checkpoint after
    each, then a fresh trainer over other weights resumes the newest file
    (the step count 1 from before its step, as the JAX trainer writes it)
    and takes a step as the first trainer does: the same losses and state
    bit for bit, the step count aside."""
    kw = dict(KW, dataset=_images(6, same=True), valid_frac=0.0, results_folder=tmp_path)
    first = VQGanVAETrainer(VQGanVAE(**CFG, device="cpu"), save_model_every=1, **kw)
    for _ in range(2):
        first.train_step()
    resumed = VQGanVAETrainer(VQGanVAE(**CFG, device="cpu", seed=5), resume=True, **kw)
    assert resumed.step == 1
    want, got = first.train_step(), resumed.train_step()
    assert got["loss"] == want["loss"] and got["discr_loss"] == want["discr_loss"]
    for a, b in zip(ckpt.flatten(first.state_tree()), ckpt.flatten(resumed.state_tree())):
        if a[0] != ("step",):
            assert torch.equal(a[1], b[1]), ckpt.keystr(a[0])


def test_port_resumes_a_jax_checkpoint_with_the_resumed_jax_losses(tmp_path):
    """The JAX trainer takes two steps with a checkpoint after each; a JAX
    trainer and the port's both resume the folder and take the next step."""
    kw = dict(KW, dataset=_images())
    JTrainer(JVAE(**CFG), results_folder=str(tmp_path), resume=False, save_model_every=1,
             **dict(kw, num_train_steps=2)).train()
    jt = JTrainer(JVAE(**CFG), results_folder=str(tmp_path / "j"), resume=False, **kw)
    jt.state = jckpt.restore_latest(tmp_path, "vae_trainstate", jt.state)[1]
    tt = VQGanVAETrainer(VQGanVAE(**CFG, device="cpu", seed=9), results_folder=tmp_path,
                         resume=True, **kw)
    assert tt.step == int(jt.state["step"]) == 1
    _assert_state_close(tt, jt.state, tol=0)
    want, got = jt.train_step(), tt.train_step()
    for key in ("loss", "discr_loss", "codebook_usage"):
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0, err_msg=key)


def test_refused_options(tmp_path):
    vae = VQGanVAE(**CFG, device="cpu")
    kw = dict(KW, dataset=_images())
    with pytest.raises(TypeError, match="make_mesh"):  # a mesh is make_mesh's
        VQGanVAETrainer(vae, mesh=object(), **kw)
    with pytest.raises(ValueError, match="results_folder"):
        VQGanVAETrainer(vae, resume=True, **kw)
    VQGanVAETrainer(vae, results_folder=tmp_path, **kw).train_step()  # writes step 0
    with pytest.raises(ckpt.CheckpointMismatchError, match="not this codec's"):
        VQGanVAETrainer(VQGanVAE(**dict(CFG, dim=16), device="cpu"), results_folder=tmp_path,
                        resume=True, **kw)
