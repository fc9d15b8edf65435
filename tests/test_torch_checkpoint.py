"""The port's checkpoints (``train.checkpoint``, the JAX package's version-2
format) and ``NUWATrainer``'s ``save_model_every`` and ``resume``: round
trips of fp32, bfloat16 (stored as its bits) and int8 leaves; atomic writes;
LATEST and the folder scan behind it; files written by
``nuwa_tpu.train.checkpoint.save_checkpoint`` read by the port and the
port's read by it; a port resume equal to the uninterrupted run; a JAX
``NUWATrainer`` checkpoint resumed by the port's trainer, whose next loss is
JAX's (within 1e-4, as test_torch_train.py holds the trainers' losses); a
file of another model raising its own error. fp32 on the CPU.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.train import checkpoint as jckpt
from nuwa_tpu.train import optimizer as jopt
from nuwa_tpu_torch import NUWA
from nuwa_tpu_torch.convert import _tensors
from nuwa_tpu_torch.train import NUWATrainer
from nuwa_tpu_torch.train import checkpoint as ckpt
from test_torch_sketch import jax_params
from test_torch_train import CFG, _dataset

torch.set_num_threads(1)


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {
        "params": {"layers": [{"w": torch.randn(3, 4, generator=gen)},
                              {"w": torch.randn(3, 4, generator=gen).bfloat16()}],
                   "q": torch.randint(-127, 128, (4, 2), generator=gen).to(torch.int8),
                   "scale": torch.rand(2, generator=gen)},
        "step": 7,
    }


def test_round_trip_of_fp32_bf16_bits_and_int8(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(tmp_path, "state", 7, tree)
    got = ckpt.load_checkpoint(path)
    want = dict(ckpt.flatten(tree))
    assert list(got) == [ckpt.keystr(p) for p in want]
    for p, leaf in want.items():
        leaf = torch.as_tensor(leaf)
        assert got[ckpt.keystr(p)].dtype == leaf.dtype
        assert torch.equal(got[ckpt.keystr(p)], leaf)
    manifest = json.loads(__import__("zipfile").ZipFile(path).read("manifest.json"))
    assert manifest["version"] == 2 and "bfloat16" in manifest["dtypes"]
    assert ckpt.unflatten(got)["params"]["layers"][1]["w"].dtype == torch.bfloat16


def test_writes_are_atomic_and_latest_falls_back_to_a_scan(tmp_path):
    for step in (2, 10, 3):
        ckpt.save_checkpoint(tmp_path, "state", step, _tree())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert ckpt.latest_checkpoint(tmp_path, "state") == (3, str(tmp_path / "state.3.ckpt"))
    os.remove(tmp_path / "state.3.ckpt")  # LATEST stale: the scan finds step 10
    assert ckpt.latest_checkpoint(tmp_path, "state") == (10, str(tmp_path / "state.10.ckpt"))
    os.remove(tmp_path / "state.LATEST")
    assert ckpt.latest_checkpoint(tmp_path, "state")[0] == 10
    step, leaves = ckpt.restore_latest(tmp_path, "state")
    assert step == 10 and int(leaves["['step']"]) == 7
    assert ckpt.latest_checkpoint(tmp_path, "other") is None
    assert ckpt.restore_latest(tmp_path, "other") is None


def test_jax_files_read_by_the_port_and_back(tmp_path):
    """A JAX tree with a bf16 leaf and a PRNG key, written by the JAX
    package, read by the port; the port's file read by the JAX package."""
    jtree = {"params": {"a": [jnp.arange(6.0).reshape(2, 3),
                              jnp.ones((2, 3), jnp.bfloat16) / 3]},
             "step": jnp.asarray(5, jnp.int32), "key": jax.random.PRNGKey(3)}
    got = ckpt.load_checkpoint(jckpt.save_checkpoint(tmp_path, "j", 5, jtree))
    assert got["['params']['a'][1]"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["['params']['a'][1]"].float().numpy(),
                                  np.asarray(jtree["params"]["a"][1], np.float32))
    np.testing.assert_array_equal(got["['params']['a'][0]"].numpy(),
                                  np.asarray(jtree["params"]["a"][0]))
    assert int(got["['step']"]) == 5 and got["['step']"].shape == ()
    path = ckpt.save_checkpoint(tmp_path, "t", 1, _tree())
    template = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16 if t.dtype ==
                                                torch.bfloat16 else str(t.dtype)[6:]),
                            {"params": _tree()["params"]})
    template["step"] = jnp.asarray(0)
    back = jckpt.load_checkpoint(path, template)
    np.testing.assert_array_equal(np.asarray(back["params"]["layers"][1]["w"], np.float32),
                                  _tree()["params"]["layers"][1]["w"].float().numpy())
    assert int(back["step"]) == 7


KW = dict(num_train_steps=3, lr=1e-3, wd=0.01, batch_size=2, grad_accum_every=1,
          max_grad_norm=0.5, save_results_every=100, seed=3)


def _same_batch():
    """Two equal pairs, so that every shuffle gives the same batch: a
    resume restarts the loader's order from ``seed``, as the JAX trainer
    does, so only then is the resumed run the uninterrupted one."""
    return [_dataset(1, ragged=False)[0]] * 2


def test_port_resume_equals_the_uninterrupted_run(tmp_path):
    """Two steps with a checkpoint after each (condition dropout drawn from
    the trainer's generator, a sample at step 0); a fresh trainer resumed
    from the folder takes step 3 as the first trainer does: the same loss
    and parameters, bit for bit."""
    kw = dict(KW, dataset=_same_batch(), cond_dropout_prob=0.5, results_folder=tmp_path)
    first = NUWATrainer(nuwa=NUWA(**CFG, device="cpu", seed=1), save_model_every=1, **kw)
    for _ in range(2):
        first.train_step()
    assert sorted(os.listdir(tmp_path)) == ["nuwa_trainstate.0.ckpt", "nuwa_trainstate.1.ckpt",
                                            "nuwa_trainstate.LATEST"]
    resumed = NUWATrainer(nuwa=NUWA(**CFG, device="cpu", seed=9), resume=True, **kw)
    assert resumed.step == 2
    want, got = first.train_step()["loss"], resumed.train_step()["loss"]
    assert got == want
    for (name, a), b in zip(first.nuwa.named_parameters(), resumed.nuwa.parameters()):
        assert torch.equal(a, b), name


def test_jax_trainer_checkpoint_resumes_with_jax_next_loss(tmp_path, monkeypatch):
    """The JAX NUWATrainer takes two steps with a checkpoint after each; the
    port's trainer resumes its newest file (parameters through convert,
    optax's mu / nu / count as AdamW's state, the generator re-seeded) and
    takes step 3 on the same batch: JAX's third loss."""
    from nuwa_tpu.train import trainer_nuwa as jtrainer

    monkeypatch.setattr(jtrainer.NUWATrainer, "_sample", lambda *a: None)
    tmodel = NUWA(**CFG, device="cpu", seed=2)
    jmodel = JNUWA(**CFG)
    params = jax_params(jmodel, tmodel)
    kw = dict(KW, dataset=_same_batch(), cond_dropout_prob=0.0)
    jt = jtrainer.NUWATrainer(nuwa=jmodel, params=params, resume=False,
                              results_folder=tmp_path, save_model_every=1,
                              **dict(kw, num_train_steps=2))
    jt.train()
    port = NUWATrainer(nuwa=NUWA(**CFG, device="cpu", seed=5), resume=True,
                       results_folder=tmp_path, **kw)
    assert port.step == 2
    want = jt.train_step()["loss"]
    got = port.train_step()["loss"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_jax_train_state_with_a_frozen_vae_restores(tmp_path):
    """A JAX train state whose optimizer masks a frozen VAE (the moments sit
    in optax's ``masked`` chain, none for the VAE): the parameters, the
    codec's state and the moments land in the port's model and AdamW."""
    from test_torch_nuwa_vae import _models

    _, jparams, tmodel = _models()
    tx = jopt.get_optimizer(lr=1e-3, wd=0.01, params=jparams, max_grad_norm=0.5)
    opt = jax.tree.map(lambda x: x + (0.25 if x.dtype == jnp.float32 else 4),
                       tx.init(jparams))
    jckpt.save_checkpoint(tmp_path, "nuwa_trainstate", 3, {
        "params": jparams, "opt": opt, "step": jnp.asarray(4, jnp.int32),
        "key": jax.random.PRNGKey(0)})
    fresh = _models(seed=7)[2]
    trainer = NUWATrainer(nuwa=fresh, dataset=_same_batch(), num_train_steps=1,
                          results_folder=tmp_path, resume=True)
    assert trainer.step == 4
    fresh_tensors = _tensors(fresh)
    for path, (t, _, _) in _tensors(tmodel).items():
        assert torch.equal(fresh_tensors[path][0], t), path
    states = [trainer.opt.state[p] for p in trainer.params]
    assert all(float(s["step"]) == 4 and float(s["exp_avg"].min()) == 0.25
               and float(s["exp_avg_sq"].max()) == 0.25 for s in states)
    assert not any(p.requires_grad for p in fresh.vae.parameters())


def test_a_file_of_another_model_raises_its_own_error(tmp_path):
    trainer = NUWATrainer(nuwa=NUWA(**CFG, device="cpu"), dataset=_same_batch(),
                          num_train_steps=1, batch_size=2, grad_accum_every=1,
                          save_results_every=100, save_model_every=1, results_folder=tmp_path)
    trainer.train_step()
    other = dict(CFG, dec_depth=2)
    with pytest.raises(ckpt.CheckpointMismatchError, match="not this model's"):
        NUWATrainer(nuwa=NUWA(**other, device="cpu"), dataset=_same_batch(),
                    num_train_steps=1, results_folder=tmp_path, resume=True)
    with pytest.raises(ckpt.CheckpointMismatchError):
        ckpt.load_checkpoint(tmp_path / "nuwa_trainstate.0.ckpt", keys=["['step']"])
