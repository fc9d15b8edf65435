"""Port parity for training: the gradient repairs of the leaf layers, one
optimizer update and the trainer's first losses, against nuwa_tpu with the
same params and numpy inputs, fp32 on the CPU.

Tolerances: layer gradients 1e-5 absolute; optimizer updates 1e-6 absolute
(AdamW steps of size ~lr = 1e-2); trainer losses 1e-4 (two models, the
second and third losses after Adam updates that amplify rounding in the
gradients' smallest entries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.core import layers as jl
from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.train import optimizer as jopt
from nuwa_tpu_torch import NUWA
from nuwa_tpu_torch.convert import load_jax_params
from nuwa_tpu_torch.core import layers as tl
from nuwa_tpu_torch.train import (DataLoader, NUWATrainer, clip_by_global_norm_, get_optimizer,
                                  stack_microbatches)

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_stable_layernorm_grad_matches_jax():
    """The row amax is held constant for the gradient, as the JAX package's
    stop_gradient does; differentiating through it moves the x gradient by
    about 1e-4 at this input."""
    p = {"norm": {"g": _rnd(16, seed=3), "b": _rnd(16, seed=4)}}
    x, cot = _rnd(4, 7, 16, seed=1) * 3, _rnd(4, 7, 16, seed=2)
    jmod = jl.StableLayerNorm(16)
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(jmod(p, x) * cot), argnums=(0, 1))(
        p, jnp.asarray(x)
    )
    tmod = load_jax_params(tl.StableLayerNorm(16), p)
    xt = torch.from_numpy(x).requires_grad_()
    (tmod(xt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tmod.norm.g.grad.numpy(), np.asarray(jgp["norm"]["g"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tmod.norm.b.grad.numpy(), np.asarray(jgp["norm"]["b"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("train", [True, False])
def test_embedding_fractional_gradient_matches_jax(train):
    jmod = jl.Embedding(10, 4, frac_gradient=0.2)
    p = jmod.init(KEY)
    ids = np.array([[0, 3, 9, 3], [2, 2, 7, 0]])
    cot = _rnd(2, 4, 4)
    want = jax.grad(lambda p: jnp.sum(jmod(p, jnp.asarray(ids), train=train) * cot))(p)
    tmod = load_jax_params(tl.Embedding(10, 4, frac_gradient=0.2), jax.tree.map(np.asarray, p))
    out = tmod(torch.from_numpy(ids), train=train)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(p["table"])[ids], atol=1e-6)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tmod.table.grad.numpy(), np.asarray(want["table"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("wd,max_norm", [(0.1, 0.5), (0.0, 0.5), (0.1, 1e3)])
def test_optimizer_update_matches_optax(wd, max_norm):
    """Two updates from identical gradients: clipping on (max_norm 0.5,
    below the gradients' norm) and off (1e3), weight decay on the 2-D
    parameter only, and Adam when wd = 0."""
    params = {"w": _rnd(3, 4, seed=1), "b": _rnd(4, seed=2)}
    grads = [{"w": _rnd(3, 4, seed=3 + i), "b": _rnd(4, seed=5 + i)} for i in range(2)]
    tx = jopt.get_optimizer(lr=1e-2, wd=wd, params=params, max_grad_norm=max_norm)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = get_optimizer(list(tp.values()), lr=1e-2, wd=wd)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_by_global_norm_(list(tp.values()), max_norm)
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


CFG = dict(
    dim=16, image_size=4, num_image_tokens=32, max_video_frames=2,
    text_num_tokens=50, text_max_seq_len=6, text_enc_depth=1,
    text_enc_dim_head=8, text_enc_heads=2, dec_depth=1, dec_dim_head=8,
    dec_heads=2, sparse_3dna_kernel_size=(3, 3, 3), sparse_3dna_dilation=1,
    shift_video_tokens=True, dec_reversible=True,
)


def _dataset(n, seed=0, ragged=True):
    """(text ids, video ids) pairs made from a seed. Ragged texts are 2 to 5
    ids long; otherwise each is 5 wide, zero-padded after 2 to 5 ids, so
    every batch has one shape (and a JAX trainer compiles its step once)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        text = rng.integers(1, 50, int(rng.integers(2, 6))).astype(np.int64)
        if not ragged:
            text = np.pad(text, (0, 5 - text.shape[0]))
        pairs.append((text, rng.integers(0, 32, 32).astype(np.int64)))
    return pairs


def test_batches_match_the_jax_loader():
    """Ragged texts, a dataset that is not a whole number of batches, an
    accumulation window of 2: the port's pipeline yields the JAX trainer's
    batches in its order, each text padded to its window's widest."""
    from nuwa_tpu.train import data as jdata

    ds = _dataset(7)
    want = jdata.stack_microbatches(
        jdata.DataLoader(ds, 2, collate_fn=jdata.pad_collate, shuffle=True, seed=3).cycle(), 2
    )
    got = stack_microbatches(DataLoader(ds, 2, seed=3).cycle(), 2)
    for _ in range(5):  # across three epochs
        for a, b in zip(next(got), next(want), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_trainer_first_losses_match_jax(tmp_path, monkeypatch):
    """Same params, same seed (so the same shuffled batches), no condition
    dropout: the first three logged losses agree. The texts are of one width
    (test_batches_match_the_jax_loader covers ragged ones)."""
    from nuwa_tpu.train import trainer_nuwa as jtrainer

    # the JAX trainer samples and saves at step 0; neither is compared here
    monkeypatch.setattr(jtrainer.NUWATrainer, "_sample", lambda *a: None)
    monkeypatch.setattr(jtrainer, "save_checkpoint", lambda *a, **k: None)
    jmodel = JNUWA(**CFG)
    params = jmodel.init(KEY)
    kw = dict(num_train_steps=3, lr=1e-3, wd=0.01, batch_size=2, grad_accum_every=2,
              max_grad_norm=0.5, cond_dropout_prob=0.0, seed=3)
    ds = _dataset(6, ragged=False)
    want = []
    jtrainer.NUWATrainer(nuwa=jmodel, params=params, dataset=ds, resume=False,
                         results_folder=tmp_path, save_results_every=100,
                         save_model_every=100, **kw).train(lambda logs: want.append(logs["loss"]))
    tmodel = load_jax_params(NUWA(**CFG, device="cpu"), jax.tree.map(np.asarray, params))
    got = []
    NUWATrainer(nuwa=tmodel, dataset=ds, save_results_every=100, **kw).train(
        lambda logs: got.append(logs["loss"]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_trainer_lowers_the_loss():
    """Eight steps on one batch, with condition dropout drawn from the
    trainer's generator and a sample through the cached decoder."""
    model = NUWA(**CFG, device="cpu", seed=1)
    logs = []
    NUWATrainer(nuwa=model, dataset=_dataset(2), num_train_steps=8, lr=3e-3,
                batch_size=2, grad_accum_every=1, save_results_every=7,
                num_sampled_frames=1).train(logs.append)
    losses = [entry["loss"] for entry in logs]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    ids = logs[-1]["sampled_indices"]
    assert ids.shape == (16,) and 0 <= ids.min() and ids.max() < 32


def test_trainer_refuses_what_is_not_ported():
    model = NUWA(**CFG, device="cpu")
    for kw in (dict(save_model_every=10), dict(resume=True)):
        with pytest.raises(NotImplementedError):
            NUWATrainer(nuwa=model, dataset=_dataset(2), num_train_steps=1, **kw)
