"""Port parity: the training half of the vector quantizer (``update=True``)
and the EMA of parameters, against nuwa_tpu's on the same numpy inputs,
fp32 on the CPU.

The EMA codebook update, cosine and euclidean, with and without the
codebook projection, two updates in a row (the state threads); the k-means
init and the dead-code expiry with the indices that ``jax.random`` drew
injected into the port (``VectorQuantizeEMA.draw``), since torch cannot draw
JAX's bits; ``codebook_usage``; ``train.ema``. Tolerances: the codebook
state, outputs and commit loss within 1e-5 absolute, indices equal,
gradients within 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.train import ema as jema
from nuwa_tpu.vq import VectorQuantizeEMA as JVQ
from nuwa_tpu_torch.convert import load_jax_params
from nuwa_tpu_torch.train import ema_init, ema_update
from nuwa_tpu_torch.vq import VectorQuantizeEMA

torch.set_num_threads(1)
ATOL = 1e-5
STATE = ("embed", "embed_avg", "cluster_size", "initted")


def _pair(seed=0, **cfg):
    jvq = JVQ(**cfg)
    params = jax.tree.map(np.asarray, jvq.init(jax.random.PRNGKey(seed)))
    state = jax.tree.map(np.asarray, jvq.init_state(jax.random.PRNGKey(seed + 1)))
    tvq = VectorQuantizeEMA(**cfg)
    load_jax_params(tvq, {**params, **state})
    return jvq, params, state, tvq


def _x(n, dim, seed=2):
    return np.random.default_rng(seed).standard_normal((2, n, dim)).astype(np.float32)


def _inject(tvq, draws):
    """The port's draws replaced by JAX's, in order."""
    queue = list(draws)

    def draw(high, generator, what):
        want, arr = queue.pop(0)
        assert what == want and int(arr.max()) < high
        return torch.from_numpy(np.array(arr)).long()

    tvq.draw = draw
    return queue


def _check(jvq, params, state, tvq, x, rng=None):
    """One update in both packages: outputs, indices, commit loss, the new
    codebook state, and the gradients of outputs and commit loss."""
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def f(p, x):
        q, idx, commit, new = jvq(p, state, x, update=True, rng=rng)
        return jnp.sum(q * cot) + commit, (q, idx, commit, new)

    (_, (q, idx, commit, new)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tq, tidx, tcommit = tvq(xt, update=True)
    ((tq * torch.from_numpy(cot)).sum() + tcommit).backward()
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(q), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tcommit.item(), float(commit), atol=ATOL, rtol=0)
    for name in STATE:
        np.testing.assert_allclose(getattr(tvq, name).numpy(), np.asarray(new[name]),
                                   atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL, rtol=0)
    for name, p in tvq.named_parameters():  # project_out gets none: a zero gradient
        mod, leaf = name.split(".")
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(got, np.asarray(gp[mod][leaf]), atol=ATOL, rtol=0,
                                   err_msg=name)
    tvq.zero_grad()
    return jax.tree.map(np.asarray, new)


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "euclidean"])
@pytest.mark.parametrize("cdim", [4, None], ids=["projection", "no_projection"])
def test_ema_update_matches_jax(cosine, cdim):
    """Two updates in a row from the same state: the EMA of cluster sizes
    and sums, Laplace smoothing, the renormalised codes."""
    jvq, params, state, tvq = _pair(dim=8, codebook_size=16, codebook_dim=cdim, decay=0.8,
                                    kmeans_init=False, cosine_sim=cosine)
    for step in range(2):
        state = _check(jvq, params, state, tvq, _x(24, 8, seed=3 + step))
    assert float(state["cluster_size"].sum()) > 0


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "euclidean"])
def test_kmeans_init_with_injected_indices(cosine):
    """The first update runs k-means from the starting points JAX drew (the
    injected indices), the second does not run it again."""
    jvq, params, state, tvq = _pair(dim=8, codebook_size=16, codebook_dim=4, kmeans_iters=5,
                                    cosine_sim=cosine)
    x = _x(40, 8)
    rng = jax.random.PRNGKey(5)
    start = jax.random.randint(rng, (16,), 0, x.shape[0] * x.shape[1])
    queue = _inject(tvq, [("kmeans", start)])
    assert float(tvq.initted) == 0.0
    state = _check(jvq, params, state, tvq, x, rng=rng)
    assert not queue and float(tvq.initted) == 1.0
    _check(jvq, params, state, tvq, _x(40, 8, seed=4), rng=rng)  # no draw: initted


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "euclidean"])
def test_dead_code_expiry_with_injected_picks(cosine):
    """Codes whose EMA cluster size falls below the threshold are re-seeded
    from the batch vectors JAX picked (``fold_in(key, 1)``)."""
    jvq, params, state, tvq = _pair(dim=8, codebook_size=16, codebook_dim=None,
                                    kmeans_init=False, cosine_sim=cosine,
                                    threshold_ema_dead_code=0.5)
    rng = jax.random.PRNGKey(11)
    for step in range(2):
        x = _x(12, 8, seed=20 + step)
        picks = jax.random.randint(jax.random.fold_in(rng, 1), (16,), 0, 24)
        _inject(tvq, [("dead_code", picks)])
        before = tvq.cluster_size.clone()
        state = _check(jvq, params, state, tvq, x, rng=rng)
        assert (tvq.cluster_size == 0.5).any(), before  # some codes were re-seeded


def test_codebook_usage_matches_jax():
    jvq, params, state, tvq = _pair(dim=8, codebook_size=16, kmeans_init=False,
                                    threshold_ema_dead_code=0.0)
    state = _check(jvq, params, state, tvq, _x(6, 8))
    for thr in (None, 0.3):
        want = float(jvq.codebook_usage(state, thr))
        assert tvq.codebook_usage(thr).item() == pytest.approx(want, abs=0)
    assert 0 < tvq.codebook_usage().item() < 1
    jdead = JVQ(dim=8, codebook_size=16, threshold_ema_dead_code=0.25)
    tdead = VectorQuantizeEMA(dim=8, codebook_size=16, threshold_ema_dead_code=0.25)
    tdead.cluster_size.copy_(torch.tensor(state["cluster_size"]))
    assert tdead.codebook_usage().item() == float(jdead.codebook_usage(state))


def test_axis_name_is_refused():
    """A bare axis name means nothing without the mesh: ``axis_name`` takes
    a process group or a one-axis device mesh (tests/test_torch_parallel_vq.py
    runs them)."""
    tvq = VectorQuantizeEMA(dim=8, codebook_size=16)
    with pytest.raises(TypeError, match="process group"):
        tvq(torch.zeros(2, 8), update=True, axis_name="data")


@pytest.mark.parametrize("after,every", [(0, 1), (2, 1), (0, 3)])
def test_ema_gate_and_blend_match_jax(after, every):
    """The step gate (the 1-based step after the update) and the blend, over
    five steps of changing parameters."""
    rng = np.random.default_rng(0)
    params = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.standard_normal(4).astype(np.float32)} for _ in range(5)]
    kw = dict(beta=0.9, update_after_step=after, update_every=every)
    jstate = jema.ema_init(params[0])
    tstate = ema_init({k: torch.from_numpy(v) for k, v in params[0].items()})
    for step, p in enumerate(params, start=1):
        jstate = jema.ema_update(jstate, p, step, **kw)
        ema_update(tstate, {k: torch.from_numpy(v) for k, v in p.items()}, step, **kw)
        for k in p:
            np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), atol=1e-7,
                                       rtol=0)
    assert tstate["w"].data_ptr() != params[0]["w"].ctypes.data  # a copy, not an alias
