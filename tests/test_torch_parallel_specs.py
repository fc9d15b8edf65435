"""The port's partition rules against the JAX package's, leaf for leaf: the
TP specs of a tiny NUWA (``make_param_specs``), plain and int8, and the
ZeRO-1 specs of its AdamW state on a (data 2, model 2) mesh
(``zero_opt_specs``), from the JAX optax state's own paths and from the
port's parameters as ``Zero1AdamW`` places their moments. No process group
is needed: the spec functions read only a mesh's axis names and sizes, so
a stand-in with a device mesh's ``mesh_dim_names`` and ``shape`` serves.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.parallel import make_mesh as jmake_mesh
from nuwa_tpu.parallel import make_param_specs as jmake_param_specs
from nuwa_tpu.parallel import zero_opt_specs as jzero_opt_specs
from nuwa_tpu.parallel.sharding import _path_str
from nuwa_tpu.train.optimizer import get_optimizer as jget_optimizer
from nuwa_tpu.utils.quantize import quantize_params_int8
from nuwa_tpu_torch import NUWA
from nuwa_tpu_torch.convert import jax_path
from nuwa_tpu_torch.parallel import make_param_specs, zero_opt_specs
from nuwa_tpu_torch.parallel.zero import _zero_spec
from nuwa_tpu_torch.utils.quantize import quantize_int8_
from test_torch_sketch import jax_params

torch.set_num_threads(1)
# tests/test_parallel.py's tiny model with the token shift and a rel-pos bias
CFG = dict(dim=16, image_size=2, num_image_tokens=16, max_video_frames=2, text_num_tokens=32,
           text_max_seq_len=4, text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2,
           dec_depth=2, dec_dim_head=8, dec_heads=2, sparse_3dna_rel_pos_bias=True)
MESH = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))


@pytest.fixture(scope="module")
def models():
    tmodel = NUWA(**CFG, device="cpu", seed=0)
    jmodel = JNUWA(**CFG)
    return tmodel, jax_params(jmodel, tmodel)


def _jax_specs(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_path_str(path): tuple(spec) for path, spec in flat}


def _check_param_specs(tmodel, params):
    want = _jax_specs(jmake_param_specs(params))
    got = make_param_specs(tmodel)
    assert {p.replace("/", ".") for p in want} == set(got)
    for path, spec in want.items():
        assert got[path.replace("/", ".")] == spec, path
    assert any(spec for spec in want.values())


def test_param_specs_equal_jax(models):
    _check_param_specs(*models)


def test_int8_param_specs_equal_jax(models):
    tmodel, params = models
    qmodel = quantize_int8_(NUWA(**CFG, device="cpu", seed=0))
    qparams = quantize_params_int8(params)
    specs = make_param_specs(qmodel)
    assert any(path.endswith("w_scale") and spec for path, spec in specs.items())
    _check_param_specs(qmodel, qparams)


@pytest.fixture(scope="module")
def jax_zero(models):
    """The JAX trainer's optax state and its ZeRO-1 specs on 4 of the 8 CPU
    devices, as (data 2, model 2)."""
    _, params = models
    tx = jget_optimizer(lr=1e-3, wd=0.01, params=params, max_grad_norm=0.5)
    state = tx.init(params)
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    leaves = {_path_str(path): np.asarray(leaf) for path, leaf in flat}
    return leaves, _jax_specs(jzero_opt_specs(state, mesh))


def test_zero_opt_specs_equal_jax(jax_zero):
    leaves, want = jax_zero
    got = zero_opt_specs(leaves, MESH)
    assert got == want
    assert sum("data" in spec for spec in want.values()) > 10


def test_zero1_moments_are_placed_as_jax(models, jax_zero):
    """Each trained parameter of the port gets the spec of JAX's ``mu`` leaf
    at its path: the layout ``Zero1AdamW`` gives its moments."""
    tmodel, _ = models
    _, want = jax_zero
    mu = {path.split("/.mu/", 1)[1]: spec for path, spec in want.items() if "/.mu/" in path}
    got = {jax_path(tmodel, name).replace(".", "/"): _zero_spec(jax_path(tmodel, name), p,
                                                                 MESH, "data")
           for name, p in tmodel.named_parameters()}
    assert got == mu


def test_parallel_exports_cover_jax_but_a8b():
    """The JAX package's ``parallel`` names, but for the pipeline's (context
    and pipeline parallelism are ROADMAP A8b), are the port's too."""
    import nuwa_tpu.parallel as jparallel

    import nuwa_tpu_torch.parallel as tparallel

    a8b = {"pipelined_transformer", "stack_stage_params", "validate_stages"}
    assert set(jparallel.__all__) - a8b <= set(tparallel.__all__)
    for name in tparallel.__all__:
        assert getattr(tparallel, name) is not None, name
