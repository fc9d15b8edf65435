"""The port's context parallelism over a gloo group of four processes on the
CPU, against the JAX package's CPU result and the unmeshed port.

Models (the sizes of the JAX package's tests/test_parallel.py CP tests:
dim 16, 2 heads of 8, depth 2, 8 frames of 2 x 2 tokens, Sparse3DNA kernel
3 with dilations 1 and 2, so that at four ranks a rank's 2 frames are
fewer than the 4-frame lookback): NUWA plain and reversible, NUWASketch
with a centered Sparse3DNA sketch encoder over 4 sketch frames (halos both
ways), NUWAVideoAudio plain and reversible (through ``BindCP``; its audio
stream runs whole). Each model's logits, loss and gradients with
``cp_mesh`` on two meshes: the frames over 'data' (data 4) and over
'context' (data 2, context 2); fp32, the logits within 1e-4 of their max
abs, the loss within rtol 1e-4, every gradient within 1e-3 of its max abs
of JAX's (``jax.value_and_grad`` of the unmeshed JAX model) and of the
unmeshed port's. NUWA with attention and feed-forward dropout 0.1 (the
frames over 'data'): loss and gradients those of the unmeshed port with
the same generator, as the masks are keyed by the whole sequence's token
ids. ``NUWATrainer(context_parallel=True)``: 2 steps with the frames over
'data' (every rank the whole batch), and DPxCP over (data 2, context 2)
without and with dropout 0.1 (each data rank its rows), against the
unmeshed trainer: losses rtol 2e-4, parameters atol 3e-5 / rtol 3e-4, the
tolerances of tests/test_torch_parallel_nuwa.py. NUWA plain and reversible on 5
frames over (data 1, context 4), where the last rank owns no frame (it
takes part in every collective all the same), against JAX and the
unmeshed port as above. ``context_parallel_sparse_3dna``
itself on (data 2, context 2) with dropout 0.1, an int seed and
``data_axis="data"``, each data rank its rows of a batch of 4 (JAX's
``b_base``): the rows gathered equal the unmeshed layer's output on the
whole batch within 1e-5 of its max abs.

One group runs every case once (the ``runs`` fixture, through
tests/test_torch_gloo.py's ``spawn_group``) while this process computes the
references; rank 0 saves its results; each test asserts one case.
"""
import sys

import numpy as np
import pytest
import torch
from test_torch_gloo import init_rank, run_rank, spawn_group

WORLD = 4
LAYOUTS = {"data": dict(data=4), "context": dict(data=2, context=2),
           "context4": dict(data=1, context=4)}
# NUWA on 5 frames over context 4: the last rank owns no frame
EMPTY_RANK = ["nuwa", "nuwa_reversible"]
EMPTY_FRAMES = 5
NUWA = dict(dim=16, image_size=2, num_image_tokens=16, max_video_frames=8, text_num_tokens=32,
            text_max_seq_len=4, text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2,
            dec_depth=2, dec_dim_head=8, dec_heads=2, sparse_3dna_kernel_size=3,
            sparse_3dna_dilation=(1, 2), sparse_3dna_rel_pos_bias=True, shift_video_tokens=True)
VAE = dict(dim=8, image_size=8, num_layers=2, vq_codebook_size=16, vq_codebook_dim=8,
           resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
           num_resnet_blocks=0)
SKETCH = dict(dim=16, image_size=8, max_video_frames=8, sketch_max_video_frames=4,
              sketch_enc_depth=2, sketch_enc_dim_head=8, sketch_enc_heads=2,
              sketch_enc_use_sparse_3dna=True, dec_depth=2, dec_dim_head=8, dec_heads=2,
              sparse_3dna_kernel_size=3, sparse_3dna_dilation=(1, 2))
DUAL = dict(dim=16, image_size=8, num_audio_tokens=24, num_audio_tokens_per_video_frame=3,
            max_video_frames=8, text_num_tokens=32, text_max_seq_len=16, text_enc_depth=1,
            text_enc_dim_head=8, text_enc_heads=2, dec_depth=2, dec_dim_head=8, dec_heads=2,
            cross_modality_attn_every=2, sparse_3dna_dilation=(1, 2))
MODELS = ["nuwa", "nuwa_reversible", "sketch", "dual", "dual_reversible"]
TRAINERS = {"data": ("data", {}), "dpxcp": ("context", {}),
            "dpxcp_dropout": ("context", {"attn_dropout": 0.1, "ff_dropout": 0.1})}
TRAIN = dict(num_train_steps=2, batch_size=2, grad_accum_every=2, save_results_every=10**9,
             seed=5)


def _model(name, **kw):
    from nuwa_tpu_torch import NUWA as TNUWA
    from nuwa_tpu_torch import NUWASketch, NUWAVideoAudio, VQGanVAE

    if name.startswith("nuwa"):
        return TNUWA(**NUWA, dec_reversible=name.endswith("reversible"), **kw, device="cpu",
                     seed=0)
    if name == "sketch":
        return NUWASketch(vae=VQGanVAE(**VAE, device="cpu", seed=1),
                          sketch_vae=VQGanVAE(**VAE, channels=5, device="cpu", seed=2),
                          **SKETCH, device="cpu", seed=0)
    return NUWAVideoAudio(vae=VQGanVAE(**VAE, device="cpu", seed=1), **DUAL,
                          dec_reversible=name.endswith("reversible"), device="cpu", seed=0)


def _inputs(name, frames=8):
    """The model's batch of 2 as keyword arguments (numpy); NUWA's video
    ``frames`` long."""
    rng = np.random.default_rng(1)
    text = np.array([[1, 2, 3, 0], [5, 6, 7, 8]])
    if name.startswith("nuwa"):
        return dict(text=text, video=rng.integers(0, 16, (2, frames * 4)))
    video = rng.uniform(0, 1, (2, 8, 3, 8, 8)).astype(np.float32)
    if name == "sketch":
        return dict(sketch=rng.uniform(0, 1, (2, 4, 5, 8, 8)).astype(np.float32), video=video)
    return dict(text=text, video=video, audio=rng.integers(0, 24, (2, 8 * 3)))


def _call(model, name, inputs, **kw):
    args = [inputs[k] for k in ("sketch" if name == "sketch" else "text", "video", "audio")
            if k in inputs]
    return model(*args, **kw)


def _port_case(name, cp_mesh=None, frames=8, **train):
    """Logits, loss and {JAX path: gradient} of the port's model."""
    from nuwa_tpu_torch.convert import jax_path

    model = _model(name, **train.pop("model_kw", {}))
    inputs = _inputs(name, frames)
    with torch.no_grad():
        logits = _call(model, name, inputs, cp_mesh=cp_mesh)
    loss = _call(model, name, inputs, return_loss=True, cp_mesh=cp_mesh, **train)
    loss.backward()
    grads = {jax_path(model, n): p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    logits = logits if isinstance(logits, tuple) else (logits,)
    return {"logits": [x.clone() for x in logits], "loss": loss.item(), "grads": grads}


def _dropout_case(cp_mesh=None):
    return _port_case("nuwa", cp_mesh, train=True,
                      model_kw=dict(attn_dropout=0.1, ff_dropout=0.1),
                      generator=torch.Generator().manual_seed(3))


def _jax_case(name, frames=8):
    """JAX's logits, loss and gradients of the unmeshed JAX model with the
    port's weights."""
    import jax

    from nuwa_tpu.models import NUWA as JNUWA
    from nuwa_tpu.models import NUWASketch as JNUWASketch
    from nuwa_tpu.models import NUWAVideoAudio as JNUWAVideoAudio
    from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
    from nuwa_tpu_torch.convert import flatten_params
    from test_torch_sketch import jax_params

    if name.startswith("nuwa"):
        jmodel = JNUWA(**NUWA, dec_reversible=name.endswith("reversible"))
    elif name == "sketch":
        jmodel = JNUWASketch(vae=JVQGanVAE(**VAE), sketch_vae=JVQGanVAE(**VAE, channels=5),
                             **SKETCH)
    else:
        jmodel = JNUWAVideoAudio(vae=JVQGanVAE(**VAE), **DUAL,
                                 dec_reversible=name.endswith("reversible"))
    params = jax_params(jmodel, _model(name))
    inputs = _inputs(name, frames)

    def loss(p):
        logits = jmodel.forward(p, **inputs)
        return jmodel.forward(p, **inputs, return_loss=True), logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    logits = logits if isinstance(logits, tuple) else (logits,)
    return {"logits": [np.asarray(x) for x in logits], "loss": float(value),
            "grads": flatten_params(jax.tree.map(np.asarray, grads))}


class _Toy:
    """Seeded (text, video ids) pairs of 8 frames of 2 x 2 tokens."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.integers(1, 30, size=4).astype(np.int64),
                rng.integers(0, 16, size=8 * 4).astype(np.int64))


def _train(mesh, model_kw):
    """2 steps of ``NUWATrainer``, with ``context_parallel`` on a mesh:
    the losses and the parameters after them."""
    from nuwa_tpu_torch.convert import export_jax_params
    from nuwa_tpu_torch.train import NUWATrainer

    t = NUWATrainer(nuwa=_model("nuwa", **model_kw), dataset=_Toy(), mesh=mesh,
                    context_parallel=mesh is not None, **TRAIN)
    losses = []
    t.train(log_fn=lambda logs: losses.append(logs["loss"]))
    return {"losses": losses,
            "params": {k: v.clone() for k, v in export_jax_params(t.nuwa).items()}}


def _layer_case(mesh=None):
    """A Sparse3DNA with dropout 0.1 on a batch of 4 from an int seed:
    unmeshed, or with its frames over 'context' and each data rank its rows
    (``data_axis``), the rows gathered over 'data'."""
    import torch.distributed as dist

    from nuwa_tpu_torch.core.layers import init_weights_
    from nuwa_tpu_torch.nda import Sparse3DNA
    from nuwa_tpu_torch.parallel.context_parallel import context_parallel_sparse_3dna
    from nuwa_tpu_torch.parallel.sharding import data_rows

    mod = init_weights_(Sparse3DNA(dim=16, video_shape=(8, 2, 2), kernel_size=3, dilation=2,
                                   heads=2, dim_head=8, causal=True, rel_pos_bias=True,
                                   dropout=0.1), 4)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 32, 16)).astype(np.float32))
    with torch.no_grad():
        if mesh is None:
            return mod(x, seed=1234)
        out = context_parallel_sparse_3dna(mod, x[data_rows(mesh, 4)], mesh, "context",
                                           seed=1234, data_axis="data")
        parts = [torch.empty_like(out) for _ in range(2)]
        dist.all_gather(parts, out, group=mesh.get_group("data"))
    return torch.cat(parts)


def _worker(rank, world, tmp):
    """Every meshed case on this rank; rank 0 saves."""
    import torch.distributed as dist

    from nuwa_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, tmp)
    meshes = {name: make_mesh(**sizes, device="cpu") for name, sizes in LAYOUTS.items()}
    out = {(name, layout): _port_case(name, meshes[layout])
           for layout in ("data", "context") for name in MODELS}
    for name in EMPTY_RANK:
        out[(name, "empty")] = _port_case(name, meshes["context4"], EMPTY_FRAMES)
    out["dropout"] = _dropout_case(meshes["data"])
    out["layer"] = _layer_case(meshes["context"])
    for case, (layout, model_kw) in TRAINERS.items():
        out[case] = _train(meshes[layout], model_kw)
    if rank == 0:
        torch.save(out, f"{tmp}/meshed.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp")
    torch.set_num_threads(1)
    refs = {}

    def references():
        for name in MODELS:
            refs[name] = _port_case(name)
            refs[("jax", name)] = _jax_case(name)
        for name in EMPTY_RANK:
            refs[(name, "empty")] = _port_case(name, frames=EMPTY_FRAMES)
            refs[("jax", name, "empty")] = _jax_case(name, EMPTY_FRAMES)
        refs["dropout"] = _dropout_case()
        refs["layer"] = _layer_case()
        for model_kw in ({}, TRAINERS["dpxcp_dropout"][1]):
            refs[("train", bool(model_kw))] = _train(None, model_kw)

    spawn_group(__file__, WORLD, tmp, work=references)
    return torch.load(tmp / "meshed.pt"), refs


def _close(got, want):
    """Logits within 1e-4 of their max abs, the loss within rtol 1e-4,
    every gradient within 1e-3 of its max abs."""
    for g, w in zip(got["logits"], want["logits"], strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    # JAX's tree also holds the frozen codecs', whose gradients are 0
    assert set(got["grads"]) <= set(want["grads"])
    for path in set(want["grads"]) - set(got["grads"]):
        assert not np.asarray(want["grads"][path]).any(), path
    for path, w in want["grads"].items():
        if path not in got["grads"]:
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(got["grads"][path].numpy(), w,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-12), rtol=0, err_msg=path)


@pytest.mark.parametrize("layout", ["data", "context"])
@pytest.mark.parametrize("name", MODELS)
def test_cp_forward_loss_and_grads_match_jax_and_unmeshed(runs, name, layout):
    meshed, refs = runs
    _close(meshed[(name, layout)], refs[name])
    _close(meshed[(name, layout)], refs[("jax", name)])


@pytest.mark.parametrize("name", EMPTY_RANK)
def test_cp_with_a_rank_that_owns_no_frame_matches_jax_and_unmeshed(runs, name):
    meshed, refs = runs
    _close(meshed[(name, "empty")], refs[(name, "empty")])
    _close(meshed[(name, "empty")], refs[("jax", name, "empty")])


def test_cp_attention_dropout_matches_unmeshed(runs):
    meshed, refs = runs
    _close(meshed["dropout"], refs["dropout"])


def test_cp_layer_keys_dropout_by_the_global_rows_of_data_axis(runs):
    meshed, refs = runs
    want = refs["layer"].numpy()
    np.testing.assert_allclose(meshed["layer"].numpy(), want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("case", list(TRAINERS))
def test_context_parallel_trainer_matches_unmeshed(runs, case):
    meshed, refs = runs
    want = refs[("train", bool(TRAINERS[case][1]))]
    np.testing.assert_allclose(meshed[case]["losses"], want["losses"], rtol=2e-4)
    for path, w in want["params"].items():
        np.testing.assert_allclose(meshed[case]["params"][path].numpy(), w.numpy(), atol=3e-5,
                                   rtol=3e-4, err_msg=path)


if __name__ == "__main__":
    run_rank(_worker, sys.argv[1:])
