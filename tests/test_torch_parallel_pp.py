"""The port's pipeline parallelism (``nuwa_tpu_torch.parallel.pipeline``) over
a gloo group of four processes on the CPU, against the JAX package's
pipeline and the unmeshed port.

The two pipelined functions at the JAX package's tests/test_parallel.py
sizes, against JAX's ``pipelined_transformer`` / ``pipelined_dual_decoder``
jitted on a mesh of the conftest's virtual devices (one compile a case) and
against the unpipelined port: the plain stack at (data 2, pipe 2, M 2) and
(pipe 4, M 4); the NUWA-decoder-shaped stack (Sparse3DNA with the dilation
cycle (1, 2), token shift, cross-attention to a masked context); the
reversible stack with cross couples; the dual decoder, plain and
reversible; PPxTP on a hand-built (pipe 2, model 2) mesh. Each compares the
output, every parameter gradient and the input's and the context's
gradients (forward atol / rtol 1e-5, gradients atol 1e-5 / rtol 1e-4, JAX's
tests' tolerances). The three models with ``pp_mesh`` on (data 2, pipe 2),
M 2 (NUWA plain and reversible, NUWASketch with a depth-4 decoder,
NUWAVideoAudio plain, with ``dec_remat`` and reversible): the loss and
every gradient against ``jax.value_and_grad`` of the unmeshed JAX model,
jitted (loss rtol 1e-5, gradients atol 1e-5 / rtol 1e-3, as there). NUWA
with attention and feed-forward dropout 0.1: the loss and gradients of the
unmeshed port with the same generator (the masks are keyed by global rows
and layers). ``NUWATrainer(pipeline_parallel=True)``, 2 steps against the
unmeshed trainer (losses rtol 2e-4, parameters atol 3e-5 / rtol 3e-4, as in
tests/test_torch_parallel_nuwa.py): PPxDP, the reversible decoder, PPxZeRO-1
(each rank's stack parameter bytes 1/S of the whole, its stack moment bytes
1/(S * data)), the step-0 sample's ids; the resumes: an unmeshed trainer's
flat file, a JAX PP-layout file (written by ``nuwa_tpu.train.checkpoint``
with the layers through JAX's ``stack_stage_params``), and the PP trainer's
own file, whose resumed step equals the uninterrupted one bit for bit.

One group runs every case once (the ``runs`` fixture, through
tests/test_torch_gloo.py's ``spawn_group``) while this process computes the
references; every rank saves its results and each test merges them (a
stage's gradients come from the rank that holds the stage).
"""
import shutil
import sys

import numpy as np
import pytest
import torch
from test_torch_gloo import init_rank, run_rank, spawn_group

WORLD = 4
TR = dict(dim=32, depth=4, causal=True, heads=2, dim_head=16)
# (module kind, config, batch, tokens, mesh, microbatches, data axis)
FN_CASES = {
    "plain_dp": ("plain", TR, 8, 16, "dp", 2, "data"),
    "plain_pipe4": ("plain", TR, 4, 16, "pipe4", 4, None),
    "nuwa_decoder": ("plain", dict(TR, cross_attend=True, sparse_3dna_attn=True,
                                   sparse_3dna_video_shape=(2, 2, 2), sparse_3dna_dilations=(1, 2),
                                   shift_video_tokens=True), 4, 9, "dp", 2, "data"),
    "reversible": ("reversible", dict(TR, cross_attend=True), 4, 16, "dp", 2, "data"),
    "pptp": ("plain", dict(TR, heads=4, dim_head=8), 4, 16, "pptp", 2, None),
    "dual": ("dual", None, 4, 9, "dp", 2, "data"),
    "dual_reversible": ("dual_reversible", None, 4, 9, "dp", 2, "data"),
}
DUAL = dict(dim=16, depth=2, heads=2, dim_head=8, num_video_tokens_per_frame=4,
            num_audio_tokens_per_video_frame=3, sparse_3dna_video_shape=(2, 2, 2),
            sparse_2dna_kernel_size=3, cross_modality_attn_every=1)
NUWA = dict(dim=16, image_size=2, num_image_tokens=16, max_video_frames=2, text_num_tokens=32,
            text_max_seq_len=8, text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2,
            dec_depth=2, dec_dim_head=8, dec_heads=2, shift_video_tokens=False)
VAE = dict(dim=8, image_size=8, num_layers=2, vq_codebook_size=16, vq_codebook_dim=8,
           resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
           num_resnet_blocks=0)
SKETCH = dict(dim=16, image_size=8, max_video_frames=8, sketch_max_video_frames=1,
              sketch_enc_depth=1, sketch_enc_dim_head=8, sketch_enc_heads=2, dec_depth=4,
              dec_dim_head=8, dec_heads=2, sparse_3dna_kernel_size=3, sparse_3dna_dilation=(1, 2))
VIDEO_AUDIO = dict(dim=16, image_size=8, num_audio_tokens=12, num_audio_tokens_per_video_frame=3,
                   max_video_frames=2, text_num_tokens=32, text_max_seq_len=16, text_enc_depth=1,
                   text_enc_dim_head=8, text_enc_heads=2, dec_depth=2, dec_dim_head=8,
                   dec_heads=2, cross_modality_attn_every=1, sparse_2dna_kernel_size=3)
MODELS = ["nuwa", "nuwa_reversible", "sketch", "dual", "dual_remat", "dual_reversible"]
# the trainers' NUWA: decoder depth 4 with the dilation cycle (1, 2), one cycle a stage
TRAIN_NUWA = dict(NUWA, dec_depth=4, sparse_3dna_dilation=(1, 2), shift_video_tokens=True)
TRAIN = dict(num_train_steps=2, batch_size=4, grad_accum_every=2, save_results_every=10**9,
             seed=5)
TRAINERS = {"pp_dp": {}, "reversible": {"dec_reversible": True}, "zero1": {"zero1": True}}
PP = dict(pipeline_parallel=True, pipeline_microbatches=2)


def _rnd(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _fn_module(name):
    from nuwa_tpu_torch.core.layers import init_weights_
    from nuwa_tpu_torch.dual_decoder import DualModalityDecoder, ReversibleDualModalityDecoder
    from nuwa_tpu_torch.transformer import ReversibleTransformer, Transformer

    kind, cfg = FN_CASES[name][:2]
    cls = {"plain": Transformer, "reversible": ReversibleTransformer,
           "dual": DualModalityDecoder, "dual_reversible": ReversibleDualModalityDecoder}[kind]
    return init_weights_(cls(**(DUAL if cfg is None else cfg)), 3)


def _fn_inputs(name):
    """The case's inputs (numpy): the stream(s), the context and its mask,
    and the loss's weights."""
    _, cfg, b, n, *_ = FN_CASES[name]
    if cfg is None:  # the dual decoder: video (bos + 2 frames of 4), audio (bos + 6)
        cmask = np.ones((b, 5), bool)
        cmask[:, 4:] = False
        return dict(video=_rnd(b, n, 16, seed=1), audio=_rnd(b, 7, 16, seed=2),
                    context=_rnd(b, 5, 16, seed=3), context_mask=cmask,
                    w_video=_rnd(b, n, 16, seed=4), w_audio=_rnd(b, 7, 16, seed=5))
    out = dict(x=_rnd(b, n, 32, seed=1), w=_rnd(b, n, 32, seed=2))
    if cfg.get("cross_attend"):
        cmask = np.ones((b, 6), bool)
        cmask[:, 4:] = False
        out.update(context=_rnd(b, 6, 32, seed=3), context_mask=cmask)
    return out


def _fn_loss(outs, inputs, rows, total):
    """Sum of the outputs times the loss weights over the whole batch's
    elements (this rank's rows of it)."""
    names = ("w_video", "w_audio") if "w_video" in inputs else ("w",)
    return sum((o * torch.from_numpy(inputs[k])[rows]).sum() / total[k]
               for o, k in zip(outs, names))


def _gather_rows(t, mesh, axis):
    import torch.distributed as dist

    from nuwa_tpu_torch.parallel.mesh import axis_size

    if axis is None or axis_size(mesh, axis) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts)


def _fn_case(name, mesh=None):
    """The pipelined function on ``mesh`` (or the unpipelined module): the
    output, {JAX path: gradient} of the parameters this rank ran (summed
    over 'data', whole over 'model') and the inputs' gradients."""
    import torch.distributed as dist

    from nuwa_tpu_torch.convert import jax_path
    from nuwa_tpu_torch.core.tp import shard_of
    from nuwa_tpu_torch.parallel import pipelined_transformer, shard_params
    from nuwa_tpu_torch.parallel.pipeline import pipelined_dual_decoder
    from nuwa_tpu_torch.parallel.sharding import data_rows

    kind, _, b, _, _, M, data_axis = FN_CASES[name]
    module, inputs = _fn_module(name), _fn_inputs(name)
    if mesh is not None:
        shard_params(module, mesh)
    rows = data_rows(mesh, b) if mesh is not None and data_axis else slice(None)
    streams = ("video", "audio") if kind.startswith("dual") else ("x",)
    tensors = {k: torch.from_numpy(inputs[k])[rows].requires_grad_()
               for k in (*streams, "context") if k in inputs}
    cmask = inputs.get("context_mask")
    kw = dict(context=tensors.get("context"),
              context_mask=None if cmask is None else torch.from_numpy(cmask)[rows])
    if mesh is None:
        outs = module(*(tensors[k] for k in streams), **kw)
    elif kind.startswith("dual"):
        outs = pipelined_dual_decoder(module, tensors["video"], tensors["audio"], mesh,
                                      num_microbatches=M, data_axis=data_axis, **kw)
    else:
        outs = pipelined_transformer(module, tensors["x"], mesh, num_microbatches=M,
                                     data_axis=data_axis, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = {k: v.size for k, v in inputs.items() if k.startswith("w")}
    _fn_loss(outs, inputs, rows, total).backward()
    grads = {}
    for n, p in module.named_parameters():
        if p.grad is None:
            continue
        g = p.grad
        if mesh is not None and data_axis:
            dist.all_reduce(g, group=mesh.get_group(data_axis))
        grads[jax_path(module, n)] = p.tp.gather(g) if shard_of(p) is not None else g
    axis = data_axis if mesh is not None else None
    return {"outs": [_gather_rows(o.detach(), mesh, axis) for o in outs],
            "inputs": {k: _gather_rows(t.grad, mesh, axis) for k, t in tensors.items()},
            "grads": grads}


def _fn_jax(name):
    """JAX's pipelined function on the conftest's virtual devices, jitted:
    the output, the parameter gradients and the inputs' gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from nuwa_tpu import dual_decoder as jdual
    from nuwa_tpu import transformer as jtransformer
    from nuwa_tpu.parallel import make_param_specs
    from nuwa_tpu.parallel.pipeline import pipelined_dual_decoder, pipelined_transformer
    from nuwa_tpu_torch.convert import flatten_params
    from test_torch_sketch import jax_params

    kind, cfg, b, _, layout, M, data_axis = FN_CASES[name]
    cls = {"plain": jtransformer.Transformer, "reversible": jtransformer.ReversibleTransformer,
           "dual": jdual.DualModalityDecoder,
           "dual_reversible": jdual.ReversibleDualModalityDecoder}[kind]
    jmod = cls(**(DUAL if cfg is None else cfg))
    params = jax_params(jmod, _fn_module(name))
    inputs = _fn_inputs(name)
    devices = np.asarray(jax.devices()[:4])
    mesh = {"dp": Mesh(devices.reshape(2, 2), ("data", "pipe")),
            "pipe4": Mesh(devices, ("pipe",)),
            "pptp": Mesh(devices.reshape(2, 2), ("pipe", "model"))}[layout]
    if layout == "pptp":  # the TP rules' splits, JAX's tests/test_parallel.py placement
        def place(leaf, spec):
            for ax, axis in enumerate(spec):
                if axis is not None and leaf.shape[ax] % mesh.shape[axis]:
                    spec = PartitionSpec()
                    break
            return jax.device_put(leaf, NamedSharding(mesh, spec))

        params = jax.tree.map(place, params, make_param_specs(params))
    streams = ("video", "audio") if cfg is None else ("x",)
    cmask = inputs.get("context_mask")

    def loss(p, xs, context):
        kw = dict(num_microbatches=M, data_axis=data_axis, context=context, context_mask=cmask)
        if cfg is None:
            outs = pipelined_dual_decoder(jmod, p, *xs, mesh, **kw)
        else:
            outs = (pipelined_transformer(jmod, p, *xs, mesh, **kw),)
        ws = (inputs["w_video"], inputs["w_audio"]) if cfg is None else (inputs["w"],)
        return sum(jnp.sum(o * w) / w.size for o, w in zip(outs, ws)), outs

    xs = tuple(inputs[k] for k in streams)
    (_, outs), (gp, gxs, gc) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                          has_aux=True))(
        params, xs, inputs.get("context"))
    grads = dict(zip(streams, gxs))
    if gc is not None:
        grads["context"] = gc
    return {"outs": [np.asarray(o) for o in outs],
            "inputs": {k: np.asarray(v) for k, v in grads.items()},
            "grads": flatten_params(jax.tree.map(np.asarray, gp))}


# ---- the models -------------------------------------------------------------


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
    return NUWAVideoAudio(vae=VQGanVAE(**VAE, device="cpu", seed=1), **VIDEO_AUDIO,
                          dec_reversible=name.endswith("reversible"),
                          dec_remat=name.endswith("remat"), device="cpu", seed=0)


def _model_inputs(name):
    """The model's batch of 4 as keyword arguments (numpy)."""
    rng = np.random.default_rng(1)
    text = np.array([[1, 2, 3, 0], [5, 6, 7, 8], [4, 0, 0, 0], [9, 10, 0, 0]])
    if name.startswith("nuwa"):
        return dict(text=text, video=rng.integers(0, 16, (4, 2 * 4)))
    if name == "sketch":
        return dict(sketch=rng.uniform(0, 1, (4, 1, 5, 8, 8)).astype(np.float32),
                    video=rng.uniform(0, 1, (4, 8, 3, 8, 8)).astype(np.float32))
    return dict(text=text, video=rng.uniform(0, 1, (4, 2, 3, 8, 8)).astype(np.float32),
                audio=rng.integers(0, 12, (4, 2 * 3)))


def _model_case(name, mesh=None, **train):
    """The model's loss (averaged over 'data') and {JAX path: gradient}
    (averaged over 'data') of the parameters this rank ran, with ``pp_mesh``
    on ``mesh``; each data rank its rows."""
    import torch.distributed as dist

    from nuwa_tpu_torch.convert import jax_path
    from nuwa_tpu_torch.parallel.sharding import all_reduce_grads_, all_reduce_mean, data_rows

    model = _model(name, **train.pop("model_kw", {}))
    inputs = _model_inputs(name)
    rows = data_rows(mesh, 4) if mesh is not None else slice(None)
    args = [inputs[k][rows] for k in ("sketch" if name == "sketch" else "text", "video", "audio")
            if k in inputs]
    kw = dict(train)
    if mesh is not None:
        kw.update(pp_mesh=mesh, pp_microbatches=2, pp_data_axis="data")
        if name.startswith("nuwa"):
            kw["row0"] = rows.start
    loss = model(*args, return_loss=True, **kw)
    loss.backward()
    params = [p for p in model.parameters() if p.grad is not None]
    if mesh is not None:
        all_reduce_grads_(params, mesh)
        loss = all_reduce_mean(loss, mesh)
        dist.barrier()
    return {"loss": loss.item(),
            "grads": {jax_path(model, n): p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}}


def _model_jax(name):
    """JAX's loss and gradients of the unmeshed JAX model with the port's
    weights, jitted."""
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
        jmodel = JNUWAVideoAudio(vae=JVQGanVAE(**VAE), **VIDEO_AUDIO,
                                 dec_reversible=name.endswith("reversible"),
                                 dec_remat=name.endswith("remat"))
    params = jax_params(jmodel, _model(name))
    inputs = _model_inputs(name)
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.forward(p, **inputs, return_loss=True)))(params)
    return {"loss": float(value), "grads": flatten_params(jax.tree.map(np.asarray, grads))}


def _dropout_case(mesh=None):
    return _model_case("nuwa", mesh, train=True, cond_dropout_prob=0.0,
                       model_kw=dict(attn_dropout=0.1, ff_dropout=0.1),
                       generator=torch.Generator().manual_seed(3))


# ---- the trainers -----------------------------------------------------------


class _Toy:
    """Seeded (text, video ids) pairs of 2 frames of 2 x 2 tokens; ``same``:
    every pair the first (one batch, whatever the order)."""

    def __init__(self, same=False):
        self.same = same

    def __len__(self):
        return 16

    def __getitem__(self, i):
        rng = np.random.default_rng(0 if self.same else i)
        return (rng.integers(1, 30, size=4).astype(np.int64),
                rng.integers(0, 16, size=2 * 4).astype(np.int64))


def _trainer(mesh, model_kw=(), seed=0, **kw):
    from nuwa_tpu_torch import NUWA as TNUWA
    from nuwa_tpu_torch.train import NUWATrainer

    kw = dict(TRAIN, **kw)
    nuwa = TNUWA(**TRAIN_NUWA, **dict(model_kw), device="cpu", seed=seed)
    return NUWATrainer(nuwa=nuwa, dataset=kw.pop("dataset", _Toy()), mesh=mesh, **kw)


def _whole_params(t):
    from nuwa_tpu_torch.convert import export_jax_params

    with t._stack():
        return {k: v.clone() for k, v in export_jax_params(t.nuwa).items()}


def _stack_bytes(t):
    """(bytes of this rank's stack parameters, of their AdamW moments), and
    the whole stack's parameter bytes."""
    from nuwa_tpu_torch.parallel.zero import Zero1AdamW

    stack = {id(p) for p in t.nuwa.video_transformer.layers.parameters()}
    mine = [p for p in t.params if id(p) in stack]
    if isinstance(t.opt, Zero1AdamW):
        leaves = [leaf for p, _, leaf in t.opt.slots if id(p) in stack]
        states = [t.opt.opt.state[leaf] for leaf in leaves]
    else:
        states = [t.opt.state[p] for p in mine]
    moments = sum(v.numel() * v.element_size() for s in states for k, v in s.items()
                  if k != "step")
    with t._stack(gather=False):
        whole = sum(p.numel() * p.element_size()
                    for p in t.nuwa.video_transformer.layers.parameters())
    return {"params": sum(p.numel() * p.element_size() for p in mine), "moments": moments,
            "whole": whole}


def _train(mesh, name):
    """2 steps: the losses, the parameters after them, the step-0 sample's
    ids (and under a mesh the stack's bytes)."""
    kw = dict(TRAINERS[name])
    model_kw = {k: kw.pop(k) for k in ("dec_reversible",) if k in kw}
    if mesh is None:
        kw.pop("zero1", None)
    else:
        kw.update(PP)
    t = _trainer(mesh, model_kw, **kw)
    logs = []
    t.train(log_fn=logs.append)
    out = {"losses": [x["loss"] for x in logs], "params": _whole_params(t),
           "sample": torch.as_tensor(logs[0]["sampled_indices"])}
    if mesh is not None:
        out["bytes"] = _stack_bytes(t)
    return out


def _resume_kw(folder, **kw):
    return dict(dataset=_Toy(same=True), cond_dropout_prob=0.5, results_folder=folder,
                **kw)


def _resumed(mesh, folder, steps=1, **kw):
    """A trainer over other weights resumed from ``folder``: the step it
    resumed at, its parameters then, and after ``steps`` more its losses
    and parameters."""
    t = _trainer(mesh, seed=9, resume=True, **_resume_kw(folder, **kw))
    out = {"step": t.step, "resumed": _whole_params(t)}
    out["losses"] = [t.train_step()["loss"] for _ in range(steps)]
    out["params"] = _whole_params(t)
    return out


def _pp_saves(mesh, folder):
    """The PP trainer's own file: 2 steps saving after each, then step 3
    unsaved: its loss and parameters."""
    t = _trainer(mesh, seed=1, save_model_every=1, **PP, **_resume_kw(folder))
    for _ in range(2):
        t.train_step()
    t.save_model_every = None
    return {"loss": t.train_step()["loss"], "params": _whole_params(t)}


def _write_jax_files(tmp):
    """A JAX train state of the trainers' NUWA (the port's seed-9 weights,
    moments 0.25, count 4) written by JAX's checkpoint writer twice: with
    the decoder's layers through JAX's ``stack_stage_params`` over 2 stages
    (the JAX PP trainer's layout) and flat."""
    import jax
    import jax.numpy as jnp

    from nuwa_tpu.models import NUWA as JNUWA
    from nuwa_tpu.parallel.pipeline import stack_stage_params
    from nuwa_tpu.train import checkpoint as jckpt
    from nuwa_tpu.train import optimizer as jopt
    from nuwa_tpu_torch import NUWA as TNUWA
    from test_torch_sketch import jax_params

    flat = jax_params(JNUWA(**TRAIN_NUWA), TNUWA(**TRAIN_NUWA, device="cpu", seed=7))
    vt = flat["video_transformer"]
    stacked = dict(flat, video_transformer=dict(vt, layers=stack_stage_params(vt["layers"], 2)))
    for folder, params in (("jax_pp", stacked), ("jax_flat", flat)):
        tx = jopt.get_optimizer(lr=3e-4, wd=0.01, params=params, max_grad_norm=0.5)
        opt = jax.tree.map(lambda x: x + (0.25 if x.dtype == jnp.float32 else 4),
                           tx.init(params))
        jckpt.save_checkpoint(tmp / folder, "nuwa_trainstate", 3, {
            "params": params, "opt": opt, "step": jnp.asarray(4, jnp.int32),
            "key": jax.random.PRNGKey(0)})


def _worker(rank, world, tmp):
    """Every pipelined case on this rank; every rank saves its results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from nuwa_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, tmp)
    meshes = {"dp": make_mesh(data=2, pipe=2, device="cpu"),
              "pipe4": make_mesh(pipe=4, device="cpu"),
              "pptp": init_device_mesh("cpu", (2, 2), mesh_dim_names=("pipe", "model"))}
    mesh = meshes["dp"]
    out = {"mesh": (mesh.mesh_dim_names, tuple(mesh.shape), mesh.get_local_rank("pipe"))}
    out.update({("fn", name): _fn_case(name, meshes[FN_CASES[name][4]]) for name in FN_CASES})
    out.update({("model", name): _model_case(name, mesh) for name in MODELS})
    out["dropout"] = _dropout_case(mesh)
    out.update({("train", name): _train(mesh, name) for name in TRAINERS})
    out["flat_resumes"] = _resumed(mesh, f"{tmp}/unmeshed", **PP)
    out["jax_resumes"] = _resumed(mesh, f"{tmp}/jax_pp", **PP)
    out["pp_saves"] = _pp_saves(mesh, f"{tmp}/pp")
    dist.barrier()
    out["pp_resumes"] = _resumed(mesh, f"{tmp}/pp", **PP)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    torch.set_num_threads(1)
    _write_jax_files(tmp)
    # an unmeshed trainer's flat file for the PP trainer to resume
    t = _trainer(None, seed=1, save_model_every=1, **_resume_kw(tmp / "unmeshed"))
    for _ in range(2):
        t.train_step()
    refs = {"unmeshed_saved": _whole_params(t)}
    shutil.copytree(tmp / "unmeshed", tmp / "unmeshed_ref")

    def references():
        for name in FN_CASES:
            refs[("fn", name)] = _fn_case(name)
            refs[("fn_jax", name)] = _fn_jax(name)
        for name in MODELS:
            refs[("model", name)] = _model_case(name)
            refs[("model_jax", name)] = _model_jax(name)
        refs["dropout"] = _dropout_case()
        for name in ("pp_dp", "reversible"):
            refs[("train", name)] = _train(None, name)
        refs[("train", "zero1")] = refs[("train", "pp_dp")]  # ZeRO-1 does not change the math
        refs["jax_resumes"] = _resumed(None, tmp / "jax_flat")

    spawn_group(__file__, WORLD, tmp, work=references)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)], refs


def _merged(ranks, key, part="grads"):
    """{path: tensor} of every rank's ``part`` of case ``key``; a path held
    by several ranks (a replicated parameter, a 'data' sum) must be equal
    on each."""
    out = {}
    for r in ranks:
        for path, g in r[key][part].items():
            if path in out:
                torch.testing.assert_close(g, out[path], rtol=0, atol=0, msg=path)
            out[path] = g
    return out


def _close(got, want, atol, rtol, what):
    for path, w in want.items():
        w = np.asarray(w)
        assert path in got, f"{what}: no {path}"
        np.testing.assert_allclose(got[path].numpy(), w, atol=atol, rtol=rtol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", list(FN_CASES))
def test_pipelined_function_matches_jax_and_unpipelined(runs, name):
    ranks, refs = runs
    got = ranks[0][("fn", name)]
    for want in (refs[("fn_jax", name)], refs[("fn", name)]):
        for g, w in zip(got["outs"], want["outs"], strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        _close(got["inputs"], want["inputs"], 1e-5, 1e-4, name)
        grads = _merged(ranks, ("fn", name))
        assert set(grads) == set(want["grads"])
        _close(grads, want["grads"], 1e-5, 1e-4, name)


@pytest.mark.parametrize("name", MODELS)
def test_model_pp_mesh_loss_and_grads_match_jax_and_unmeshed(runs, name):
    ranks, refs = runs
    grads = _merged(ranks, ("model", name))
    for want in (refs[("model_jax", name)], refs[("model", name)]):
        np.testing.assert_allclose(ranks[0][("model", name)]["loss"], want["loss"], rtol=1e-5)
        # JAX's tree also holds the frozen codecs', whose gradients are 0
        for path in set(want["grads"]) - set(grads):
            assert not np.asarray(want["grads"][path]).any(), path
        _close(grads, {p: w for p, w in want["grads"].items() if p in grads}, 1e-5, 1e-3, name)


def test_pp_dropout_drops_what_the_unmeshed_port_drops(runs):
    ranks, refs = runs
    np.testing.assert_allclose(ranks[0]["dropout"]["loss"], refs["dropout"]["loss"], rtol=1e-5)
    grads = _merged(ranks, "dropout")
    assert set(grads) == set(refs["dropout"]["grads"])
    _close(grads, refs["dropout"]["grads"], 1e-5, 1e-3, "dropout")


def _close_params(got, want):
    assert set(got) == set(want)
    _close(got, want, 3e-5, 3e-4, "params")


@pytest.mark.parametrize("name", list(TRAINERS))
def test_pp_trainer_matches_unmeshed(runs, name):
    ranks, refs = runs
    want = refs[("train", name)]
    for r in ranks:
        got = r[("train", name)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
        _close_params(got["params"], want["params"])


@pytest.mark.parametrize("name", list(TRAINERS))
def test_pp_trainer_holds_its_stage_alone(runs, name):
    """Stack parameters 1/S of the whole on each rank, their moments 1/S,
    or 1/(S * data) with zero1 (every stack tensor divides by 'data')."""
    for r in runs[0]:
        got = r[("train", name)]["bytes"]
        assert got["params"] * 2 == got["whole"], got
        assert got["moments"] * (4 if name == "zero1" else 2) == 2 * got["whole"], got


def test_pp_trainer_samples_the_unmeshed_ids(runs):
    ranks, refs = runs
    for r in ranks:
        np.testing.assert_array_equal(r[("train", "pp_dp")]["sample"],
                                      refs[("train", "pp_dp")]["sample"])


def test_pp_trainer_resumes_an_unmeshed_flat_file(runs):
    ranks, refs = runs
    got = ranks[0]["flat_resumes"]
    assert got["step"] == 2
    for path, w in refs["unmeshed_saved"].items():
        torch.testing.assert_close(got["resumed"][path], w, rtol=0, atol=0, msg=path)


def test_pp_trainer_resumes_a_jax_pp_layout_file(runs):
    """The JAX PP file's weights land in the whole model, its step carries
    over, and the next step is the unmeshed trainer's from the same state
    written flat."""
    ranks, refs = runs
    want = refs["jax_resumes"]
    for r in ranks:
        got = r["jax_resumes"]
        assert got["step"] == want["step"] == 4
        _close(got["resumed"], {k: v.numpy() for k, v in want["resumed"].items()}, 0, 0,
               "resumed")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
        _close_params(got["params"], want["params"])


def test_pp_trainer_resumes_its_own_file_as_the_uninterrupted_run(runs):
    for r in runs[0]:
        assert r["pp_resumes"]["step"] == 2
        assert r["pp_resumes"]["losses"] == [r["pp_saves"]["loss"]]
        for path, w in r["pp_saves"]["params"].items():
            torch.testing.assert_close(r["pp_resumes"]["params"][path], w, rtol=0, atol=0,
                                       msg=path)


def test_make_mesh_pipe_is_jax_data_by_pipe(runs):
    """``make_mesh(data=2, pipe=2)``: a ("data", "pipe") mesh, rank = data
    index * pipe + pipe index (JAX's ``reshape(data, pipe)``)."""
    for rank, r in enumerate(runs[0]):
        assert r["mesh"] == (("data", "pipe"), (2, 2), rank % 2)


if __name__ == "__main__":
    run_rank(_worker, sys.argv[1:])
