"""The port's data and tensor parallelism (``nuwa_tpu_torch.parallel``) on a
(data 2, model 2) mesh of four gloo processes on the CPU, against the
unmeshed port: ``NUWATrainer`` plain, with ``zero1`` and with attention
and feed-forward dropout 0.1 (the global rows of the dropout masks); one
``sharded_train_step`` with SGD;
checkpoints both ways between a meshed and an unmeshed trainer, and an
unmeshed checkpoint resumed under ``zero1``; cached
``generate`` of NUWA and NUWAVideoAudio at b = 8, each data replica
serving its half, fp32, bf16 and int8.

One group of four processes runs every case once for the file (the
``runs`` fixture, each rank running this file as a script through
tests/test_torch_gloo.py's ``spawn_group``, which fails the group at once
when a rank fails and within 300 s in all) while this process computes the
unmeshed references; each test asserts one case. The ranks also build a
("data", "model", "context") mesh. Tolerances are those of
the JAX package's tests/test_parallel.py: losses rtol 2e-4, parameters
atol 3e-5 / rtol 3e-4; sampled ids equal.
"""
import shutil
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch
from test_torch_gloo import init_rank, run_rank, spawn_group

WORLD = 4
CFG = dict(dim=16, image_size=2, num_image_tokens=16, max_video_frames=2, text_num_tokens=32,
           text_max_seq_len=4, text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2,
           dec_depth=2, dec_dim_head=8, dec_heads=2, shift_video_tokens=True)
TRAIN = dict(num_train_steps=3, batch_size=4, grad_accum_every=2, save_results_every=10**9,
             seed=11)
TRAINERS = {"plain": {}, "zero1": {"zero1": True},
            "dropout": {"attn_dropout": 0.1, "ff_dropout": 0.1}}
SERVING = [("nuwa", "float32"), ("nuwa", "bfloat16"), ("nuwa", "int8"),
           ("dual", "float32"), ("dual", "bfloat16"), ("dual", "int8")]


class _Toy:
    """Seeded (text, video ids) pairs, as tests/test_parallel.py's."""

    def __init__(self, video_tokens=8, vocab=16, n=32, same=False):
        self.video_tokens, self.vocab, self.n, self.same = video_tokens, vocab, n, same

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(0 if self.same else i)
        text = rng.integers(1, 30, size=4).astype(np.int64)
        return text, rng.integers(0, self.vocab, size=self.video_tokens).astype(np.int64)


def _nuwa(seed=0, **kw):
    from nuwa_tpu_torch import NUWA

    return NUWA(**CFG, **kw, device="cpu", seed=seed)


def _trainer(mesh, model_kw=(), seed=0, **kw):
    from nuwa_tpu_torch.train import NUWATrainer

    kw = dict(TRAIN, **kw)
    return NUWATrainer(nuwa=_nuwa(seed, **dict(model_kw)), dataset=kw.pop("dataset", _Toy()),
                       mesh=mesh, **kw)


def _whole(model, mesh):
    """{JAX path: whole tensor} of a (possibly split) model."""
    from nuwa_tpu_torch.convert import export_jax_params
    from nuwa_tpu_torch.parallel.sharding import gathered

    with gathered(model) if mesh is not None else nullcontext():
        return {k: v.clone() for k, v in export_jax_params(model).items()}


def _whole_params(trainer):
    return _whole(trainer.nuwa, trainer.mesh)


def _sgd_step(mesh):
    """One ``sharded_train_step`` with SGD at lr 0.5 (which, unlike AdamW
    after a clip, moves with the gradients' scale) on a batch of 4 with
    condition dropout 0.5 drawn for it from a fresh generator and
    attention and feed-forward dropout 0.1; unmeshed, the same step by
    hand. The loss and the parameters after it."""
    from nuwa_tpu_torch.ops.sampling import prob_mask_like
    from nuwa_tpu_torch.parallel import shard_params, sharded_train_step

    model = _nuwa(seed=6, attn_dropout=0.1, ff_dropout=0.1)
    if mesh is not None:
        shard_params(model, mesh)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad], lr=0.5)
    pairs = [_Toy()[i] for i in range(4)]
    text, video = (torch.from_numpy(np.stack(x)) for x in zip(*pairs))
    uncond = prob_mask_like((4,), 0.5, generator=torch.Generator().manual_seed(2))

    def loss_fn(text, video, uncond, row0=0):
        return model(text, video, return_loss=True, train=True, uncond=uncond, row0=row0,
                     generator=torch.Generator().manual_seed(3))

    if mesh is None:
        loss = loss_fn(text, video, uncond)
        loss.backward()
        opt.step()
        loss = loss.detach()
    else:
        loss = sharded_train_step(mesh, loss_fn, opt)(text, video, uncond)
    return {"loss": loss.item(), "params": _whole(model, mesh)}


def _train(mesh, name):
    kw = dict(TRAINERS[name])
    model_kw = {k: kw.pop(k) for k in ("attn_dropout", "ff_dropout") if k in kw}
    t = _trainer(mesh, model_kw, **kw)
    losses = []
    t.train(log_fn=lambda logs: losses.append(logs["loss"]))
    out = {"losses": losses, "params": _whole_params(t)}
    if name == "zero1":
        out["moment_bytes"] = t.opt.local_bytes()
        out["whole_bytes"] = sum(2 * p.numel() * p.element_size() for p in t.params)
    return out


def _resume_kw(folder, **kw):
    return dict(dataset=_Toy(same=True), cond_dropout_prob=0.5, results_folder=folder, **kw)


def _two_steps_saved(mesh, folder):
    """2 steps saving after each, then step 3: (its loss, its parameters)."""
    t = _trainer(mesh, seed=1, save_model_every=1, **_resume_kw(folder))
    for _ in range(2):
        t.train_step()
    t.save_model_every = None  # the folder's newest file stays step 1's
    return {"loss": t.train_step()["loss"], "params": _whole_params(t)}


def _resumed_step(mesh, folder, **kw):
    """A trainer over other weights resumed from ``folder`` takes its next
    step: (the step it resumed at, the loss, the parameters)."""
    t = _trainer(mesh, seed=9, resume=True, **_resume_kw(folder, **kw))
    step = t.step
    return {"step": step, "loss": t.train_step()["loss"], "params": _whole_params(t)}


def _serving_model(which, dtype):
    from nuwa_tpu_torch import NUWAVideoAudio, VQGanVAE
    from nuwa_tpu_torch.utils.quantize import quantize_int8_

    compute = "bfloat16" if dtype == "bfloat16" else None
    if which == "nuwa":
        model = _nuwa(seed=3, compute_dtype=compute)
    else:
        vae = VQGanVAE(dim=8, image_size=16, num_layers=1, vq_codebook_size=16,
                       vq_codebook_dim=8, resnet_groups=4, use_vgg_and_gan=False,
                       vq_kmeans_init=False, use_attn=False, num_resnet_blocks=0, device="cpu",
                       seed=4)
        model = NUWAVideoAudio(
            vae=vae, dim=16, image_size=16, num_audio_tokens=24,
            num_audio_tokens_per_video_frame=3, max_video_frames=2, text_num_tokens=32,
            text_max_seq_len=8, text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2,
            dec_depth=2, dec_dim_head=8, dec_heads=2, dec_reversible=False,
            cross_modality_attn_every=2, compute_dtype=compute, device="cpu", seed=5)
    return quantize_int8_(model) if dtype == "int8" else model


def _text(which):
    n = 4 if which == "nuwa" else 8
    text = torch.zeros(8, n, dtype=torch.long)
    text[:, :3] = torch.tensor([1, 2, 3])
    text[3, 1] = 9
    text[6, 0] = 7
    return text


def _generate(model, text):
    """Cached generate with CFG 2.0 from a seeded generator: the ids (video
    ids, or video and audio ids)."""
    out = model.generate(text, generator=torch.Generator().manual_seed(7), cond_scale=2.0,
                         decode_video=False)
    return out if isinstance(out, tuple) else (out,)


def _serve(mesh, which, dtype):
    """Each data replica serves its rows of the b = 8 request; every rank's
    ids gathered in row order."""
    import torch.distributed as dist

    from nuwa_tpu_torch.parallel import shard_params
    from nuwa_tpu_torch.parallel.mesh import axis_size
    from nuwa_tpu_torch.parallel.sharding import data_rows

    model = shard_params(_serving_model(which, dtype), mesh)
    text = _text(which)
    ids = _generate(model, text[data_rows(mesh, text.shape[0])])
    whole = []
    for part in ids:
        parts = [torch.empty_like(part) for _ in range(axis_size(mesh, "data"))]
        dist.all_gather(parts, part.contiguous(), group=mesh.get_group("data"))
        whole.append(torch.cat(parts))
    return whole


def _serve_unmeshed(which, dtype):
    """The same request's halves served one after the other on one
    process, each from the generator's seed, as each data replica does."""
    model, text = _serving_model(which, dtype), _text(which)
    halves = [_generate(model, text[rows]) for rows in (slice(0, 4), slice(4, 8))]
    return [torch.cat(parts) for parts in zip(*halves)]


def _worker(rank, world, tmp):
    """One rank: every case on the (data 2, model 2) mesh; rank 0 saves."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    init_rank(rank, world, tmp)
    from nuwa_tpu_torch.parallel import make_mesh

    cp_mesh = make_mesh(data=1, model=2, context=2, device="cpu")
    mesh = make_mesh(data=2, model=2, device="cpu")
    out = {"cp_mesh": (cp_mesh.mesh_dim_names, tuple(cp_mesh.shape),
                       cp_mesh.get_local_rank("context"))}
    out.update({name: _train(mesh, name) for name in TRAINERS})
    out["sgd"] = _sgd_step(mesh)
    out["meshed_saves"] = _two_steps_saved(mesh, f"{tmp}/meshed")
    out["meshed_resumes"] = _resumed_step(mesh, f"{tmp}/unmeshed_copy")
    out["zero1_resumes"] = _resumed_step(mesh, f"{tmp}/unmeshed_copy", zero1=True)
    out["serving"] = {case: _serve(mesh, *case) for case in SERVING}
    if rank == 0:
        torch.save(out, f"{tmp}/meshed.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    torch.set_num_threads(1)
    # an unmeshed checkpoint for the meshed trainers to resume
    unmeshed = {"saves": _two_steps_saved(None, tmp / "unmeshed")}
    shutil.copytree(tmp / "unmeshed", tmp / "unmeshed_copy")

    def references():
        unmeshed.update({name: _train(None, name) for name in TRAINERS if name != "zero1"})
        unmeshed["zero1"] = unmeshed["plain"]  # ZeRO-1 does not change the math
        unmeshed["sgd"] = _sgd_step(None)
        unmeshed["serving"] = {case: _serve_unmeshed(*case) for case in SERVING}

    spawn_group(__file__, WORLD, tmp, work=references)
    meshed = torch.load(tmp / "meshed.pt")
    # the unmeshed trainer resumes the meshed trainers' checkpoint
    unmeshed["resumes"] = _resumed_step(None, tmp / "meshed")
    return meshed, unmeshed


def _close_params(got, want):
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(), atol=3e-5,
                                   rtol=3e-4, err_msg=path)


@pytest.mark.parametrize("name", list(TRAINERS))
def test_nuwa_trainer_on_a_mesh_matches_unmeshed(runs, name):
    meshed, unmeshed = runs
    np.testing.assert_allclose(meshed[name]["losses"], unmeshed[name]["losses"], rtol=2e-4)
    _close_params(meshed[name]["params"], unmeshed[name]["params"])


def test_sharded_train_step_matches_one_process(runs):
    meshed, unmeshed = runs
    np.testing.assert_allclose(meshed["sgd"]["loss"], unmeshed["sgd"]["loss"], rtol=2e-4)
    _close_params(meshed["sgd"]["params"], unmeshed["sgd"]["params"])


def test_zero1_moments_are_split_over_data(runs):
    """Each rank holds about half the AdamW moments (the data axis is 2):
    only leaves that no dimension of lets 'data' divide stay whole."""
    zero = runs[0]["zero1"]
    assert zero["moment_bytes"] < 0.6 * zero["whole_bytes"], zero


def test_meshed_checkpoint_resumes_an_unmeshed_trainer(runs):
    meshed, unmeshed = runs
    assert unmeshed["resumes"]["step"] == 2
    np.testing.assert_allclose(unmeshed["resumes"]["loss"], meshed["meshed_saves"]["loss"],
                               rtol=2e-4)
    _close_params(unmeshed["resumes"]["params"], meshed["meshed_saves"]["params"])


def test_unmeshed_checkpoint_resumes_a_meshed_trainer(runs):
    meshed, unmeshed = runs
    assert meshed["meshed_resumes"]["step"] == 2
    np.testing.assert_allclose(meshed["meshed_resumes"]["loss"], unmeshed["saves"]["loss"],
                               rtol=2e-4)
    _close_params(meshed["meshed_resumes"]["params"], unmeshed["saves"]["params"])


def test_unmeshed_checkpoint_resumes_a_zero1_trainer(runs):
    """ZeRO-1's slices of the parameters are those of the loaded weights,
    not of the weights the trainer was built with."""
    meshed, unmeshed = runs
    assert meshed["zero1_resumes"]["step"] == 2
    np.testing.assert_allclose(meshed["zero1_resumes"]["loss"], unmeshed["saves"]["loss"],
                               rtol=2e-4)
    _close_params(meshed["zero1_resumes"]["params"], unmeshed["saves"]["params"])


@pytest.mark.parametrize("case", SERVING, ids=["-".join(c) for c in SERVING])
def test_tp_serving_generate_ids_equal_unmeshed(runs, case):
    meshed, unmeshed = runs
    for got, want in zip(meshed["serving"][case], unmeshed["serving"][case], strict=True):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_mesh_options_that_belong_to_a8b_raise(runs):
    """The pipeline's options (A8b-PP) raise without what they need: a
    process group for ``make_mesh(pipe=)``, a mesh with a 'pipe' axis for
    ``pipeline_parallel`` (the meshed runs are tests/test_torch_parallel_pp.py);
    ``context=`` builds a ("data", "model", "context") mesh in JAX's rank
    order (rank = (data * model + model index) * context + context index),
    as the ranks found."""
    from nuwa_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(data=1, pipe=2, device="cpu")
    with pytest.raises(ValueError, match="'pipe' axis"):
        _trainer(None, pipeline_parallel=True)
    with pytest.raises(ValueError, match="'pipe' axis"):
        _trainer(None, pipeline_parallel=True, pipeline_microbatches=2)
    with pytest.raises(ValueError, match="context_parallel"):
        _trainer(None, context_parallel=True)
    with pytest.raises(ValueError, match="zero1"):
        _trainer(None, zero1=True)
    names, shape, context_rank = runs[0]["cp_mesh"]  # rank 0's
    assert (names, shape, context_rank) == (("data", "model", "context"), (1, 2, 2), 0)


if __name__ == "__main__":
    run_rank(_worker, sys.argv[1:])
