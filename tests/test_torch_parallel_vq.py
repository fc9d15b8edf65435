"""The codebook's update across ranks and ``VQGanVAETrainer`` on a mesh,
against one process, on groups of 2 and 4 gloo processes on the CPU.

``VectorQuantizeEMA(batch_group=...)`` (pjit's global batch, which the
trainers use): the EMA state within 1e-5 of one process that holds the
whole batch, the dead-code expiry's state the same on every rank and
within 1e-5 of one process, the k-means start equal to one process's (it
runs on the gathered batch). ``axis_name=`` (the JAX package's shard_map
semantics): the dead-code state the same on every rank. The codec's
generator loss from each rank's rows with ``batch_group`` (the adaptive GAN
weight's two gradients averaged over the ranks), its gradients averaged
over the ranks: one process's gradients within 1e-5 of their max abs.
Then the codec trainer on a (data 2, model 2) mesh, with the GAN,
``perceptual="none"`` and k-means, against the unmeshed trainer: losses
within rtol 5e-4 / atol 1e-5, the tolerances of the JAX package's
tests/test_parallel.py.

Each group runs every case once (a module fixture, each rank running this
file as a script through tests/test_torch_gloo.py's ``spawn_group``, which
fails the group at once when a rank fails and within 300 s in all); each
test asserts one case.
"""
import sys

import numpy as np
import pytest
import torch
from test_torch_gloo import init_rank, run_rank, spawn_group

VQ_CASES = {
    "ema": dict(kmeans_init=False),
    "dead_code": dict(kmeans_init=False, threshold_ema_dead_code=2.0),
    "kmeans": dict(kmeans_init=True),
}
N = 16  # rows of the global batch


def _vq(**kw):
    from nuwa_tpu_torch.core.layers import init_weights_
    from nuwa_tpu_torch.vq import VectorQuantizeEMA

    return init_weights_(VectorQuantizeEMA(dim=4, codebook_size=8, cosine_sim=False, **kw), 0)


def _batch():
    return torch.from_numpy(np.random.default_rng(1).standard_normal((N, 4)).astype(np.float32))


def _state(vq):
    return {k: v.clone() for k, v in vq.named_buffers()}


def _update(case, x, **kw):
    """Two updates (k-means in the first when it is on) from one seeded
    generator: the codebook state after them."""
    vq = _vq(**VQ_CASES[case])
    gen = torch.Generator().manual_seed(7)
    for _ in range(2):
        vq(x, update=True, generator=gen, **kw)
    return _state(vq)


class _Features(torch.nn.Module):
    """A small perceptual net in the place of VGG16 (``perceptual="vgg"``
    calls it on the images and the reconstructions)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.linspace(-0.5, 0.5, self.conv.weight.numel())
                                   .reshape(self.conv.weight.shape))
            self.conv.bias.copy_(torch.linspace(-0.1, 0.1, 4))

    def forward(self, x):
        return torch.tanh(self.conv(x)).mean(dim=(2, 3))


def _codec_grads(rows=slice(None), group=None):
    """The generator loss's gradients (the codec's and the discriminator
    held constant) on ``rows`` of one seeded batch of 8 images, with the
    perceptual net set, so the adaptive GAN weight acts; averaged over
    ``group``'s ranks."""
    import torch.distributed as dist

    from nuwa_tpu_torch import VQGanVAE

    vae = VQGanVAE(dim=8, image_size=8, num_layers=1, vq_codebook_size=16, vq_codebook_dim=8,
                   resnet_groups=4, use_vgg_and_gan=True, perceptual="none",
                   vq_kmeans_init=False, use_attn=False, num_resnet_blocks=0, device="cpu",
                   seed=5)
    gan = vae.gan_parts(seed=6)
    vae.perceptual, gan.vgg = "vgg", _Features()
    img = torch.stack([torch.from_numpy(_Images()[i]) for i in range(8)])[rows]
    vae(img, gan=gan, return_loss=True, update_vq=False, batch_group=group).backward()
    grads = {name: p.grad for name, p in vae.named_parameters() if p.grad is not None}
    if group is not None:
        for g in grads.values():
            dist.all_reduce(g, group=group)
            g /= dist.get_world_size(group)
    return grads


class _Images:
    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.random.default_rng(i).uniform(size=(3, 8, 8)).astype(np.float32)


def _codec_losses(mesh, folder):
    from nuwa_tpu_torch import VQGanVAE
    from nuwa_tpu_torch.train import VQGanVAETrainer

    vae = VQGanVAE(dim=8, image_size=8, num_layers=1, vq_codebook_size=16, vq_codebook_dim=8,
                   resnet_groups=4, use_vgg_and_gan=True, perceptual="none", vq_kmeans_init=True,
                   use_attn=False, num_resnet_blocks=0, device="cpu", seed=2)
    trainer = VQGanVAETrainer(
        vae, num_train_steps=2, lr=1e-3, batch_size=4, grad_accum_every=2, dataset=_Images(),
        valid_frac=0.0, results_folder=folder, save_results_every=10**9,
        save_model_every=10**9, ema_update_after_step=0, ema_update_every=1, seed=3,
        mesh=mesh)
    losses = []
    trainer.train(log_fn=lambda logs: losses.append((logs["loss"], logs["discr_loss"])))
    return losses


def _worker(rank, world, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    init_rank(rank, world, tmp)
    rows = _batch().chunk(world)[rank]
    group = dist.group.WORLD
    out = {case: _update(case, rows, batch_group=group) for case in VQ_CASES}
    out["dead_code_axis"] = _update("dead_code", rows, axis_name=group)
    out["codec_grads"] = _codec_grads(slice(rank * 8 // world, (rank + 1) * 8 // world), group)
    if world == 4:
        from nuwa_tpu_torch.parallel import make_mesh

        out["codec"] = _codec_losses(make_mesh(data=2, model=2, device="cpu"), f"{tmp}/codec")
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _spawn(tmp, world, work):
    """Run the group of ``world`` ranks while ``work()`` runs here; returns
    (every rank's results, work's)."""
    mine = spawn_group(__file__, world, tmp, work=work)
    return [torch.load(f"{tmp}/rank{rank}.pt") for rank in range(world)], mine


@pytest.fixture(scope="module")
def one_process():
    torch.set_num_threads(1)
    out = {case: _update(case, _batch()) for case in VQ_CASES}
    out["codec_grads"] = _codec_grads()
    return out


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("vq2"), 2, lambda: None)[0]


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vq4")
    return _spawn(tmp, 4, lambda: _codec_losses(None, str(tmp / "unmeshed")))


@pytest.fixture(params=[2, 4])
def ranks(request, group2, group4):
    return group2 if request.param == 2 else group4[0]


@pytest.mark.parametrize("case", ["ema", "dead_code"])
def test_codebook_update_over_the_global_batch(ranks, one_process, case):
    for got in ranks:
        for name, want in one_process[case].items():
            np.testing.assert_allclose(got[case][name].numpy(), want.numpy(), atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("case", ["dead_code", "dead_code_axis"])
def test_dead_code_state_is_the_same_on_every_rank(ranks, case):
    for got in ranks[1:]:
        for name, want in ranks[0][case].items():
            assert torch.equal(got[case][name], want), name


def test_kmeans_starts_from_the_gathered_batch(ranks, one_process):
    for got in ranks:
        for name, want in one_process["kmeans"].items():
            np.testing.assert_allclose(got["kmeans"][name].numpy(), want.numpy(), atol=1e-6,
                                       err_msg=name)


def test_adaptive_gan_weight_over_the_global_batch(ranks, one_process):
    want = one_process["codec_grads"]
    scale = max(g.abs().max().item() for g in want.values())
    for got in ranks:
        assert set(got["codec_grads"]) == set(want)
        for name, g in want.items():
            np.testing.assert_allclose(got["codec_grads"][name].numpy(), g.numpy(),
                                       atol=1e-5 * scale, rtol=0, err_msg=name)


def test_codec_trainer_on_a_mesh_matches_unmeshed(group4):
    ranks, unmeshed = group4
    for got in ranks:
        np.testing.assert_allclose(got["codec"], unmeshed, rtol=5e-4, atol=1e-5)


if __name__ == "__main__":
    run_rank(_worker, sys.argv[1:])
