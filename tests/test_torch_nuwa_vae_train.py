"""Port parity for NUWA from text and pixels, training: the tiny
``NUWA(vae=...)`` of test_torch_nuwa_vae.py, fp32 on the CPU. The first 3
losses of ``NUWATrainer`` with a tokenizer against the JAX trainer's
(within 1e-4), and the PNG the port's trainer writes at step 0, read back
with Pillow, equal to what ``nuwa_tpu.utils.image.save_image_grid`` writes
for the same sample.
"""
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_nuwa_vae as base
from nuwa_tpu_torch import NUWA, NUWATrainer, VQGanVAE, tokenizer
from nuwa_tpu_torch.convert import load_jax_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return base._models()


def test_trainer_first_losses_and_sample_png_match_jax(pair, tmp_path, monkeypatch):
    """Same weights, same seed (so the same shuffled batches), no condition
    dropout: the first three losses agree; the port's step-0 sample is
    logged with its caption and written as a PNG equal to the JAX
    package's PNG of the same frames."""
    from nuwa_tpu.train import trainer_nuwa as jtrainer
    from nuwa_tpu.utils.image import save_image_grid

    jmodel, params, _ = pair
    # the JAX trainer samples and saves at step 0; its losses are compared here
    monkeypatch.setattr(jtrainer.NUWATrainer, "_sample", lambda *a: None)
    monkeypatch.setattr(jtrainer, "save_checkpoint", lambda *a, **k: None)
    videos = base._pixels((4, 2, 3, 8, 8), 3)
    ds = [(base.TEXT[i % 2], videos[i]) for i in range(4)]
    kw = dict(num_train_steps=3, lr=1e-3, wd=0.01, batch_size=2, grad_accum_every=1,
              max_grad_norm=0.5, cond_dropout_prob=0.0, seed=3, tokenizer=tokenizer)
    want = []
    jtrainer.NUWATrainer(nuwa=jmodel, params=params, dataset=ds, resume=False,
                         results_folder=tmp_path / "jax", save_results_every=100,
                         save_model_every=100, **kw).train(lambda logs: want.append(logs["loss"]))
    tmodel = load_jax_params(
        NUWA(vae=VQGanVAE(**base.VAE, device="cpu"), **base.CFG, device="cpu"), params)
    logs = []
    NUWATrainer(nuwa=tmodel, dataset=ds, save_results_every=100, num_sampled_frames=2,
                results_folder=tmp_path / "port", **kw).train(logs.append)
    np.testing.assert_allclose([x["loss"] for x in logs], want, atol=1e-4, rtol=0)
    sample = logs[0]["sampled_video"]
    assert sample.shape == (2, 3, 8, 8) and 0 <= sample.min() and sample.max() <= 1
    assert logs[0]["sampled_text"] in [tokenizer.decode(t) for t in base.TEXT]
    save_image_grid(sample, tmp_path / "want.png", nrow=1)
    got = np.asarray(Image.open(tmp_path / "port" / "0.png"))
    assert got.shape == (2 * 10 + 2, 12, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "want.png")))
