"""Port parity for NUWAVideoAudio training with ``dec_remat``: the plain
dual decoder recomputes each block in the backward
(``torch.utils.checkpoint``; ``jax.checkpoint`` in the JAX package), as
``scripts/bench_dual_flagship.py --remat`` trains BASELINE config 5. The
H = 1 model of test_torch_video_audio_train.py with ``dec_remat=True``: the
loss and every gradient against ``jax.value_and_grad``, and one
clip-and-AdamW step against optax, with that file's checks and tolerances.
"""
import pytest

import test_torch_video_audio_train as base


@pytest.fixture(scope="module")
def case():
    return base.jax_loss_and_grads("h1", dropout=False, dec_remat=True)


def test_remat_loss_and_grads_match_jax(case):
    assert case[0].video_audio_transformer.remat
    base.check_loss_and_grads(case)


def test_remat_clip_and_adamw_step_matches_optax(case):
    base.check_step(case)
