"""Port parity for NUWAVideoAudio training through the reversible dual
decoder: the H = 2 model of test_torch_video_audio.py (a ragged last
timestep in every frame, both rel-pos biases, Sparse3DNA dilations (1, 2),
one ``xmod`` block), so the gradients come from the port's recompute
backward of ``reversible_dual`` through self, cross and xmod quads, the
text context's among them. The JAX forward gets a key whose
condition-dropout draw masks one row of two, and the port that mask
(``uncond``). The loss and every gradient against ``jax.value_and_grad``,
and one clip-and-AdamW step against optax, with the checks and tolerances
of test_torch_video_audio_train.py.
"""
import pytest

import test_torch_video_audio_train as base


@pytest.fixture(scope="module")
def case():
    return base.jax_loss_and_grads("h2", dropout=True)


def test_reversible_loss_and_grads_match_jax(case):
    assert case[2].sum() == 1  # condition dropout masks one row
    base.check_loss_and_grads(case)


def test_reversible_clip_and_adamw_step_matches_optax(case):
    base.check_step(case)
