"""Port parity for the NUWASketch serving slice with the reversible
decoder: the checks of test_torch_sketch.py (same tiny configuration,
tolerances and JAX reference) on ``dec_reversible=True``, whose couples are
(Sparse3DNA, ff) and (SparseCross2DNA, ff_cross) per depth.
"""
import pytest

import test_torch_sketch as base


@pytest.fixture(scope="module")
def pair():
    return base._models(reversible=True)


def test_convert_uses_every_leaf_once(pair):
    base.check_convert_uses_every_leaf_once(pair)


def test_embed_sketch_matches_jax(pair):
    base.check_embed_sketch_matches_jax(pair)


@pytest.mark.parametrize("frames", [2, 1])
def test_forward_logits_and_loss_match_jax(pair, frames):
    base.check_forward_logits_and_loss_match_jax(pair, frames)


def test_generate_ids_and_pixels_match_jax(pair):
    base.check_generate_ids_and_pixels_match_jax(pair)


def test_generate_long_ids_match_jax(pair):
    base.check_generate_long_ids_match_jax(pair)
