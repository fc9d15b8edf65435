"""Port parity for Sparse3DNA against the JAX row-blocked Pallas kernels in
their other modes (the check of test_torch_nda_rb.py: interpret mode, an
fp32 score cache, output and every gradient within 1e-5 of the reference's
max abs):

  * centered windows (the sketch encoder's mode, as the 256-px sketch
    configs run it) on 3 frames of 32 x 9 with dilation (1, 2, 2), one token
    short of whole frames, so that the windows of the last frame reach its
    phantom token;
  * 8 x 8 frames with the JAX ``row_block=4``, which forces the row-blocked
    kernels where the whole-frame ones would run.
"""
import pytest

import test_torch_nda_rb as base


@pytest.mark.parametrize("case", [c for c, spec in base.CASES.items()
                                  if spec[0][1:] != (32, 9) or not spec[2]])
def test_sparse3dna_matches_jax_row_blocked_kernels_in_other_modes(case, monkeypatch):
    base.check_case(case, monkeypatch)
