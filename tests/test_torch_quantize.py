"""Port parity for int8 weight-only serving: ``utils.quantize.quantize_int8_``
against ``nuwa_tpu.utils.quantize.quantize_params_int8`` on the same
weights (the same weights quantised, to the same int8 values and scales,
bit for bit; ``include`` / ``exclude``; idempotence), a JAX int8 tree
loaded through ``convert``, and quantised NUWA and NUWAVideoAudio logits and
greedy ids against the JAX quantised models', fp32 on the CPU (logits
within 1e-5 of their max abs, ids equal); and the serving entry point
``python -m nuwa_tpu_torch.serve --int8`` at a small size.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_video_audio as va_base
from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu.utils.quantize import quantize_params_int8
from nuwa_tpu_torch import NUWA, NUWAVideoAudio, VQGanVAE
from nuwa_tpu_torch import serve
from nuwa_tpu_torch.convert import _tensors, flatten_params, load_jax_params
from nuwa_tpu_torch.utils.quantize import Int8Weight, dequant, quantize_int8_
from test_torch_full_generate import NUWA_CFG, TEXT, greedy
from test_torch_sketch import jax_params

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def nuwa():
    tmodel = NUWA(**NUWA_CFG, device="cpu", seed=3)
    jmodel = JNUWA(**NUWA_CFG)
    return jmodel, jax_params(jmodel, tmodel)


def _int8_leaves(tree):
    """{path: leaf} of a params tree's int8 weights and their scales."""
    flat = flatten_params(tree)
    scaled = {k[: -len(".w_scale")] for k in flat if k.endswith(".w_scale")}
    return {k: np.asarray(v) for k, v in flat.items()
            if k.rpartition(".")[0] in scaled and k.rpartition(".")[2] in ("w", "w_scale")}


def _port_int8(model):
    return _int8_leaves({path: t.detach() for path, (t, _, _) in _tensors(model).items()})


@pytest.mark.parametrize("select", [{}, {"include": "video_transformer"},
                                    {"exclude": "to_kv|to_logits"}])
def test_int8_values_and_scales_match_jax(nuwa, select):
    """The same weights quantised to the same int8 values and scales, with
    the JAX package's selection (``include`` / ``exclude`` among it)."""
    _, params = nuwa
    want = _int8_leaves(quantize_params_int8(params, **select))
    model = quantize_int8_(load_jax_params(NUWA(**NUWA_CFG, device="cpu"), params), **select)
    got = _port_int8(model)
    assert sorted(got) == sorted(want) and len(want) > 0
    for path, value in want.items():
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value, err_msg=path)
    assert ("to_logits.w" in got) == (not select)
    if "include" in select:
        assert all(k.startswith("video_transformer") for k in got)


def test_quantize_is_idempotent_and_loads_a_jax_int8_tree(nuwa):
    _, params = nuwa
    model = quantize_int8_(load_jax_params(NUWA(**NUWA_CFG, device="cpu"), params))
    once = {k: v.copy() for k, v in _port_int8(model).items()}
    quantize_int8_(model)
    assert {k: v.tolist() for k, v in _port_int8(model).items()} == {
        k: v.tolist() for k, v in once.items()}
    loaded = load_jax_params(NUWA(**NUWA_CFG, device="cpu"), quantize_params_int8(params))
    assert isinstance(loaded.to_logits, Int8Weight)
    for path, value in _port_int8(loaded).items():
        np.testing.assert_array_equal(value, once[path])
    head = loaded.to_logits
    torch.testing.assert_close(dequant(head, torch.float32),
                               head.w.float() * head.w_scale, atol=0, rtol=0)


def test_quantised_nuwa_logits_and_greedy_ids_match_jax(nuwa):
    jmodel, params = nuwa
    qparams = quantize_params_int8(params)
    tmodel = load_jax_params(NUWA(**NUWA_CFG, device="cpu"), qparams)
    video = np.random.default_rng(1).integers(0, 16, (2, 8)).astype(np.int32)
    want = jax.jit(lambda p, t, v: jmodel.forward(p, text=t, video=v))(qparams, TEXT, video)
    with torch.no_grad():
        got = tmodel(TEXT, video).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    kw = dict(filter_thres=greedy(16), cond_scale=2.0, decode_video=False)
    want = jmodel.generate(qparams, text=jnp.asarray(TEXT), key=KEY, **kw)
    np.testing.assert_array_equal(tmodel.generate(TEXT, **kw).numpy(), np.asarray(want))


def test_quantised_video_audio_logits_match_jax():
    """test_torch_video_audio.py's H = 2 model, reversible with both
    rel-pos biases: both heads and every projection int8, the codec not."""
    jmodel, params, _ = va_base._models("h2")
    qparams = quantize_params_int8(params)
    tmodel = NUWAVideoAudio(vae=VQGanVAE(**va_base.VAE, device="cpu"),
                            **dict(va_base.CFG, **va_base.CONFIGS["h2"]), device="cpu")
    load_jax_params(tmodel, qparams)
    assert isinstance(tmodel.to_audio_logits, Int8Weight)
    assert not any(b.dtype == torch.int8 for b in tmodel.vae.buffers())
    ids = np.random.default_rng(3).integers(0, 16, (2, 8))
    want = jax.jit(lambda p: jmodel.forward(p, text=va_base.TEXT, video=ids,
                                            audio=va_base.AUDIO))(qparams)
    with torch.no_grad():
        got = tmodel(va_base.TEXT, ids, va_base.AUDIO)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


def test_serve_entry_point_with_int8(capsys, monkeypatch):
    # The entry point's model narrowed to dim 32, depth 1 to run on the CPU.
    build = serve.build
    monkeypatch.setattr(serve, "build", lambda **kw: build(dim=32, depth=1, **kw))
    out = serve.main(["--device", "cpu", "--batch", "2", "--frames", "1", "--int8"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and out["int8"] and out["sample_shape"] == [2, 64]
    assert out["tokens"] == 128 and out["tokens_per_sec"] > 0
