"""Port parity for the serving slice: a tiny NUWA in nuwa_tpu and in
nuwa_tpu_torch with the same params (2 decoder layers, dim 32, 2 heads,
dim_head 16, fmap 4, 3 frames, dilations (1, 2), rel-pos bias, token shift).

fp32 on the CPU. Logits: atol 1e-4. Greedy ids (top-k with k = 1, so the
sampling noise cannot change the argmax, and the PRNG streams of the two
frameworks need not agree): equal. The JAX reference is built once per
module, since each jitted generate costs a compile.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.models import NUWA as JNUWA
from nuwa_tpu_torch import NUWA
from nuwa_tpu_torch.convert import flatten_params, load_jax_params
from nuwa_tpu_torch.decode import TransformerDecoder

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CFG = dict(
    dim=32, image_size=4, num_image_tokens=64, max_video_frames=3,
    text_num_tokens=100, text_max_seq_len=8, text_enc_depth=1,
    text_enc_dim_head=16, text_enc_heads=2, dec_depth=2, dec_dim_head=16,
    dec_heads=2, sparse_3dna_kernel_size=3, sparse_3dna_dilation=2,
    shift_video_tokens=True, sparse_3dna_rel_pos_bias=True,
)
GREEDY = 1 - 0.5 / CFG["num_image_tokens"]  # k = max(int(0.5), 1) = 1
TEXT = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 0]], np.int32)


@pytest.fixture(scope="module")
def pair():
    jmodel = JNUWA(**CFG)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = load_jax_params(NUWA(**CFG, device="cpu"), params)
    return jmodel, params, tmodel


def _video(seed=1):
    return np.random.default_rng(seed).integers(0, 64, (2, 48)).astype(np.int32)


def test_convert_uses_every_leaf_once(pair):
    _, params, tmodel = pair
    assert len(flatten_params(params)) == len(list(tmodel.parameters()))
    extra = dict(params, spare=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unused"):
        load_jax_params(NUWA(**CFG, device="cpu"), extra)
    short = {k: v for k, v in params.items() if k != "video_bos"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(NUWA(**CFG, device="cpu"), short)


def test_forward_logits_match_jax(pair):
    jmodel, params, tmodel = pair
    video = _video()
    fwd = jax.jit(lambda p, t, v: jmodel.forward(p, text=t, video=v))
    want = np.asarray(fwd(params, jnp.asarray(TEXT), jnp.asarray(video)))
    got = tmodel(TEXT, video).detach().numpy()
    assert got.shape == want.shape == (2, 49, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _context(tmodel):
    text = torch.from_numpy(TEXT).long()
    mask = text != 0
    return tmodel.embed_text(text, mask), mask


@torch.no_grad()
def test_cached_steps_match_full_forward(pair):
    """Teacher-forced cached decoding gives the full forward's logits."""
    _, _, tmodel = pair
    video = torch.from_numpy(_video()).long()
    ctx, mask = _context(tmodel)
    full = tmodel._decode_logits(video, ctx, mask)
    n = video.shape[1]
    dec = TransformerDecoder(tmodel.video_transformer, total_in=n + 1)
    caches = dec.init_cache(2, ctx, mask)
    pos_emb = tmodel.video_pos_emb()
    rows = []
    for i in range(n + 1):
        if i == 0:
            x_i = tmodel.video_bos.expand(2, -1)
        else:
            x_i = tmodel.image_embedding.table[video[:, i - 1]] + pos_emb[i - 1]
        rows.append(dec.step(caches, x_i, i) @ tmodel.to_logits)
    torch.testing.assert_close(torch.stack(rows, dim=1), full, atol=1e-4, rtol=0)


@torch.no_grad()
@pytest.mark.parametrize("n", [1, 17, 32])
def test_prefill_leaves_the_caches_of_n_steps(pair, n):
    _, _, tmodel = pair
    ctx, mask = _context(tmodel)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, n, 32)).astype(np.float32))
    dec = TransformerDecoder(tmodel.video_transformer, total_in=48)
    stepped = dec.init_cache(2, ctx, mask)
    for i in range(n):
        dec.step(stepped, x[:, i], i)
    prefilled = dec.prefill(dec.init_cache(2, ctx, mask), x)
    for a, b in zip(stepped, prefilled):
        assert a.keys() == b.keys()
        for key in a:
            torch.testing.assert_close(a[key], b[key], atol=1e-5, rtol=0)


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_greedy_generate_matches_jax(pair, cond_scale):
    jmodel, params, tmodel = pair
    want = jmodel.generate(
        params, text=jnp.asarray(TEXT), key=jax.random.PRNGKey(1),
        filter_thres=GREEDY, cond_scale=cond_scale, decode_video=False,
    )
    got = tmodel.generate(TEXT, filter_thres=GREEDY, cond_scale=cond_scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_long_matches_jax(pair):
    """5 frames with a 3-frame window: two prefills over a ragged window."""
    jmodel, params, tmodel = pair
    want = jmodel.generate_long(
        params, text=jnp.asarray(TEXT), key=jax.random.PRNGKey(1), num_frames=5,
        filter_thres=GREEDY, cond_scale=2.0, decode_video=False,
    )
    got = tmodel.generate_long(TEXT, num_frames=5, filter_thres=GREEDY, cond_scale=2.0)
    assert got.shape == (2, 5 * 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_reproducible_from_a_generator(pair):
    _, _, tmodel = pair
    a = tmodel.generate(TEXT, generator=torch.Generator().manual_seed(3), num_frames=1)
    b = tmodel.generate(TEXT, generator=torch.Generator().manual_seed(3), num_frames=1)
    assert torch.equal(a, b) and int(a.max()) < 64


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_nuwa_tpu():
    files = sorted((REPO / "nuwa_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "nuwa_tpu")
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in banned, f"{path.relative_to(REPO)} imports {name}"


def test_entry_point_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NUWA(**CFG)
