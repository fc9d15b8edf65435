"""Port parity for the pieces of the dual (video + audio) decoder, fp32 on
the CPU, against nuwa_tpu with the same weights:

  * ``shift_audio_tokens`` against the JAX function at several timestep
    sizes (which do not change its result) and odd widths: equal;
  * ``CrossModalityCrossAttention`` video->audio and audio->video (chunks
    of 4 and 3 tokens), with ragged sequences, more sequence chunks than
    context chunks, and with token and context masks: within 1e-5;
  * ``DualModalityDecoder`` and ``ReversibleDualModalityDecoder`` (depth 3,
    cross-modality attention every 2 depths, token shift on both towers,
    H = 2, rel-pos biases, dilations cycled by depth) on random streams:
    both outputs within 1e-5 of their max abs, and the gradients of a
    weighted sum of them in both streams, the text context and every
    parameter against ``jax.grad`` within 1e-4 of each one's max abs (at
    least 1: sums in another order, and the reversible backward rebuilds
    its activations by subtraction). The reversible decoder's come from the port's recompute
    backward of ``dual_reversible_sequence`` through self, cross and xmod
    quads, the JAX package's from its custom VJP (``reverse=True``);
  * ``convert.load_nuwa_video_audio`` on a JAX ``NUWAVideoAudio`` tree (the
    shapes of ``jax.eval_shape`` of its init): every leaf used once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuwa_tpu.dual_decoder import DualModalityDecoder as JDual
from nuwa_tpu.dual_decoder import ReversibleDualModalityDecoder as JRevDual
from nuwa_tpu.models import NUWAVideoAudio as JNUWAVideoAudio
from nuwa_tpu.ops.crossmodality import CrossModalityCrossAttention as JXmod
from nuwa_tpu.ops.shift import shift_audio_tokens as jshift_audio_tokens
from nuwa_tpu.vqgan_vae import VQGanVAE as JVQGanVAE
from nuwa_tpu_torch import CrossModalityCrossAttention, NUWAVideoAudio, VQGanVAE
from nuwa_tpu_torch.convert import flatten_params, jax_path, load_jax_params, load_nuwa_video_audio
from nuwa_tpu_torch.core.layers import init_weights_
from nuwa_tpu_torch.dual_decoder import DualModalityDecoder, ReversibleDualModalityDecoder
from nuwa_tpu_torch.ops.shift import shift_audio_tokens
from test_torch_sketch import jax_params

torch.set_num_threads(1)
REL, GRAD_REL = 1e-5, 1e-4


def _rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n,d,height", [(7, 6, 1), (9, 5, 2), (12, 7, 4), (1, 3, 3)])
def test_shift_audio_tokens_matches_jax(n, d, height):
    x = _rnd(2, n, d)
    want = np.asarray(jshift_audio_tokens(jnp.asarray(x), height))
    np.testing.assert_array_equal(shift_audio_tokens(torch.from_numpy(x)).numpy(), want)


# (chunk, context chunk, sequence tokens, context tokens, masks), both with
# their start tokens: video->audio and audio->video, aligned and ragged,
# more sequence chunks than context chunks, token and context masks
@pytest.mark.parametrize("cs,ccs,n,nc,masks", [
    (4, 3, 1 + 12, 1 + 9, False), (3, 4, 1 + 8, 1 + 11, True), (4, 3, 1 + 16, 1 + 5, True),
])
def test_cross_modality_attention_matches_jax(cs, ccs, n, nc, masks):
    kw = dict(dim=16, chunk_size=cs, context_chunk_size=ccs, heads=2, dim_head=8)
    jmod = JXmod(**kw)
    p = jmod.init(jax.random.PRNGKey(cs))
    p["talking_heads_b"] = jnp.asarray([0.1, -0.2])  # a bias far from its zero init
    tmod = load_jax_params(CrossModalityCrossAttention(**kw), jax.tree.map(np.asarray, p))
    seq, ctx = _rnd(2, n, 16, seed=1), _rnd(2, nc, 16, seed=2)
    mask = cmask = None
    if masks:
        rng = np.random.default_rng(3)
        mask, cmask = rng.random((2, n)) > 0.2, rng.random((2, nc)) > 0.3
    want = np.asarray(jax.jit(lambda p, s, c, m, cm: jmod(p, s, c, mask=m, context_mask=cm))(
        p, seq, ctx, mask, cmask))
    with torch.no_grad():
        got = tmod(torch.from_numpy(seq), torch.from_numpy(ctx),
                   mask=None if mask is None else torch.from_numpy(mask),
                   context_mask=None if cmask is None else torch.from_numpy(cmask))
    assert got.shape == want.shape == (2, n, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=REL, rtol=0)


DUAL = dict(dim=16, depth=3, heads=2, dim_head=8, num_audio_tokens_per_video_frame=4,
            num_video_tokens_per_frame=9, sparse_3dna_video_shape=(2, 3, 3),
            sparse_3dna_dilations=(1, 2), sparse_3dna_rel_pos_bias=True,
            sparse_2dna_kernel_size=3, sparse_2dna_dilation=(2, 1),
            sparse_2dna_rel_pos_bias=True, shift_video_tokens=True, shift_audio_tokens=True,
            audio_tokens_per_timestep=2, cross_modality_attn_every=2)


@pytest.mark.parametrize("reversible", [False, True])
def test_dual_decoder_forward_matches_jax(reversible):
    jdec = (JRevDual if reversible else JDual)(**DUAL)
    tdec = (ReversibleDualModalityDecoder if reversible else DualModalityDecoder)(**DUAL)
    init_weights_(tdec, seed=4)
    assert tdec.kinds == [btype for btype, _, _ in jdec.blocks()]
    assert {"self", "cross", "xmod"} == set(tdec.kinds)
    params = jax_params(jdec, tdec)
    video, audio = _rnd(2, 1 + 17, 16, seed=5), _rnd(2, 1 + 7, 16, seed=6)
    context, cmask = _rnd(2, 5, 16, seed=7), np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    wv, wa = _rnd(2, 1 + 17, 16, seed=8), _rnd(2, 1 + 7, 16, seed=9)

    def loss(p, v, a, c):
        out = jdec(p, v, a, context=c, context_mask=cmask)
        return jnp.sum(out[0] * wv) + jnp.sum(out[1] * wa), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        params, video, audio, context)
    inputs = [torch.from_numpy(x).requires_grad_() for x in (video, audio, context)]
    got = tdec(*inputs[:2], context=inputs[2], context_mask=torch.from_numpy(cmask))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, atol=REL * np.abs(w).max(), rtol=0)
    (torch.sum(got[0] * torch.from_numpy(wv)) + torch.sum(got[1] * torch.from_numpy(wa))).backward()
    ref = flatten_params(jax.tree.map(np.asarray, jgrads[0]))
    named = {jax_path(tdec, n): p.grad for n, p in tdec.named_parameters()}
    assert sorted(named) == sorted(ref)
    pairs = [(n, x.grad, jg) for n, x, jg in zip(("video", "audio", "context"), inputs, jgrads[1:])]
    for name, g, r in pairs + [(n, named[n], r) for n, r in ref.items()]:
        r = np.asarray(r)
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_REL * max(1.0, np.abs(r).max()),
                                   rtol=0, err_msg=name)


def test_load_nuwa_video_audio_uses_every_leaf_once():
    vae = dict(dim=8, image_size=8, num_layers=2, vq_codebook_size=16, vq_codebook_dim=8,
               resnet_groups=4, use_vgg_and_gan=False, vq_kmeans_init=False, use_attn=False,
               num_resnet_blocks=0)
    cfg = dict(dim=16, image_size=8, num_audio_tokens=12, num_audio_tokens_per_video_frame=4,
               audio_tokens_per_timestep=2, max_video_frames=2, text_num_tokens=32,
               text_enc_depth=1, text_enc_dim_head=8, text_enc_heads=2, dec_depth=2,
               dec_dim_head=8, dec_heads=2, cross_modality_attn_every=2)
    tmodel = NUWAVideoAudio(vae=VQGanVAE(**vae, device="cpu"), **cfg, device="cpu")
    params = jax_params(JNUWAVideoAudio(vae=JVQGanVAE(**vae), **cfg), tmodel)
    leaves = flatten_params(params)
    assert len(leaves) == len(list(tmodel.parameters())) + len(list(tmodel.buffers()))
    assert "text_abs_pos_emb.table" in leaves and "vae.state.vq.embed" in leaves
    fresh = NUWAVideoAudio(vae=VQGanVAE(**vae, device="cpu", seed=9), **cfg, device="cpu",
                           seed=9)
    load_nuwa_video_audio(fresh, params)
    for (name, a), b in zip(tmodel.state_dict().items(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    del params["audio_bos"]
    with pytest.raises(ValueError):
        load_nuwa_video_audio(fresh, params)
