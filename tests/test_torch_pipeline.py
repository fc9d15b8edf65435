"""The port's pipeline (``nuwa_tpu_torch.parallel.pipeline``) in one process,
against the JAX package's ``nuwa_tpu.parallel.pipeline``: stage validation
raises as JAX's does (a dilation cycle that is not stage-periodic, a menu
that does not split, a bad microbatch count, cross layers without a
context, the dual decoder's xmod period and dilation cycle);
``stage_param_slots`` equals JAX's; ``stack_stage_params`` /
``unstack_stage_params`` round-trip and lay out JAX's numpy values on the
same weights; one stage is the plain stack, bit for bit; the stages chained
in this process (``chained_transformer`` / ``chained_dual_decoder``, the
schedule of every rank) give the unpipelined stack's output and gradients,
with dropout the same masks. ``reversible_sequence`` and
``dual_reversible_sequence`` stay bit-identical to the one-input runner
they were before the runners took the stream pair and the quad (the
parent's backward folded the two streams' cotangents itself). No process
group: a stand-in with a device mesh's ``mesh_dim_names`` and ``shape``
serves where a mesh is only read.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from nuwa_tpu import dual_decoder as jdual
from nuwa_tpu import transformer as jtransformer
from nuwa_tpu.parallel import pipeline as jpipeline
from nuwa_tpu_torch.convert import export_jax_params, flatten_params
from nuwa_tpu_torch.core.layers import init_weights_
from nuwa_tpu_torch.dual_decoder import DualModalityDecoder, ReversibleDualModalityDecoder
from nuwa_tpu_torch.dual_decoder import reversible_dual_blocks
from nuwa_tpu_torch.parallel import pipeline
from nuwa_tpu_torch.reversible import _Reversible, reversible_sequence
from nuwa_tpu_torch.reversible_dual import _DualReversible, dual_reversible_sequence
from nuwa_tpu_torch.transformer import ReversibleTransformer, Transformer
from test_torch_sketch import jax_params

torch.set_num_threads(1)
TR = dict(dim=32, depth=4, causal=True, heads=2, dim_head=16)
NDA = dict(TR, sparse_3dna_attn=True, sparse_3dna_video_shape=(2, 2, 2),
           sparse_3dna_dilations=(1, 2))
DUAL = dict(dim=16, depth=2, heads=2, dim_head=8, num_video_tokens_per_frame=4,
            num_audio_tokens_per_video_frame=3, sparse_3dna_video_shape=(2, 2, 2),
            sparse_2dna_kernel_size=3, audio_tokens_per_timestep=1)


def _mesh(**sizes):
    return SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()),
                           device_type="cpu")


def _jax_mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("pipe",))


def _message(call):
    with pytest.raises(ValueError) as err:
        call()
    return str(err.value)


def test_stage_validation_raises_as_jax():
    """Dilation cycle (1, 2) at S = 4: stage 1 differs from stage 0; S = 3
    does not split the menu; 3 microbatches of 4 rows; cross layers without
    a context."""
    tr, jtr = Transformer(**NDA), jtransformer.Transformer(**NDA)
    got, want = (_message(lambda: fn(m, 4)) for fn, m in ((pipeline.validate_stages, tr),
                                                          (jpipeline.validate_stages, jtr)))
    assert "statically identical" in got
    assert got.split("(")[0] == want.split("(")[0] == "stage 1 entry 0 "
    assert got.split(" — ")[1] == want.split(" — ")[1]
    assert "dilations=(2, 2, 2)" in got and "dilations=(1, 1, 1)" in got
    assert (_message(lambda: pipeline.validate_stages(tr, 3))
            == _message(lambda: jpipeline.validate_stages(jtr, 3)))
    ok, jok = Transformer(**TR), jtransformer.Transformer(**TR)
    x = np.zeros((4, 8, 32), np.float32)
    got = _message(lambda: pipeline.pipelined_transformer(
        ok, torch.from_numpy(x), _mesh(pipe=2), num_microbatches=3))
    assert got == _message(lambda: jpipeline.pipelined_transformer(
        jok, jok.init(jax.random.PRNGKey(0)), x, _jax_mesh(2), num_microbatches=3))
    assert "not divisible" in got
    # PPxDP: a microbatch's rows over 'data' (each rank passes its rows)
    assert "not divisible by mesh axis data=2" in _message(
        lambda: pipeline.pipelined_transformer(ok, torch.from_numpy(x[:3]), _mesh(data=2, pipe=2),
                                               num_microbatches=2, data_axis="data"))
    xa = Transformer(**TR, cross_attend=True)
    assert "no `context=`" in _message(lambda: pipeline.pipelined_transformer(
        xa, torch.from_numpy(x), _mesh(pipe=2), num_microbatches=2))


def test_dual_stage_validation_raises_as_jax():
    """xmod every 2 puts its block in stage 1 only (5 blocks); the
    dilation cycle (1, 2) with one depth a stage."""
    kw = dict(DUAL, cross_modality_attn_every=2)
    assert (_message(lambda: pipeline.validate_dual_stages(DualModalityDecoder(**kw), 2))
            == _message(lambda: jpipeline.validate_dual_stages(jdual.DualModalityDecoder(**kw), 2)))
    kw = dict(DUAL, cross_modality_attn_every=1, sparse_3dna_dilations=(1, 2))
    got = _message(lambda: pipeline.validate_dual_stages(DualModalityDecoder(**kw), 2))
    want = _message(lambda: jpipeline.validate_dual_stages(jdual.DualModalityDecoder(**kw), 2))
    assert "statically identical" in got and got.split("(")[0] == want.split("(")[0]
    four = DualModalityDecoder(**dict(DUAL, depth=4, cross_modality_attn_every=2))
    assert pipeline.validate_dual_stages(four, 2) == 5


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("reversible", [False, True])
def test_stage_param_slots_equal_jax(reversible, cross):
    cfg = dict(NDA, depth=8, cross_attend=cross)
    tcls, jcls = ((ReversibleTransformer, jtransformer.ReversibleTransformer) if reversible
                  else (Transformer, jtransformer.Transformer))
    tr, jtr = tcls(**cfg), jcls(**cfg)
    for S in (1, 2, 4):
        assert (pipeline.stage_param_slots(tr, S) == jpipeline.stage_param_slots(jtr, S)
                == len(tr.layers) // S)
        assert pipeline.validate_stages(tr, S) == jpipeline.validate_stages(jtr, S)
    assert [k for k, _ in tr.layer_menu] == [k for k, _ in jtr.layer_menu]


@pytest.mark.parametrize("reversible", [False, True])
def test_stack_stage_params_lays_out_jax_values(reversible):
    cfg = dict(NDA, cross_attend=True)
    tr = init_weights_((ReversibleTransformer if reversible else Transformer)(**cfg), 5)
    jtr = (jtransformer.ReversibleTransformer if reversible else jtransformer.Transformer)(**cfg)
    flat = export_jax_params(tr)
    layers = [{k[len(f"layers.{i}."):]: v for k, v in flat.items()
               if k.startswith(f"layers.{i}.")} for i in range(len(tr.layers))]
    stacked = pipeline.stack_stage_params(layers, 2)
    want = jpipeline.stack_stage_params(jax_params(jtr, tr)["layers"], 2)
    assert len(stacked) == len(want) == len(layers) // 2
    for got_slot, want_slot in zip(stacked, want):
        want_slot = flatten_params(jax.tree.map(np.asarray, want_slot))
        assert set(got_slot) == set(want_slot)
        for path, w in want_slot.items():
            assert got_slot[path].shape[0] == 2
            np.testing.assert_array_equal(got_slot[path].numpy(), w, err_msg=path)
    back = pipeline.unstack_stage_params(stacked)
    assert len(back) == len(layers)
    for got, orig in zip(back, layers):
        assert set(got) == set(orig)
        assert all(torch.equal(got[k], orig[k]) for k in orig)


def _rnd(*shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _grads(module, *inputs):
    return ({n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None},
            [x.grad.clone() for x in inputs])


def _clear(module, *inputs):
    module.zero_grad(set_to_none=True)
    for x in inputs:
        x.grad = None


def test_one_stage_is_the_plain_stack():
    tr = init_weights_(Transformer(**NDA, cross_attend=True), 5)
    x, ctx = _rnd(4, 9, 32, seed=1), _rnd(4, 6, 32, seed=2)
    got = pipeline.pipelined_transformer(tr, x, _mesh(data=1, pipe=1), num_microbatches=2,
                                         context=ctx, seed=7)
    assert torch.equal(got, tr(x, context=ctx, seed=7))
    d = init_weights_(DualModalityDecoder(**DUAL, cross_modality_attn_every=1), 5)
    v, a, c = _rnd(4, 9, 16, seed=3), _rnd(4, 7, 16, seed=4), _rnd(4, 5, 16, seed=5)
    got = pipeline.pipelined_dual_decoder(d, v, a, _mesh(pipe=1), num_microbatches=2, context=c)
    for g, w in zip(got, d(v, a, context=c), strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("reversible", [False, True])
def test_chained_stages_are_the_unpipelined_stack(reversible, dropout):
    """Two stages of two microbatches in this process: the output (equal,
    masks included), every gradient within 1e-5 (plain) or 1e-4 of its max
    abs (the reversible backward inverts its couples)."""
    cls = ReversibleTransformer if reversible else Transformer
    tr = init_weights_(cls(**NDA, cross_attend=True, shift_video_tokens=True,
                           attn_dropout=dropout, ff_dropout=dropout), 3)
    x, ctx, w = _rnd(4, 9, 32, seed=1), _rnd(4, 6, 32, seed=2), _rnd(4, 9, 32, seed=3)
    x.requires_grad_()
    ctx.requires_grad_()
    cmask = torch.ones(4, 6, dtype=torch.bool)
    cmask[:, 4:] = False
    runs = []
    for chained in (False, True):
        kw = dict(context=ctx, context_mask=cmask, seed=11)
        out = (pipeline.chained_transformer(tr, x, 2, num_microbatches=2, **kw) if chained
               else tr(x, **kw))
        (out * w).sum().backward()
        runs.append((out.detach(), *_grads(tr, x, ctx)))
        _clear(tr, x, ctx)
    (want, wparams, winputs), (got, gparams, ginputs) = runs
    assert torch.equal(got, want) if dropout else torch.allclose(got, want, atol=1e-5)
    rel = 1e-4 if reversible else 1e-5
    assert set(gparams) == set(wparams)
    for name, g, r in [*zip(gparams, gparams.values(), [wparams[k] for k in gparams]),
                       *zip(("x", "context"), ginputs, winputs)]:
        torch.testing.assert_close(g, r, atol=rel * max(1.0, r.abs().max().item()), rtol=0,
                                   msg=name)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reversible", [False, True])
def test_chained_dual_stages_are_the_unpipelined_decoder(reversible, remat):
    cls = ReversibleDualModalityDecoder if reversible else DualModalityDecoder
    d = init_weights_(cls(**DUAL, cross_modality_attn_every=1, remat=remat, attn_dropout=0.1,
                          ff_dropout=0.1), 2)
    v, a, c = _rnd(4, 9, 16, seed=3), _rnd(4, 7, 16, seed=4), _rnd(4, 5, 16, seed=5)
    wv, wa = _rnd(4, 9, 16, seed=6), _rnd(4, 7, 16, seed=7)
    for t in (v, a, c):
        t.requires_grad_()
    runs = []
    for chained in (False, True):
        out = (pipeline.chained_dual_decoder(d, v, a, 2, num_microbatches=2, context=c, seed=5)
               if chained else d(v, a, context=c, seed=5))
        ((out[0] * wv).mean() + (out[1] * wa).mean()).backward()
        runs.append(([o.detach() for o in out], *_grads(d, v, a, c)))
        _clear(d, v, a, c)
    (want, wparams, winputs), (got, gparams, ginputs) = runs
    for g, r in zip(got, want):  # the masks replay: the tolerances of JAX's tests
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    assert set(gparams) == set(wparams)
    for g, r in [*zip(gparams.values(), [wparams[k] for k in gparams]),
                 *zip(ginputs, winputs)]:
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4)


class _OneInput(torch.autograd.Function):
    """The reversible runners as they were: one input duplicated into both
    streams (both towers' of the dual runner), the backward folding the
    streams' cotangents into it."""

    @staticmethod
    def forward(ctx, runner, n_streams, blocks, names, *tensors):
        ctx.runner, ctx.n = runner, n_streams
        inputs = [t for t in tensors[:n_streams] for _ in range(2)]
        return runner.forward(ctx, blocks, names, *inputs, *tensors[n_streams:])

    @staticmethod
    def backward(ctx, *douts):
        grads = ctx.runner.backward(ctx, *douts)
        streams = grads[2:2 + 2 * ctx.n]
        folded = [streams[2 * i] + streams[2 * i + 1] for i in range(ctx.n)]
        return (None, None, *grads[:2], *folded, *grads[2 + 2 * ctx.n:])


def _run(reference, dual, module, inputs, kwargs):
    if dual:
        blocks = reversible_dual_blocks(module.blocks(), seed=7)
        if not reference:
            return dual_reversible_sequence(blocks, *inputs, kwargs)
        params = [p for _, mods, *_ in blocks for m in mods for p in m.parameters()]
        y1, y2, n1, n2 = _OneInput.apply(_DualReversible, 2, blocks, tuple(kwargs), *inputs,
                                         *kwargs.values(), *params)
        return (y1 + y2) * 0.5, (n1 + n2) * 0.5
    couples = module.couples(seed=7)
    if not reference:
        return (reversible_sequence(couples, *inputs, kwargs),)
    params = [p for f, _, g, *_ in couples for p in (*f.parameters(), *g.parameters())]
    y1, y2 = _OneInput.apply(_Reversible, 1, couples, tuple(kwargs), *inputs, *kwargs.values(),
                             *params)
    return ((y1 + y2) * 0.5,)


@pytest.mark.parametrize("dual", [False, True])
def test_reversible_runners_are_bit_identical_to_the_one_input_runner(dual):
    if dual:
        module = init_weights_(ReversibleDualModalityDecoder(**DUAL, cross_modality_attn_every=1,
                                                             attn_dropout=0.1), 6)
        inputs = [_rnd(2, 9, 16, seed=1), _rnd(2, 7, 16, seed=2)]
        context = _rnd(2, 5, 16, seed=3)
    else:
        module = init_weights_(ReversibleTransformer(**NDA, cross_attend=True,
                                                     attn_dropout=0.1), 6)
        inputs, context = [_rnd(2, 9, 32, seed=1)], _rnd(2, 6, 32, seed=3)
    runs = []
    for reference in (True, False):
        leaves = [t.clone().requires_grad_() for t in (*inputs, context)]
        outs = _run(reference, dual, module, leaves[:-1], {"context": leaves[-1]})
        sum((o * o).sum() for o in outs).backward()
        runs.append(([o.detach() for o in outs], *_grads(module, *leaves)))
        module.zero_grad(set_to_none=True)
    (want, wparams, winputs), (got, gparams, ginputs) = runs
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert set(gparams) == set(wparams)
    assert all(torch.equal(gparams[k], wparams[k]) for k in wparams)
    assert all(torch.equal(g, w) for g, w in zip(ginputs, winputs, strict=True))


def test_pp_refuses_cp():
    """``pp_mesh`` with ``cp_mesh`` raises in the models' forward, and
    ``pipeline_parallel`` with ``context_parallel`` in the trainer, as in
    JAX; neither reads the meshes first."""
    from nuwa_tpu_torch import NUWA
    from nuwa_tpu_torch.train import NUWATrainer

    model = NUWA(dim=16, image_size=2, num_image_tokens=16, max_video_frames=2,
                 text_num_tokens=32, text_max_seq_len=4, text_enc_depth=1, text_enc_dim_head=8,
                 text_enc_heads=2, dec_depth=2, dec_dim_head=8, dec_heads=2, device="cpu")
    mesh = _mesh(data=1, pipe=2)
    text, video = np.ones((2, 4), np.int64), np.zeros((2, 8), np.int64)
    with pytest.raises(ValueError, match="PP does not compose with CP"):
        model(text, video, pp_mesh=mesh, cp_mesh=mesh)
    with pytest.raises(ValueError, match="PP does not compose with CP"):
        NUWATrainer(nuwa=model, dataset=[(text[0], video[0])], num_train_steps=1, mesh=mesh,
                    pipeline_parallel=True, context_parallel=True)
