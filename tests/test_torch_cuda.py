"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor nuwa_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips. chip_smoke.py checks the same kernels
at the full serving and training shapes.
"""
import pytest
import torch

from nuwa_tpu_torch.kernels import cross as kcross
from nuwa_tpu_torch.kernels import nda as knda


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [64, 37, 1])
def test_sparse3dna_kernel_matches_plain(dtype, tol, t):
    """4 heads of 32, fmap 4, anisotropic dilation, rel-pos bias: shapes
    other than the serving path's. out within ``tol`` (one bf16 ulp near 1
    is 7.8e-3), lse within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(t)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q, k, v = (rnd(2, 4, t, 32).to(dtype) for _ in range(3))
    kb, vb = (rnd(2, 4, 1, 32).to(dtype) for _ in range(2))
    th, bias = rnd(4, 4), rnd(4, 27)
    kw = dict(fmap=(4, 4), kernel=(3, 3, 3), dilation=(2, 1, 2))
    out, lse = knda.sparse_3dna_fwd(q, k, v, kb, vb, th, bias, **kw)
    ref, ref_lse = knda.sparse_3dna_fwd_plain(q, k, v, kb, vb, th, bias, **kw)
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_sparse3dna_wrapper_raises_on_unsupported_frames():
    """A frame of any size launches the kernel (17 x 17 = 289 tokens, past
    the 256 of the JAX package's whole-frame kernel); what the kernels do
    not take raises, with no fallback to the plain version: more than 32
    heads, a head dim over 256, more batch rows than the grid's second
    axis holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    geo = dict(fmap=(17, 17), kernel=(3, 3, 3), dilation=(1, 1, 1))
    q = torch.zeros(1, 2, 300, 8, device="cuda")
    kb = torch.zeros(1, 2, 1, 8, device="cuda")
    before = knda.sparse_3dna_fwd.launches
    out, _ = knda.sparse_3dna_fwd(q, q, q, kb, kb, torch.eye(2), **geo)
    assert knda.sparse_3dna_fwd.launches == before + 1 and out.shape == q.shape
    for shape in ((1, 33, 4, 8), (1, 2, 4, 264), (65536, 1, 1, 1)):
        x = torch.zeros(shape, device="cuda")
        xb = torch.zeros(shape[0], shape[1], 1, shape[3], device="cuda")
        with pytest.raises(ValueError):
            knda.sparse_3dna_fwd(x, x, x, xb, xb, torch.eye(shape[1]), **geo)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bwd_inputs(dtype, t, h=4, d=32, kn=45, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q, k, v, g = (rnd(2, h, t, d).to(dtype) for _ in range(4))
    q = (q.float() * d**-0.5).to(dtype)  # pre-scaled, as Sparse3DNA passes it
    kb, vb = (rnd(2, h, 1, d).to(dtype) for _ in range(2))
    th, bias = rnd(h, h), rnd(h, kn)
    return q, k, v, kb, vb, th, bias, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [64, 37, 1])
@pytest.mark.parametrize("bias", [True, False])
def test_sparse3dna_backward_kernels_match_plain(dtype, tol, t, bias):
    """4 heads of 32, fmap 4, dilation (2, 1, 2), kernel (3, 5, 3): the
    query-side and key-side kernels against their plain versions on the same
    inputs. Errors relative to each reference's max abs: sums run in another
    order (over queries per block, then over blocks). ``tol`` holds the outputs in q's
    dtype (bf16 rounds them to 8 bits of mantissa); dS, mix, dth and the
    bias cotangent are fp32 in both versions, so 1e-5 holds them in both
    runs."""
    _needs_cuda()
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, t)
    rel = rel if bias else None
    geo = dict(fmap=(4, 4), kernel=(3, 5, 3), dilation=(2, 1, 2))
    _, lse = knda.sparse_3dna_fwd_plain(q, k, v, kb, vb, th, rel, **geo)
    got = knda.sparse_3dna_bwd_q(q, k, v, kb, vb, th, rel, g, lse, **geo)
    want = knda.sparse_3dna_bwd_q_plain(q, k, v, kb, vb, th, rel, g, lse, **geo)
    got += knda.sparse_3dna_bwd_kv(q, g, got[1], got[2], **geo)
    want += knda.sparse_3dna_bwd_kv_plain(q, g, want[1], want[2], **geo)
    torch.cuda.synchronize()
    names = ("dq", "ds", "mix", "dk_bos", "dv_bos", "dth", "dbias", "dk", "dv")
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        scale = max(1.0, b.float().abs().max().item())
        bound = (tol if b.dtype == dtype else 1e-5) * scale
        assert err <= bound, f"{name}: max abs err {err} > {bound}"


@pytest.mark.cuda
def test_sparse3dna_backward_wrappers_refuse_what_the_kernels_do_not_take():
    """No quiet fallback: wrong dtypes and shapes and too many heads raise."""
    _needs_cuda()
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(torch.float32, 16, kn=27)
    geo = dict(fmap=(4, 4), kernel=(3, 3, 3), dilation=(1, 1, 1))
    _, lse = knda.sparse_3dna_fwd(q, k, v, kb, vb, th, rel, **geo)
    ds = torch.zeros(2, 4, 16, 28, device="cuda")
    with pytest.raises(TypeError):  # fp16 is not taken
        knda.sparse_3dna_bwd_q(*(x.half() for x in (q, k, v, kb, vb)), th, rel,
                               g.half(), lse, **geo)
    with pytest.raises(ValueError):  # grad in another dtype than q
        knda.sparse_3dna_bwd_q(q, k, v, kb, vb, th, rel, g.bfloat16(), lse, **geo)
    with pytest.raises(ValueError):  # lse of the wrong shape
        knda.sparse_3dna_bwd_q(q, k, v, kb, vb, th, rel, g, lse[:, :, :8], **geo)
    with pytest.raises(ValueError):  # a bias for another kernel size
        knda.sparse_3dna_bwd_q(q, k, v, kb, vb, th, rel[:, :9], g, lse, **geo)
    with pytest.raises(ValueError):  # dS with the wrong number of slots
        knda.sparse_3dna_bwd_kv(q, g, ds[..., :10], ds, **geo)
    with pytest.raises(ValueError):  # dS in bf16
        knda.sparse_3dna_bwd_kv(q, g, ds.bfloat16(), ds, **geo)
    with pytest.raises(ValueError):  # a CPU tensor beside a CUDA q
        knda.sparse_3dna_bwd_kv(q, g.cpu(), ds, ds, **geo)
    wide = torch.zeros(1, 33, 300, 8, device="cuda")
    with pytest.raises(ValueError):  # more heads than a block's 32 warps
        knda.sparse_3dna_bwd_kv(wide, wide, torch.zeros(1, 33, 300, 28, device="cuda"),
                                torch.zeros(1, 33, 300, 28, device="cuda"),
                                fmap=(17, 17), kernel=(3, 3, 3), dilation=(1, 1, 1))


def _cross_inputs(dtype, b, t, frames, fmap, h=4, d=32, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    lc = frames * fmap * fmap
    q = (rnd(b, h, t, d) * d**-0.5).to(dtype)  # pre-scaled, as SparseCross2DNA passes it
    k, v = rnd(b, h, lc, d).to(dtype), rnd(b, h, lc, d).to(dtype)
    nk, nv = rnd(b, h, 1, d).to(dtype), rnd(b, h, 1, d).to(dtype)
    return q, k, v, nk, nv, rnd(h, h)


def _cross_masks(b, frames, fmap):
    """None, all True, the last context frame masked in the last batch row
    (a padded sketch frame), all False (the unconditional half of CFG)."""
    hw = fmap * fmap
    ones = torch.ones(b, frames * hw, dtype=torch.bool, device="cuda")
    padded = ones.clone()
    padded[-1, (frames - 1) * hw:] = False
    return {"none": None, "all": ones, "padded": padded, "empty": ~ones}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("frames,fmap,dilation", [(1, 4, 1), (2, 4, 2), (3, 5, 1), (2, 16, 2)])
@pytest.mark.parametrize("t_frames", [2.0, 1.5, 0])
def test_sparse_cross2dna_kernel_matches_plain(dtype, tol, frames, fmap, dilation, t_frames):
    """4 heads of 32, one to three context frames, fmap 4, 5 and 16, full,
    ragged and single query tokens, b = 2, every form of context mask: out
    within ``tol`` of the plain version (one bf16 ulp near 1 is 7.8e-3), the
    fp32 lse within 1e-5."""
    _needs_cuda()
    hw = fmap * fmap
    t = max(int(t_frames * hw), 1)
    q, k, v, nk, nv, th = _cross_inputs(dtype, 2, t, frames, fmap)
    geo = dict(fmap=fmap, kernel_size=3, dilation=dilation)
    for name, mask in _cross_masks(2, frames, fmap).items():
        out, lse = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, **geo)
        ref, ref_lse = kcross.sparse_cross_2dna_fwd_plain(q, k, v, nk, nv, th, mask, **geo)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == ref.shape
        assert (out.float() - ref.float()).abs().max().item() <= tol, name
        assert (lse - ref_lse).abs().max().item() <= 1e-5, name
        assert torch.isfinite(lse).all()


@pytest.mark.cuda
def test_sparse_cross2dna_wrapper_refuses_what_the_kernel_does_not_take():
    """No quiet fallback: fp16, a partial context frame and a mask of another
    shape raise; a tensor that requires grad launches the kernel (the
    backward has kernels of its own) and never the plain version."""
    _needs_cuda()
    q, k, v, nk, nv, th = _cross_inputs(torch.float32, 1, 16, 2, 4)
    geo = dict(fmap=4, kernel_size=3, dilation=1)
    before = kcross.sparse_cross_2dna_fwd.launches
    kcross.sparse_cross_2dna_fwd(q.requires_grad_(), k, v, nk, nv, th, **geo)
    assert kcross.sparse_cross_2dna_fwd.launches == before + 1
    q = q.detach()
    with pytest.raises(TypeError):
        kcross.sparse_cross_2dna_fwd(*(x.half() for x in (q, k, v, nk, nv)), th, **geo)
    with pytest.raises(ValueError):
        kcross.sparse_cross_2dna_fwd(q, k[:, :, :20], v[:, :, :20], nk, nv, th, **geo)
    with pytest.raises(ValueError):
        kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th,
                                     torch.ones(1, 16, dtype=torch.bool, device="cuda"), **geo)


def _rel_err(a, b):
    return (a.float() - b.float()).abs().max().item() / max(1.0, b.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("frames,fmap,dilation", [(1, 4, 1), (2, 4, 2), (3, 5, 1), (2, 16, 2)])
@pytest.mark.parametrize("t_frames", [2.0, 1.5, 0])
def test_sparse_cross2dna_backward_kernels_match_plain(dtype, tol, frames, fmap, dilation,
                                                       t_frames):
    """The query-side and key-side cross backward against their plain
    versions, 4 heads of 32, every form of context mask, each backward
    given the lse of its own forward (as the autograd function gives it: a
    row whose context is all masked then has P = 1 exactly on the null
    column and dS = 0 there, where an lse from the other path's sums leaves
    rounding of about 1e-5 in dq). Errors relative to each reference's max
    abs: sums run in another order (over queries per block, then over
    blocks); ``tol``
    holds the outputs in q's dtype, 1e-5 the fp32 ones (dS, mix, the null
    and talking-heads cotangents)."""
    _needs_cuda()
    hw = fmap * fmap
    t = max(int(t_frames * hw), 1)
    q, k, v, nk, nv, th = _cross_inputs(dtype, 2, t, frames, fmap)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(dtype)
    geo = dict(fmap=fmap, kernel_size=3, dilation=dilation)
    names = ("dq", "ds", "mix", "dnull_k", "dnull_v", "dth", "dk", "dv")
    for mname, mask in _cross_masks(2, frames, fmap).items():
        _, lse = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, **geo)
        _, ref_lse = kcross.sparse_cross_2dna_fwd_plain(q, k, v, nk, nv, th, mask, **geo)
        got = kcross.sparse_cross_2dna_bwd_q(q, k, v, nk, nv, th, mask, g, lse, **geo)
        want = kcross.sparse_cross_2dna_bwd_q_plain(q, k, v, nk, nv, th, mask, g, ref_lse,
                                                    **geo)
        got += kcross.sparse_cross_2dna_bwd_kv(q, g, *want[1:3], **geo)
        want += kcross.sparse_cross_2dna_bwd_kv_plain(q, g, *want[1:3], **geo)
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            err = _rel_err(a, b)
            assert err <= (tol if b.dtype == dtype else 1e-5), f"{name} {mname}: {err}"


@pytest.mark.cuda
def test_sparse_cross2dna_autograd_matches_autograd_of_plain():
    """The autograd function (kernels forward and backward) against
    torch.autograd of the plain forward, fp32, a padded context frame in
    row 1: every input's gradient within 1e-5 of its max abs; each kernel
    launched once."""
    _needs_cuda()
    args = [x.requires_grad_() for x in _cross_inputs(torch.float32, 2, 40, 2, 4)]
    mask = _cross_masks(2, 2, 4)["padded"]
    g = torch.randn(2, 4, 40, 32, generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda")
    geo = dict(fmap=4, kernel_size=3, dilation=1)
    out, _ = kcross.sparse_cross_2dna_fwd_plain(*args, mask, **geo)
    want = torch.autograd.grad(out, args, g)
    fns = (kcross.sparse_cross_2dna_fwd, kcross.sparse_cross_2dna_bwd_q,
           kcross.sparse_cross_2dna_bwd_kv)
    before = [fn.launches for fn in fns]
    got = torch.autograd.grad(kcross.sparse_cross_2dna(*args, mask, **geo), args, g)
    assert [fn.launches - n for fn, n in zip(fns, before)] == [1, 1, 1]
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [48, 47, 37, 1])
def test_sparse3dna_centered_kernels_match_plain(dtype, tol, t):
    """Centered windows, 4 heads of 32, fmap 4, kernel (3, 5, 3), dilation
    (2, 1, 2), rel-pos bias: the forward, query-side and key-side kernels
    against their plain versions. t = 47 and 37 leave phantom tokens in the
    last frame, which the centered windows reach. Tolerances as in the
    causal test."""
    _needs_cuda()
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, t)
    geo = dict(fmap=(4, 4), kernel=(3, 5, 3), dilation=(2, 1, 2), mode="centered")
    args = (q, k, v, kb, vb, th, rel)
    got = knda.sparse_3dna_fwd(*args, **geo)
    want = knda.sparse_3dna_fwd_plain(*args, **geo)
    lse = want[1]
    got += knda.sparse_3dna_bwd_q(*args, g, lse, **geo)
    want += knda.sparse_3dna_bwd_q_plain(*args, g, lse, **geo)
    got += knda.sparse_3dna_bwd_kv(q, g, *want[3:5], **geo)
    want += knda.sparse_3dna_bwd_kv_plain(q, g, *want[3:5], **geo)
    torch.cuda.synchronize()
    names = ("out", "lse", "dq", "ds", "mix", "dk_bos", "dv_bos", "dth", "dbias", "dk", "dv")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = _rel_err(a, b)
        assert err <= (tol if b.dtype == dtype else 1e-5), f"{name}: {err}"


# (fmap, frames): HW 1,024 (the 128-px NUWA's frames), 400 and 32 x 9 = 288,
# all past the 256 tokens of the JAX package's whole-frame kernels
LARGE_FRAMES = [((32, 32), 2), ((20, 20), 3), ((32, 9), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fmap,frames", LARGE_FRAMES)
@pytest.mark.parametrize("causal", [True, False])
def test_sparse3dna_kernels_match_plain_past_256_tokens(dtype, tol, fmap, frames, causal):
    """Frames the JAX package gives its row-blocked kernels: 4 heads of 32,
    kernel (5, 3, 3), dilation (1, 2, 2), rel-pos bias, a ragged last frame
    (t one short of whole frames: centered windows reach its phantom token)
    and half a frame less. The forward, query-side and key-side kernels
    against their plain versions, tolerances as in the causal test."""
    _needs_cuda()
    hw = fmap[0] * fmap[1]
    for t in (frames * hw - 1, frames * hw - hw // 2):
        q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, t, seed=t)
        geo = dict(fmap=fmap, kernel=(5, 3, 3), dilation=(1, 2, 2),
                   mode="causal" if causal else "centered")
        args = (q, k, v, kb, vb, th, rel)
        got = knda.sparse_3dna_fwd(*args, **geo)
        want = knda.sparse_3dna_fwd_plain(*args, **geo)
        lse = want[1]
        got += knda.sparse_3dna_bwd_q(*args, g, lse, **geo)
        want += knda.sparse_3dna_bwd_q_plain(*args, g, lse, **geo)
        got += knda.sparse_3dna_bwd_kv(q, g, *want[3:5], **geo)
        want += knda.sparse_3dna_bwd_kv_plain(q, g, *want[3:5], **geo)
        torch.cuda.synchronize()
        names = ("out", "lse", "dq", "ds", "mix", "dk_bos", "dv_bos", "dth", "dbias", "dk",
                 "dv")
        for name, a, b in zip(names, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            err = _rel_err(a, b)
            assert err <= (tol if b.dtype == dtype else 1e-5), f"{name} t={t}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_deterministic(dtype):
    """Every output of the Sparse3DNA and cross backward kernels, dq, dk and
    dv and the sums over queries included, is equal bit for bit across two
    calls on the same inputs: the sums over queries run per block, then in
    one fixed order over the blocks."""
    _needs_cuda()
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, 2 * 1024 - 1)
    geo = dict(fmap=(32, 32), kernel=(5, 3, 3), dilation=(1, 2, 2))
    _, lse = knda.sparse_3dna_fwd(q, k, v, kb, vb, th, rel, **geo)
    runs = []
    for _ in range(2):
        got = knda.sparse_3dna_bwd_q(q, k, v, kb, vb, th, rel, g, lse, **geo)
        runs.append(got + knda.sparse_3dna_bwd_kv(q, g, got[1], got[2], **geo))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    q, k, v, nk, nv, th = _cross_inputs(dtype, 2, 5 * 16 * 16, 2, 16)
    mask = _cross_masks(2, 2, 16)["padded"]
    geo = dict(fmap=16, kernel_size=3, dilation=1)
    _, lse = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, **geo)
    runs = []
    for _ in range(2):
        got = kcross.sparse_cross_2dna_bwd_q(q, k, v, nk, nv, th, mask, q, lse, **geo)
        runs.append(got + kcross.sparse_cross_2dna_bwd_kv(q, q, got[1], got[2], **geo))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("height,kernel,dilation", [(1, 7, 1), (3, 5, 2), (32, 7, 1)])
@pytest.mark.parametrize("ragged", [False, True])
def test_sparse3dna_audio_kernel_matches_plain(dtype, tol, height, kernel, dilation, ragged):
    """The forward kernel in SparseCausal2DNA's audio geometry, a (timesteps,
    1, H) grid whose window spans whole timesteps: 4 heads of 32, rel-pos
    bias, 10 timesteps, whole or with half the last one missing; the launch
    counted as an audio one. Tolerances as in the causal test."""
    _needs_cuda()
    t = 10 * height - (height // 2 if ragged else 0)
    q, k, v, kb, vb, th, rel, _ = _bwd_inputs(dtype, t, kn=kernel * height, seed=t)
    geo = dict(fmap=(1, height), kernel=(kernel, 1, height), dilation=(dilation, 1, 1),
               mode="audio")
    before = knda.sparse_3dna_fwd.mode_launches["audio"]
    got = knda.sparse_3dna_fwd(q, k, v, kb, vb, th, rel, **geo)
    want = knda.sparse_3dna_fwd_plain(q, k, v, kb, vb, th, rel, **geo)
    torch.cuda.synchronize()
    assert knda.sparse_3dna_fwd.mode_launches["audio"] == before + 1
    for name, a, b in zip(("out", "lse"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = _rel_err(a, b)
        assert err <= (tol if b.dtype == dtype else 1e-5), f"{name}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("height,kernel,dilation", [(1, 7, 1), (3, 5, 2), (32, 7, 1)])
@pytest.mark.parametrize("ragged", [False, True])
def test_sparse3dna_audio_backward_kernels_match_plain(dtype, tol, height, kernel, dilation,
                                                       ragged):
    """The query-side and key-side kernels in the audio geometry, where the
    key side's pairs are a key's one slot per time tap read by every query
    of a timestep: 4 heads of 32, rel-pos bias, 10 timesteps, whole or with
    half the last one missing, against their plain versions (tolerances as
    in the causal test, the launches counted as audio ones), every output
    equal bit for bit across two calls, and the autograd function against
    autograd of the plain forward in fp32 (1e-5 of each gradient's max abs);
    a geometry that is not (1, H) x (K, 1, H) raises ValueError."""
    _needs_cuda()
    t = 10 * height - (height // 2 if ragged else 0)
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, t, kn=kernel * height, seed=t + 1)
    geo = dict(fmap=(1, height), kernel=(kernel, 1, height), dilation=(dilation, 1, 1),
               mode="audio")
    _, lse = knda.sparse_3dna_fwd_plain(q, k, v, kb, vb, th, rel, **geo)
    before = [fn.mode_launches["audio"] for fn in (knda.sparse_3dna_bwd_q,
                                                  knda.sparse_3dna_bwd_kv)]
    runs = []
    for _ in range(2):
        got = knda.sparse_3dna_bwd_q(q, k, v, kb, vb, th, rel, g, lse, **geo)
        runs.append(got + knda.sparse_3dna_bwd_kv(q, g, got[1], got[2], **geo))
    want = knda.sparse_3dna_bwd_q_plain(q, k, v, kb, vb, th, rel, g, lse, **geo)
    want += knda.sparse_3dna_bwd_kv_plain(q, g, want[1], want[2], **geo)
    torch.cuda.synchronize()
    assert [fn.mode_launches["audio"] for fn in (
        knda.sparse_3dna_bwd_q, knda.sparse_3dna_bwd_kv)] == [n + 2 for n in before]
    names = ("dq", "ds", "mix", "dk_bos", "dv_bos", "dth", "dbias", "dk", "dv")
    for name, a, a2, b in zip(names, *runs, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, a2), name
        err = _rel_err(a, b)
        assert err <= (tol if b.dtype == dtype else 1e-5), f"{name}: {err}"
    if dtype == torch.float32:
        leaves = [x.detach().requires_grad_() for x in (q, k, v, kb, vb, th, rel)]
        out, _ = knda.sparse_3dna_fwd_plain(*leaves, **geo)
        wants = torch.autograd.grad(out, leaves, g)
        gots = torch.autograd.grad(knda.sparse_3dna(*leaves, **geo), leaves, g)
        for name, a, b in zip(("q", "k", "v", "k_bos", "v_bos", "th", "bias"), gots, wants):
            assert _rel_err(a, b) <= 1e-5, name
    with pytest.raises(ValueError):
        knda.sparse_3dna_bwd_kv(q, g, want[1], want[2], **dict(geo, kernel=(kernel, 1, 2)))


DROPOUT_GEOMETRIES = {
    "causal": (dict(fmap=(4, 4), kernel=(3, 5, 3), dilation=(2, 1, 2)), 45, 37),
    "centered": (dict(fmap=(4, 4), kernel=(3, 3, 3), dilation=(1, 2, 1), mode="centered"),
                 27, 47),
    "fmap 32": (dict(fmap=(32, 32), kernel=(5, 3, 3), dilation=(1, 2, 2)), 45, 2047),
    "audio H=4": (dict(fmap=(1, 4), kernel=(7, 1, 4), dilation=(1, 1, 1), mode="audio"),
                  28, 38),
    "audio H=1": (dict(fmap=(1, 1), kernel=(7, 1, 1), dilation=(2, 1, 1), mode="audio"),
                  7, 40),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("geometry", list(DROPOUT_GEOMETRIES))
def test_sparse3dna_dropout_kernels_match_plain(dtype, tol, geometry):
    """The three kernels with attention dropout at rate 0.1 against their
    plain versions (the same counter-hash mask) in every geometry: every
    output within the causal test's tolerances, every backward output equal
    bit for bit across two calls, each launch counted as a dropout one; the
    autograd function with dropout against autograd of the plain forward in
    fp32 (1e-5 of each gradient's max abs); a rate of 0, or no seed, gives
    the output of the launch without dropout bit for bit."""
    _needs_cuda()
    geo, kn, t = DROPOUT_GEOMETRIES[geometry]
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, t, kn=kn, seed=t + 2)
    drop = (0.1, 1234567)
    fns = (knda.sparse_3dna_fwd, knda.sparse_3dna_bwd_q, knda.sparse_3dna_bwd_kv)
    before = [fn.mode_launches["dropout"] for fn in fns]
    out, lse = knda.sparse_3dna_fwd(q, k, v, kb, vb, th, rel, dropout=drop, **geo)
    ref, ref_lse = knda.sparse_3dna_fwd_plain(q, k, v, kb, vb, th, rel, dropout=drop, **geo)
    runs = []
    for _ in range(2):
        got = knda.sparse_3dna_bwd_q(q, k, v, kb, vb, th, rel, g, lse, dropout=drop, **geo)
        runs.append(got + knda.sparse_3dna_bwd_kv(q, g, got[1], got[2], dropout=drop, **geo))
    want = knda.sparse_3dna_bwd_q_plain(q, k, v, kb, vb, th, rel, g, lse, dropout=drop, **geo)
    want += knda.sparse_3dna_bwd_kv_plain(q, g, want[1], want[2], **geo)
    torch.cuda.synchronize()
    assert [fn.mode_launches["dropout"] for fn in fns] == [before[0] + 1, before[1] + 2,
                                                            before[2] + 2]
    names = ("out", "lse", "dq", "ds", "mix", "dk_bos", "dv_bos", "dth", "dbias", "dk", "dv")
    for name, a, a2, b in zip(names, (out, lse, *runs[0]), (out, lse, *runs[1]),
                              (ref, ref_lse, *want)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, a2), name
        err = _rel_err(a, b)
        assert err <= (tol if b.dtype == dtype else 1e-5), f"{name}: {err}"
    # about a tenth of the valid pairs' mixed probabilities dropped
    valid = knda.sparse_3dna_bwd_q_plain(q, k, v, kb, vb, th, rel, g, lse, **geo)[2] != 0
    share = ((runs[0][2] == 0) & valid).sum().item() / valid.sum().item()
    assert abs(share - 0.1) < 0.03, share
    plain_out, _ = knda.sparse_3dna_fwd(q, k, v, kb, vb, th, rel, **geo)
    for off in ((0.0, 7), (0.1, None), None):
        again, _ = knda.sparse_3dna_fwd(q, k, v, kb, vb, th, rel, dropout=off, **geo)
        assert torch.equal(again, plain_out)
    if dtype == torch.float32:
        leaves = [x.detach().requires_grad_() for x in (q, k, v, kb, vb, th, rel)]
        out, _ = knda.sparse_3dna_fwd_plain(*leaves, dropout=drop, **geo)
        wants = torch.autograd.grad(out, leaves, g)
        gots = torch.autograd.grad(knda.sparse_3dna(*leaves, dropout=drop, **geo), leaves, g)
        for a, b in zip(gots, wants):
            assert _rel_err(a, b) <= 1e-5


# (context frames, fmap, dilation, video queries): Fc = 1 and 2, each ragged;
# fmap 16 at two context frames is the sketch training shape's geometry
CROSS_DROPOUT_CASES = {"Fc=1": (1, 4, 1, 37), "Fc=2": (2, 4, 2, 45),
                       "Fc=2, fmap 16": (2, 16, 1, 700)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(CROSS_DROPOUT_CASES))
def test_sparse_cross2dna_dropout_kernels_match_plain(dtype, tol, case):
    """The cross forward and both backward kernels with attention dropout at
    rate 0.1 against their plain versions (the same counter-hash mask), the
    context masks of the test without dropout, each backward given the lse
    of its own forward as there: every output within that test's
    tolerances, every backward output equal bit for bit across two
    calls, each launch counted as a dropout one; the autograd function with
    dropout against autograd of the plain forward in fp32 (1e-5 of each
    gradient's max abs); a rate of 0, or no seed, gives the output of the
    launch without dropout bit for bit."""
    _needs_cuda()
    frames, fmap, dilation, t = CROSS_DROPOUT_CASES[case]
    q, k, v, nk, nv, th = _cross_inputs(dtype, 2, t, frames, fmap, seed=t)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda").to(dtype)
    geo = dict(fmap=fmap, kernel_size=3, dilation=dilation)
    drop = (0.1, 1234567)
    fns = (kcross.sparse_cross_2dna_fwd, kcross.sparse_cross_2dna_bwd_q,
           kcross.sparse_cross_2dna_bwd_kv)
    names = ("out", "lse", "dq", "ds", "mix", "dnull_k", "dnull_v", "dth", "dk", "dv")
    for mname, mask in _cross_masks(2, frames, fmap).items():
        before = [fn.mode_launches["dropout"] for fn in fns]
        out, lse = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, **geo, dropout=drop)
        ref, ref_lse = kcross.sparse_cross_2dna_fwd_plain(q, k, v, nk, nv, th, mask, **geo,
                                                          dropout=drop)
        runs = []
        for _ in range(2):
            got = kcross.sparse_cross_2dna_bwd_q(q, k, v, nk, nv, th, mask, g, lse, **geo,
                                                 dropout=drop)
            runs.append(got + kcross.sparse_cross_2dna_bwd_kv(q, g, got[1], got[2], **geo,
                                                              dropout=drop))
        want = kcross.sparse_cross_2dna_bwd_q_plain(q, k, v, nk, nv, th, mask, g, ref_lse,
                                                    **geo, dropout=drop)
        want += kcross.sparse_cross_2dna_bwd_kv_plain(q, g, want[1], want[2], **geo)
        torch.cuda.synchronize()
        assert [fn.mode_launches["dropout"] - n for fn, n in zip(fns, before)] == [1, 2, 2]
        for name, a, a2, b in zip(names, (out, lse, *runs[0]), (out, lse, *runs[1]),
                                  (ref, ref_lse, *want)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, a2), name
            err = _rel_err(a, b)
            assert err <= (tol if b.dtype == dtype else 1e-5), f"{name} {mname}: {err}"
        plain_out, _ = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, **geo)
        for off in ((0.0, 7), (0.1, None), None):
            again, _ = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, **geo,
                                                    dropout=off)
            assert torch.equal(again, plain_out), mname
    # about a tenth of the valid pairs' mixed probabilities dropped
    mask = _cross_masks(2, frames, fmap)["padded"]
    _, lse = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, **geo)
    valid = kcross.sparse_cross_2dna_bwd_q(q, k, v, nk, nv, th, mask, g, lse, **geo)[2] != 0
    dropped = kcross.sparse_cross_2dna_bwd_q(q, k, v, nk, nv, th, mask, g, lse, **geo,
                                             dropout=drop)[2] == 0
    share = (dropped & valid).sum().item() / valid.sum().item()
    assert abs(share - 0.1) < 0.03, share
    if dtype == torch.float32:
        leaves = [x.detach().requires_grad_() for x in (q, k, v, nk, nv, th)]
        out, _ = kcross.sparse_cross_2dna_fwd_plain(*leaves, mask, **geo, dropout=drop)
        wants = torch.autograd.grad(out, leaves, g)
        gots = torch.autograd.grad(kcross.sparse_cross_2dna(*leaves, mask, **geo, dropout=drop),
                                   leaves, g)
        for a, b in zip(gots, wants):
            assert _rel_err(a, b) <= 1e-5


# (tile candidates (rows, columns, buffers of the ring each head's window
# union is staged in, or 0 to read through L1), first choice first; fmap, kernel, dilation, mode; t;
# heads, head dim): each case passes its candidates to the wrappers, so
# small shapes run the tiles the main path's large ones take. Ragged tiles
# at a frame's edge (fmap 12, 12 x 9), a ragged last frame, frames narrower
# than a tile (fmap 4, audio H = 1 and 4, where the candidates fall to 1 x 4
# and one query), dilation 4 (the widest union) and anisotropic dilations,
# 32 heads of 256, one head, and the rows read through L1 (17 heads: a
# block of 288 threads).
TILE_CASES = {
    "2x2 causal fmap 12": (((2, 2, 2),), dict(fmap=(12, 12), kernel=(5, 3, 3),
                                              dilation=(1, 2, 2)), 2 * 144 - 7, 4, 32),
    "1x2 centered 12x9, ring 3": (((1, 2, 3),), dict(fmap=(12, 9), kernel=(3, 3, 3),
                                                     dilation=(2, 1, 3), mode="centered"),
                                  3 * 108 - 50, 4, 32),
    "4x4 dilation 4": (((4, 4, 2),), dict(fmap=(12, 12), kernel=(5, 3, 3), dilation=(4, 4, 4)),
                       2 * 144 - 1, 2, 16),
    "2x2 dilation 4, ring 4": (((2, 2, 4),), dict(fmap=(12, 12), kernel=(5, 3, 3),
                                                  dilation=(4, 4, 4)), 2 * 144 - 1, 4, 32),
    "4x8 fmap 12": (((4, 8, 2),), dict(fmap=(12, 12), kernel=(5, 3, 3), dilation=(2, 2, 2)),
                    2 * 144 - 20, 4, 32),
    "2x4 fmap 4": (((8, 8, 2), (2, 4, 2)), dict(fmap=(4, 4), kernel=(3, 5, 3),
                                                dilation=(2, 1, 2)), 37, 4, 32),
    "audio H=4": (((2, 2, 2), (1, 4, 3)), dict(fmap=(1, 4), kernel=(7, 1, 4), dilation=(1, 1, 1),
                                               mode="audio"), 38, 4, 32),
    "audio H=1": (((2, 2, 2), (1, 2, 2), (1, 1, 4)), dict(fmap=(1, 1), kernel=(7, 1, 1),
                                                          dilation=(2, 1, 1), mode="audio"),
                  40, 4, 32),
    "32 heads of 256": (((2, 2, 2),), dict(fmap=(4, 4), kernel=(3, 3, 3), dilation=(1, 1, 1)),
                        37, 32, 256),
    "one head": (((2, 2, 2),), dict(fmap=(8, 8), kernel=(3, 3, 3), dilation=(1, 2, 1),
                                    mode="centered"), 2 * 64 - 3, 1, 64),
    "2x2 through L1": (((2, 2, 0),), dict(fmap=(12, 12), kernel=(5, 3, 3),
                                          dilation=(1, 2, 2)), 2 * 144 - 7, 4, 32),
    "17 heads through L1": (((1, 1, 0),), dict(fmap=(4, 4), kernel=(3, 3, 3),
                                               dilation=(1, 1, 1)), 37, 17, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("drop", [None, (0.1, 1234567)])
def test_sparse3dna_tiles_match_plain(dtype, tol, case, drop):
    """The forward and query-side kernels at the query tiles of
    ``kernels.nda.tile_plan`` (each case's candidates: the first that fits
    its frame, else the last) against their plain versions, with and
    without dropout: out, lse and every query-side output within the
    causal test's tolerances, every query-side output equal bit for bit
    across two calls, and the launch planned with the tile the case names."""
    _needs_cuda()
    tiles, geo, t, h, d = TILE_CASES[case]
    kn = geo["kernel"][0] * geo["kernel"][1] * geo["kernel"][2]
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, t, h=h, d=d, kn=kn, seed=t + 3)
    args = (q, k, v, kb, vb, th, rel)
    plan = knda.launch_plan("bwd_q", q, **geo, tiles=tiles)
    fits = [tile for tile in tiles if tile[0] <= geo["fmap"][0] and tile[1] <= geo["fmap"][1]]
    assert (plan["ty"], plan["tx"], plan["stage"]) == (fits or tiles[-1:])[0]
    got = knda.sparse_3dna_fwd(*args, dropout=drop, tiles=tiles, **geo)
    want = knda.sparse_3dna_fwd_plain(*args, dropout=drop, **geo)
    lse = want[1]
    runs = [knda.sparse_3dna_bwd_q(*args, g, lse, dropout=drop, tiles=tiles, **geo)
            for _ in range(2)]
    want += knda.sparse_3dna_bwd_q_plain(*args, g, lse, dropout=drop, **geo)
    torch.cuda.synchronize()
    for a, a2 in zip(*runs):
        assert torch.equal(a, a2)
    names = ("out", "lse", "dq", "ds", "mix", "dk_bos", "dv_bos", "dth", "dbias")
    for name, a, b in zip(names, (*got, *runs[0]), want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = _rel_err(a, b)
        assert err <= (tol if b.dtype == dtype else 1e-5), f"{name}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("drop", [None, (0.1, 1234567)])
def test_sparse3dna_bwd_kv_tiles_match_plain(dtype, tol, case, drop):
    """The key-side kernel at the key tiles of each case (its candidates read
    through L1: the key side stages nothing), fed the query side's dS and
    mix with and without dropout, against its plain version: dk and dv
    within the causal test's tolerance, equal bit for bit across two calls,
    and the launch planned with the tile the case names."""
    _needs_cuda()
    tiles, geo, t, h, d = TILE_CASES[case]
    tiles = tuple((ty, tx, 0) for ty, tx, _ in tiles)
    kn = geo["kernel"][0] * geo["kernel"][1] * geo["kernel"][2]
    q, k, v, kb, vb, th, rel, g = _bwd_inputs(dtype, t, h=h, d=d, kn=kn, seed=t + 5)
    plan = knda.launch_plan("bwd_kv", q, **geo, tiles=tiles)
    fits = [tile for tile in tiles if tile[0] <= geo["fmap"][0] and tile[1] <= geo["fmap"][1]]
    assert (plan["ty"], plan["tx"], plan["stage"]) == (fits or tiles[-1:])[0]
    _, lse = knda.sparse_3dna_fwd_plain(q, k, v, kb, vb, th, rel, dropout=drop, **geo)
    _, ds, mix, *_ = knda.sparse_3dna_bwd_q_plain(q, k, v, kb, vb, th, rel, g, lse,
                                                  dropout=drop, **geo)
    runs = [knda.sparse_3dna_bwd_kv(q, g, ds, mix, dropout=drop, tiles=tiles, **geo)
            for _ in range(2)]
    want = knda.sparse_3dna_bwd_kv_plain(q, g, ds, mix, **geo)
    torch.cuda.synchronize()
    for name, a, a2, b in zip(("dk", "dv"), *runs, want):
        assert torch.equal(a, a2), name
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        err = _rel_err(a, b)
        assert err <= tol, f"{name}: {err}"


# (tile candidates, first choice first; context frames, fmap, dilation;
# video queries; heads, head dim): the cross query side's tiles of query
# positions forced on small shapes. Ragged tiles at a frame's edge (fmap 5),
# a ragged last query frame, frames narrower than a tile (fmap 4, where 8 x
# 8 falls to the next candidate), dilation 2, one query a block, rows not
# 16-byte aligned (17 heads of 37), 32 heads of 256 and one head. The cross
# window has one dilation for both axes.
CROSS_TILE_CASES = {
    "2x2 fmap 5": (((2, 2, 0),), 2, 5, 1, 2 * 25 - 3, 4, 32),
    "4x4 fmap 5 dilation 2": (((4, 4, 0),), 1, 5, 2, 3 * 25, 4, 32),
    "8x8 falls to 1x4": (((8, 8, 0), (1, 4, 0)), 2, 4, 2, 37, 4, 32),
    "2x4 fmap 16": (((2, 4, 0),), 2, 16, 1, 700, 4, 32),
    "one query, Fc 3": (((1, 1, 0),), 3, 4, 1, 37, 4, 32),
    "17 heads of 37": (((2, 2, 0),), 1, 4, 2, 37, 17, 37),
    "32 heads of 256": (((2, 2, 0),), 1, 4, 1, 37, 32, 256),
    "one head": (((1, 2, 0),), 2, 5, 1, 40, 1, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(CROSS_TILE_CASES))
@pytest.mark.parametrize("drop", [None, (0.1, 1234567)])
def test_sparse_cross2dna_tiles_match_plain(dtype, tol, case, drop):
    """The cross query side at the tiles of each case, every form of
    context mask, with and without dropout, given the lse of its own
    forward: every output within the cross backward test's tolerances,
    equal bit for bit across two calls, and the launch planned with the
    tile the case names."""
    _needs_cuda()
    tiles, frames, fmap, dilation, t, h, d = CROSS_TILE_CASES[case]
    q, k, v, nk, nv, th = _cross_inputs(dtype, 2, t, frames, fmap, h=h, d=d, seed=t)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda").to(dtype)
    geo = dict(fmap=fmap, kernel_size=3, dilation=dilation)
    plan = kcross.launch_plan(q, k.shape[2], **geo, tiles=tiles)
    fits = [tile for tile in tiles if tile[0] <= fmap and tile[1] <= fmap]
    assert (plan["ty"], plan["tx"]) == (fits or tiles[-1:])[0][:2]
    names = ("dq", "ds", "mix", "dnull_k", "dnull_v", "dth")
    for mname, mask in _cross_masks(2, frames, fmap).items():
        _, lse = kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, dropout=drop, **geo)
        _, ref_lse = kcross.sparse_cross_2dna_fwd_plain(q, k, v, nk, nv, th, mask, **geo)
        runs = [kcross.sparse_cross_2dna_bwd_q(q, k, v, nk, nv, th, mask, g, lse, dropout=drop,
                                               tiles=tiles, **geo) for _ in range(2)]
        want = kcross.sparse_cross_2dna_bwd_q_plain(q, k, v, nk, nv, th, mask, g, ref_lse,
                                                    dropout=drop, **geo)
        torch.cuda.synchronize()
        for name, a, a2, b in zip(names, *runs, want):
            assert torch.equal(a, a2), f"{name} {mname}"
            assert a.dtype == b.dtype and a.shape == b.shape, name
            err = _rel_err(a, b)
            assert err <= (tol if b.dtype == dtype else 1e-5), f"{name} {mname}: {err}"


# (tile candidates, first choice first; context frames, fmap, dilation;
# video queries; heads, head dim): the cross forward's tiles of query
# positions, frame-spanning ones among them (a fourth number: query frames a
# tile), forced on small shapes. Ragged tiles at a frame's edge (fmap 5), a
# ragged last query frame and a last frame group short of its frames, frames
# narrower than a tile (fmap 4, where 8 x 8 falls to the next candidate),
# dilation 2, Fc 1-3, rows not 16-byte aligned (17 heads of 37), 32 heads of
# 256 and one head.
CROSS_FWD_TILE_CASES = {
    "2x4 fmap 16": (((2, 4, 0, 1),), 2, 16, 1, 700, 4, 32),
    "2x4x2 frames fmap 16": (((2, 4, 0, 2),), 1, 16, 1, 3 * 256 - 5, 4, 32),
    "2x2x3 frames fmap 5": (((2, 2, 0, 3),), 3, 5, 1, 4 * 25 - 3, 4, 32),
    "4x4 fmap 5 dilation 2": (((4, 4, 0),), 1, 5, 2, 3 * 25, 4, 32),
    "8x8 falls to 1x4x2": (((8, 8, 0, 2), (1, 4, 0, 2)), 2, 4, 2, 37, 4, 32),
    "one query, Fc 3": (((1, 1, 0),), 3, 4, 1, 37, 4, 32),
    "17 heads of 37": (((2, 2, 0, 2),), 1, 4, 2, 37, 17, 37),
    "32 heads of 256": (((2, 2, 0),), 1, 4, 1, 37, 32, 256),
    "one head": (((1, 2, 0, 2),), 2, 5, 1, 40, 1, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(CROSS_FWD_TILE_CASES))
@pytest.mark.parametrize("drop", [None, (0.1, 1234567)])
def test_sparse_cross2dna_fwd_tiles_match_plain(dtype, tol, case, drop):
    """The cross forward at the tiles of each case, every form of context
    mask (an all-masked row among them), with and without dropout: out
    within ``tol`` of the plain version, the fp32 lse within 1e-5 and
    finite, equal bit for bit across two calls, and the launch planned with
    the tile the case names."""
    _needs_cuda()
    tiles, frames, fmap, dilation, t, h, d = CROSS_FWD_TILE_CASES[case]
    q, k, v, nk, nv, th = _cross_inputs(dtype, 2, t, frames, fmap, h=h, d=d, seed=t)
    geo = dict(fmap=fmap, kernel_size=3, dilation=dilation)
    plan = kcross.launch_plan(q, k.shape[2], **geo, tiles=tiles, which="cross_fwd")
    fits = [tile for tile in tiles if tile[0] <= fmap and tile[1] <= fmap]
    want = (fits or tiles[-1:])[0]
    assert (plan["ty"], plan["tx"], plan["tf"]) == (*want[:2], (want[3:] or (1,))[0])
    for mname, mask in _cross_masks(2, frames, fmap).items():
        runs = [kcross.sparse_cross_2dna_fwd(q, k, v, nk, nv, th, mask, dropout=drop,
                                             tiles=tiles, **geo) for _ in range(2)]
        ref, ref_lse = kcross.sparse_cross_2dna_fwd_plain(q, k, v, nk, nv, th, mask,
                                                          dropout=drop, **geo)
        torch.cuda.synchronize()
        (out, lse), (out2, lse2) = runs
        assert torch.equal(out, out2) and torch.equal(lse, lse2), mname
        assert out.dtype == dtype and out.shape == ref.shape
        assert _rel_err(out, ref) <= tol, f"out {mname}: {_rel_err(out, ref)}"
        assert (lse - ref_lse).abs().max().item() <= 1e-5, mname
        assert torch.isfinite(lse).all()


# (key tile candidates, a fourth number: heads a block; context frames,
# fmap, dilation; video queries; heads, head dim): the cross key side's
# tiles and head splits forced on small shapes, the same forms as the
# forward's, and a head split that leaves the last block fewer heads.
CROSS_KV_TILE_CASES = {
    "2x4 one head a block fmap 16": (((2, 4, 0, 1),), 2, 16, 1, 700, 4, 32),
    "2x4 all heads fmap 16": (((2, 4, 0),), 1, 16, 2, 3 * 256 - 5, 4, 32),
    "2x2 3 of 4 heads fmap 5": (((2, 2, 0, 3),), 3, 5, 1, 4 * 25 - 3, 4, 32),
    "4x4 fmap 5 dilation 2": (((4, 4, 0, 2),), 1, 5, 2, 3 * 25, 4, 32),
    "8x8 falls to 1x4": (((8, 8, 0, 1), (1, 4, 0, 1)), 2, 4, 2, 37, 4, 32),
    "one key, Fc 3": (((1, 1, 0, 1),), 3, 4, 1, 37, 4, 32),
    "one query": (((2, 4, 0, 1),), 2, 4, 1, 1, 4, 32),
    "17 heads of 37": (((2, 2, 0, 5),), 1, 4, 2, 37, 17, 37),
    "32 heads of 256": (((2, 2, 0, 1),), 1, 4, 1, 37, 32, 256),
    "one head": (((1, 2, 0, 2),), 2, 5, 1, 40, 1, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(CROSS_KV_TILE_CASES))
@pytest.mark.parametrize("drop", [None, (0.1, 1234567)])
def test_sparse_cross2dna_bwd_kv_tiles_match_plain(dtype, tol, case, drop):
    """The cross key side at the tiles and head splits of each case, fed the
    plain query side's dS and mix (with dropout: the dropped mix) under
    every form of context mask: dk and dv within ``tol`` of the plain
    version, equal bit for bit across two calls, and the launch planned with
    the tile and head split the case names."""
    _needs_cuda()
    tiles, frames, fmap, dilation, t, h, d = CROSS_KV_TILE_CASES[case]
    q, k, v, nk, nv, th = _cross_inputs(dtype, 2, t, frames, fmap, h=h, d=d, seed=t)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda").to(dtype)
    geo = dict(fmap=fmap, kernel_size=3, dilation=dilation)
    plan = kcross.launch_plan(q, k.shape[2], **geo, tiles=tiles, which="cross_bwd_kv")
    fits = [tile for tile in tiles if tile[0] <= fmap and tile[1] <= fmap]
    want = (fits or tiles[-1:])[0]
    assert (plan["ty"], plan["tx"], plan["hs"]) == (*want[:2], min(h, (want[3:] or (h,))[0]))
    for mname, mask in _cross_masks(2, frames, fmap).items():
        _, lse = kcross.sparse_cross_2dna_fwd_plain(q, k, v, nk, nv, th, mask, **geo)
        _, ds, mix, *_ = kcross.sparse_cross_2dna_bwd_q_plain(q, k, v, nk, nv, th, mask, g, lse,
                                                              dropout=drop, **geo)
        runs = [kcross.sparse_cross_2dna_bwd_kv(q, g, ds, mix, dropout=drop, tiles=tiles, **geo)
                for _ in range(2)]
        want = kcross.sparse_cross_2dna_bwd_kv_plain(q, g, ds, mix, **geo)
        torch.cuda.synchronize()
        for name, a, a2, b in zip(("dk", "dv"), *runs, want):
            assert torch.equal(a, a2), f"{name} {mname}"
            assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
            err = _rel_err(a, b)
            assert err <= tol, f"{name} {mname}: {err}"


# ---------------------------------------------------------------------------
# the surface on the card: method="full", int8 weights, the dense causal
# decoder and checkpoints, small, fp32, against the same module on the CPU
# ---------------------------------------------------------------------------

SMALL_NUWA = dict(dim=32, image_size=4, num_image_tokens=64, max_video_frames=2,
                  text_num_tokens=100, text_max_seq_len=8, text_enc_depth=1,
                  text_enc_dim_head=16, text_enc_heads=2, dec_depth=2, dec_dim_head=16,
                  dec_heads=2, sparse_3dna_kernel_size=3, sparse_3dna_dilation=2,
                  shift_video_tokens=True, sparse_3dna_rel_pos_bias=True)
SMALL_TEXT = [[1, 2, 3, 0, 0], [4, 5, 6, 7, 0]]


def _small_nuwa(device, seed=0, **kw):
    from nuwa_tpu_torch import NUWA

    return NUWA(**dict(SMALL_NUWA, **kw), device=device, seed=seed)


@pytest.mark.cuda
def test_full_generate_launches_the_kernel_and_equals_cached():
    """Greedy method="full" on the card: every token re-runs the decoder
    (its depth launches of the forward kernel), and gives the ids of
    method="cached" on the card and of method="full" on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu, cpu = _small_nuwa("cuda"), _small_nuwa("cpu")
    kw = dict(filter_thres=1 - 0.5 / 64, cond_scale=2.0)
    knda.reset_launches()
    full = gpu.generate(SMALL_TEXT, method="full", **kw)
    assert knda.sparse_3dna_fwd.launches == 32 * 2
    assert torch.equal(full, gpu.generate(SMALL_TEXT, **kw))
    assert torch.equal(full.cpu(), cpu.generate(SMALL_TEXT, method="full", **kw))
    long = gpu.generate_long(SMALL_TEXT, num_frames=3, method="full", **kw)
    assert torch.equal(long, gpu.generate_long(SMALL_TEXT, num_frames=3, **kw))


@pytest.mark.cuda
def test_int8_model_on_the_card_matches_the_cpu():
    """quantize_int8_ on the card and on the CPU: the same int8 weights, the
    logits within 1e-4, the forward kernel launched as by the float model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nuwa_tpu_torch.utils.quantize import quantize_int8_

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu, cpu = quantize_int8_(_small_nuwa("cuda")), quantize_int8_(_small_nuwa("cpu"))
    assert torch.equal(gpu.to_logits.w.cpu(), cpu.to_logits.w)
    video = torch.randint(0, 64, (2, 32), generator=torch.Generator().manual_seed(1))
    knda.reset_launches()
    with torch.no_grad():
        a, b = gpu(SMALL_TEXT, video), cpu(SMALL_TEXT, video)
    assert knda.sparse_3dna_fwd.launches == 2
    assert (a.cpu() - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_dense_causal_decoder_on_the_card_matches_the_cpu():
    """BASELINE config 2's decoder, small: the forward against the CPU and
    the cached steps after a prefill against the forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from nuwa_tpu_torch.core.layers import init_weights_
    from nuwa_tpu_torch.decode import TransformerDecoder
    from nuwa_tpu_torch.transformer import Transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = init_weights_(Transformer(dim=32, depth=2, heads=2, dim_head=16, causal=True,
                                    cross_attend=True), 3)
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(2)
    x, ctx = torch.randn(2, 17, 32, generator=gen), torch.randn(2, 8, 32, generator=gen)
    mask = torch.tensor([[True] * 8, [True] * 5 + [False] * 3])
    with torch.no_grad():
        out = gpu(x.cuda(), context=ctx.cuda(), context_mask=mask.cuda())
        assert (out.cpu() - cpu(x, context=ctx, context_mask=mask)).abs().max() <= 1e-5
        dec = TransformerDecoder(gpu, total_in=17)
        caches = dec.init_cache(2, ctx.cuda(), mask.cuda())
        dec.prefill(caches, x[:, :9].cuda())
        steps = torch.stack([dec.step(caches, x[:, i].cuda(), i) for i in range(9, 17)], 1)
    assert (steps - out[:, 9:]).abs().max() <= 1e-5


@pytest.mark.cuda
def test_resume_on_the_card_equals_the_uninterrupted_run(tmp_path):
    """NUWATrainer on the card: 2 steps with a checkpoint after each, a fresh
    trainer resumed from the folder, step 3 of both: the same loss and
    parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from nuwa_tpu_torch.train import NUWATrainer

    rng = np.random.default_rng(0)
    pair = (np.array([3, 4, 5, 0, 0]), rng.integers(0, 64, 32))
    kw = dict(dataset=[pair, pair], num_train_steps=3, lr=1e-3, batch_size=2,
              grad_accum_every=1, save_results_every=100, cond_dropout_prob=0.5,
              results_folder=tmp_path)
    first = NUWATrainer(nuwa=_small_nuwa("cuda", seed=1), save_model_every=1, **kw)
    first.train_step(), first.train_step()
    resumed = NUWATrainer(nuwa=_small_nuwa("cuda", seed=2), resume=True, **kw)
    assert resumed.step == 2
    assert first.train_step()["loss"] == resumed.train_step()["loss"]
    for a, b in zip(first.nuwa.parameters(), resumed.nuwa.parameters()):
        assert (a - b).abs().max().item() <= 1e-6
