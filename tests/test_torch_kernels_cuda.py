"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked `cuda` and skips on a machine without
CUDA: the kernels have no CPU mode.  This file imports neither JAX nor
the JAX package, so on the card it runs without the repository's
conftest (which imports JAX):

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: float32 1e-4 (both sides in full f32, TF32 off, sums in
another order); bfloat16 2e-2 (p is rounded to bfloat16 before p·v on
both sides; a rounding that flips on a last-bit difference of the f32
score moves an output by up to ~2^-8 of its scale).  The saved p: 1e-6
in float32, one bfloat16 step below 1, 2^-8, in bfloat16.  Gradients of
`FlashShort` against torch autograd through the plain version, relative
to the largest reference gradient: float32 1e-4; bfloat16 2e-2 (the
backward reads the bfloat16 p and rounds ds to bfloat16, autograd
through the plain version keeps both in float32).  The streaming
kernels (`flash_fwd`, `flash_bwd_dq`, `flash_bwd_dkv`) take the same
tolerances for o and for dq, dk, dv against their plain versions; lse
1e-4 absolute on rows with kv_length > 0 and exactly -1e30 on rows with
kv_length 0.  The BTHD kernels (`flash_short_bthd_fwd`, its training
form, `flash_short_bthd_bwd`) take row 1's tolerances for o and p and
GRAD_RTOL for dq, dk, dv, on q, k, v cut as views from one (B, T, 3E)
buffer, as BERT's fused projection gives them.  The persistent bf16
T = 128, d = 64 kernel is tried at batch-head counts below, around and
far above its grid (one block an SM), with kv_length 0, 1 and T among
the rows, on a side stream twice back to back; its o must also equal
p·v of its own saved p in float32 within o's bfloat16 rounding (2^-8
of |p·v|, plus 1e-5 for the order of the float32 sums).  The persistent
streaming kernels (bf16, d = 64) are tried around their grids, two
launches of each queued back to back on a side stream, and the
backward's (rows 3 and 4) twice on the same inputs, which must give the
same bits.  The bottleneck backward's two kernels (row 8) take their own
tolerances, stated where they are defined below.  Row 6's persistent
kernel (bf16, T = 128, d = 64) is tried below its grid and off a
multiple of it, and rows 8a's and 8b's (ResNet-50 stage 1's two
widths) at a ragged M, fewer row tiles than SMs and one tile a block, each twice on
the same inputs, which must give the same bits.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.models import get_model
from incubator_mxnet_torch.ops.attention import multi_head_attention
from incubator_mxnet_torch.ops.flash_attention import (
    Flash, FlashShort, FlashShortBTHD, _fit_block, flash_attention,
    flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
    flash_bwd_dq_reference, flash_fwd, flash_fwd_reference,
    flash_short_bthd_bwd, flash_short_bthd_bwd_reference,
    flash_short_bthd_fwd, flash_short_bthd_fwd_train,
    flash_short_bthd_reference, flash_short_fwd, flash_short_fwd_train,
    flash_short_reference, launch_counts, reset_launch_counts)

pytestmark = pytest.mark.cuda
NO_LAUNCH = {name: 0 for name in launch_counts}
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
P_ATOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -8}
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["float32", "bfloat16"])


def _qkv(card, shape, dtype, seed, zero_len=True):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for _ in range(3))
    n = shape[1]
    lo = 0 if zero_len else 1
    lengths = torch.randint(lo, n + 1, (shape[0],), generator=gen,
                            device=card, dtype=torch.int32)
    lengths[0] = lo
    if shape[0] > 2:
        lengths[1] = 1
    lengths[-1] = n
    return q, k, v, lengths


# batch-head counts of the persistent kernel (one block an SM, 132 on an
# H100 SXM): one, fewer than the grid, just below and above it, and many
# times it (BERT-base's training and serving batch-heads)
PERSISTENT_BH = [1, 7, 131, 133, 720, 1536]


def _pv_rel_err(o, p, v):
    """max |o − p·v| − 2^-8·|p·v| in float32: > 1e-5 where o is not p·v
    of the saved p within o's bfloat16 rounding."""
    pv = torch.matmul(p.float(), v.float())
    return ((o.float() - pv).abs() - 2 ** -8 * pv.abs()).max().item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(16, 128, 64), (4, 128, 32), (3, 48, 32),
                                   (3, 48, 40),
                                   (2, 7, 8), (2, 256, 256), (2, 512, 256)]
                         + [(bh, 128, 64) for bh in PERSISTENT_BH])
def test_flash_short_fwd_matches_plain_version(card, dtype, causal, shape):
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for _ in range(3))
    n = shape[1]
    lengths = torch.randint(0, n + 1, (shape[0],), generator=gen,
                            device=card, dtype=torch.int32)
    lengths[0] = 0
    if shape[0] > 2:
        lengths[1] = 1
    lengths[-1] = n
    scale = shape[2] ** -0.5
    reset_launch_counts()
    out = flash_short_fwd(q, k, v, lengths, scale, causal)
    torch.cuda.synchronize()
    assert launch_counts["flash_short_fwd"] == 1
    ref = flash_short_reference(q, k, v, lengths, scale, causal)
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype], err
    # kv_length 0: the mean of v
    if lengths[0].item() == 0:
        np.testing.assert_allclose(
            out[0].float().cpu().numpy(),
            v[0].float().mean(0).expand(n, -1).cpu().numpy(),
            atol=ATOL[dtype])


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_nd_array_copies_a_source_on_the_card(card, kind):
    """nd.array of an array already on the card returns storage of its
    own: writing into the result leaves the source alone."""
    x = torch.randn(3, 4, device=card)
    want = x.cpu().numpy()
    src = mx.nd.array(x, ctx=mx.gpu(0)) if kind == "ndarray" else x
    a = mx.nd.array(src, ctx=mx.gpu(0))
    a[:] = 5
    held = src.asnumpy() if kind == "ndarray" else src.cpu().numpy()
    np.testing.assert_array_equal(held, want)
    np.testing.assert_array_equal(a.asnumpy(), np.full_like(want, 5))


def test_misaligned_view_is_handled(card):
    base = torch.randn(1 * 128 * 64 + 3, device=card,
                       dtype=torch.bfloat16)
    q = base[3:].view(1, 128, 64)             # starts 6 bytes in
    lengths = torch.tensor([100], dtype=torch.int32, device=card)
    out = flash_short_fwd(q, q, q, lengths, 0.125)
    ref = flash_short_reference(q, q, q, lengths, 0.125, False)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_routes_cuda_through_the_kernel(card, causal,
                                                             monkeypatch):
    gen = torch.Generator(device=card).manual_seed(1)
    x = [torch.randn(4, 128, 256, generator=gen, device=card)
         .to(torch.bfloat16) for _ in range(3)]
    valid = torch.tensor([128, 3, 0, 77], device=card)
    reset_launch_counts()
    out = multi_head_attention(*x, None, valid, num_heads=4, causal=causal)
    assert launch_counts["flash_short_fwd"] == 1
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "0")
    ref = multi_head_attention(*x, None, valid, num_heads=4, causal=causal)
    assert launch_counts["flash_short_fwd"] == 1
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_bert_forward_with_kernel_matches_plain_attention(card, monkeypatch):
    mx.seed(0)
    net = get_model("bert_classifier", model_name="bert_mini",
                    num_classes=2, dropout=0.0, vocab_size=1000,
                    max_length=128)
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    rng = np.random.RandomState(0)
    ins = [torch.from_numpy(rng.randint(0, 1000, (8, 128))).to(card),
           torch.from_numpy(rng.randint(0, 2, (8, 128))).to(card),
           torch.tensor([128, 0, 1, 64, 100, 5, 128, 17], device=card)]
    reset_launch_counts()
    with torch.inference_mode():
        out = net(*ins)
        assert launch_counts["flash_short_fwd"] == 4       # 4 layers
        monkeypatch.setenv("MXNET_FLASH_ATTENTION", "0")
        ref = net(*ins)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(16, 128, 64), (3, 48, 40), (2, 7, 8),
                                   (2, 256, 256)]
                         + [(bh, 128, 64) for bh in PERSISTENT_BH])
def test_training_form_matches_plain_version(card, dtype, causal, shape):
    """Row 1b: o and the saved p of `flash_short_fwd_train`, the
    training shape (BH = 60*12, T = 128, d = 64) among others; o is p·v
    of the saved p."""
    q, k, v, lengths = _qkv(card, shape, dtype, sum(shape) + 1)
    scale = shape[2] ** -0.5
    reset_launch_counts()
    o, p = flash_short_fwd_train(q, k, v, lengths, scale, causal)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_fwd_train=1)
    ro, rp = flash_short_reference(q, k, v, lengths, scale, causal,
                                   save_p=True)
    assert o.dtype == p.dtype == dtype and p.shape == (shape[0], shape[1],
                                                      shape[1])
    assert (o.float() - ro.float()).abs().max().item() <= ATOL[dtype]
    assert (p.float() - rp.float()).abs().max().item() <= P_ATOL[dtype]
    if dtype == torch.bfloat16:
        assert _pv_rel_err(o, p, v) <= 1e-5
    # the inference form gives the same o
    assert torch.equal(flash_short_fwd(q, k, v, lengths, scale, causal), o)


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(720, 128, 64), (6, 48, 40)])
def test_flash_short_grads_match_autograd_through_plain(card, dtype, causal,
                                                        shape):
    """dq, dk, dv of `FlashShort` (kernel forward, `_bwd_short` in torch)
    against torch autograd through the plain version, every kv_length
    > 0 (a fully masked row's JAX gradient is not the plain version's;
    the CPU tests hold that case against the JAX package)."""
    q, k, v, lengths = _qkv(card, shape, dtype, 7 + sum(shape),
                            zero_len=False)
    do = torch.randn(shape, device=card).to(dtype)
    scale = shape[2] ** -0.5
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    FlashShort.apply(*a, lengths, scale, causal).backward(do)
    flash_short_reference(*b, lengths, scale, causal).backward(do)
    torch.cuda.synchronize()
    assert launch_counts["flash_short_fwd_train"] == 1
    for name, x, y in zip("qkv", a, b):
        assert x.grad.dtype == dtype
        err = (x.grad.float() - y.grad.float()).abs().max().item()
        ref = y.grad.float().abs().max().item()
        assert err <= GRAD_RTOL[dtype] * ref, (name, err, ref)


def test_launch_counters_follow_grad_mode(card):
    q, k, v, _ = _qkv(card, (2, 3, 128, 64), torch.bfloat16, 11)
    q.requires_grad_()
    reset_launch_counts()
    with torch.no_grad():
        flash_attention(q, k, v)
    assert launch_counts == dict(NO_LAUNCH, flash_short_fwd=1)
    flash_attention(q, k, v).float().sum().backward()
    assert launch_counts == dict(NO_LAUNCH, flash_short_fwd=1,
                                 flash_short_fwd_train=1)
    assert q.grad is not None and q.grad.dtype == torch.bfloat16


def test_bert_train_step_runs_the_training_kernel(card):
    """ParallelTrainer steps of a 4-layer BERT in bf16: one training
    launch per layer and step, no inference launch, finite losses.  (The
    first step also runs one forward outside autograd to give the
    classifier's deferred Dense its shape, as the JAX package's abstract
    warm-up does; that forward takes the inference form.)"""
    mx.seed(0)
    net = get_model("bert_classifier", model_name="bert_mini",
                    num_classes=2, dropout=0.0, vocab_size=1000,
                    max_length=128)
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    net.cast("bfloat16")
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = mx.parallel.ParallelTrainer(
        net, lambda o, y: loss(o.astype("float32"), y), "adam",
        {"learning_rate": 2e-5})
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, 1000, (8, 128)).astype(np.float32),
             np.zeros((8, 128), np.float32),
             rng.randint(0, 2, 8).astype(np.float32))
    reset_launch_counts()
    first = tr.step(*batch).asscalar()
    assert launch_counts == dict(NO_LAUNCH, flash_short_fwd=4,
                                 flash_short_fwd_train=4)
    reset_launch_counts()
    out = tr.run_steps(2, *batch).asscalar()
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_fwd_train=8)
    assert np.isfinite(first) and np.isfinite(out)


# (BH, Tq, Tk, d, block_q, block_k): the training shape, the TPU
# kernels' small blocks, cross attention, a length only a smaller JAX
# block divides, a length that ends inside the kernels' own tiles, JAX
# blocks of 128 and 384 whose tiles the kernels' 192-row (forward) and
# 128-row or 128-key (backward) tiles cross, and widths off the
# tensor-core path (the FMA kernels)
STREAM_SHAPES = [(48, 2048, 2048, 64, 512, 1024), (3, 256, 256, 64, 128, 128),
                 (4, 1024, 2048, 64, 512, 1024),
                 (2, 1152, 1152, 64, _fit_block(512, 1152),
                  _fit_block(1024, 1152)),
                 (3, 100, 100, 64, 100, 100),
                 (2, 384, 384, 64, 128, 384), (2, 384, 384, 64, 384, 128),
                 (3, 48, 80, 40, 48, 80), (2, 256, 384, 256, 128, 128)]
# the persistent grids (one block an SM, 132 on an H100 SXM): the
# forward's work tiles of 192 query rows (11 a batch-head at T = 2048,
# walked in groups of 132 // 11 = 12 batch-heads) and the backward's of
# 128 query rows or 128 keys (16 a batch-head, in groups of 8): one
# batch-head (fewer tiles than blocks), 131 and 133 (a last group of part
# of its batch-heads, a last round that fills part of the grid),
# BERT-base's serving batch-heads at T = 2048, and lengths of one row or
# key
GRID_SHAPES = STREAM_SHAPES + [
    (bh, 2048, 2048, 64, 512, 1024) for bh in (1, 131, 133, 192)] + [
    (3, 1, 1, 64, 1, 1), (2, 64, 200, 64, 64, 200)]
GRID_IDS = [f"{s[0]}x{s[1]}x{s[2]}x{s[3]}-{s[4]}x{s[5]}"
            for s in GRID_SHAPES]


def _stream_inputs(card, shape, dtype, seed, zero_len=True):
    bh, tq, tk, d, _, _ = shape
    gen = torch.Generator(device=card).manual_seed(seed)
    q, do = (torch.randn(bh, tq, d, generator=gen, device=card).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, tk, d, generator=gen, device=card).to(dtype)
            for _ in range(2))
    lo = 0 if zero_len else 1
    lengths = torch.randint(lo, tk + 1, (bh,), generator=gen, device=card,
                            dtype=torch.int32)
    lengths[0] = lo
    lengths[-1] = tk
    return q, k, v, do, lengths


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", GRID_SHAPES, ids=GRID_IDS)
def test_flash_fwd_matches_plain_version(card, dtype, causal, shape):
    """Kernel row 2: o and lse; a row with kv_length 0 gets lse -1e30."""
    q, k, v, _, lengths = _stream_inputs(card, shape, dtype, sum(shape))
    scale = shape[3] ** -0.5
    blocks = shape[4:]
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v, lengths, scale, causal, *blocks)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_fwd=1)
    ro, rlse = flash_fwd_reference(q, k, v, lengths, scale, causal, *blocks)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2] + (1,)
    assert (o.float() - ro.float()).abs().max().item() <= ATOL[dtype]
    live = lengths > 0
    assert (lse[live] - rlse[live]).abs().max().item() <= 1e-4
    assert torch.all(lse[~live] == -1e30)
    assert torch.isfinite(o.float()).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blocks", [(512, 1024), (128, 128)])
def test_flash_fwd_lengths_at_key_step_edges(card, causal, blocks):
    """Row 2 in bf16 with kv_length 0, 1, 127, 128, 129 and T: the key
    step that holds the length, the steps the kernel masks and the ones
    it does not; lse exactly -1e30 where kv_length is 0."""
    T = 1024
    q, k, v, _, _ = _stream_inputs(card, (12, T, T, 64, *blocks),
                                   torch.bfloat16, 21)
    lengths = torch.tensor([0, 1, 127, 128, 129, T] * 2, dtype=torch.int32,
                           device=card)
    o, lse = flash_fwd(q, k, v, lengths, 0.125, causal, *blocks)
    ro, rlse = flash_fwd_reference(q, k, v, lengths, 0.125, causal, *blocks)
    torch.cuda.synchronize()
    assert (o.float() - ro.float()).abs().max().item() <= ATOL[torch.bfloat16]
    live = lengths > 0
    assert (lse[live] - rlse[live]).abs().max().item() <= 1e-4
    assert torch.all(lse[~live] == -1e30)
    assert torch.isfinite(o.float()).all()


def test_flash_fwd_back_to_back_on_a_side_stream(card):
    """Two row-2 launches with different inputs, one causal, queued back
    to back on a stream other than the default one, each against its
    plain version: a stage, a q buffer, an o box or a tensor map of the
    first launch still in use would spoil the second."""
    shape = (48, 2048, 2048, 64, 512, 1024)
    ins = [_stream_inputs(card, shape, torch.bfloat16, seed)[:3]
           + (_stream_inputs(card, shape, torch.bfloat16, seed)[4],)
           for seed in (31, 32)]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        outs = [flash_fwd(*x, 0.125, causal, 512, 1024)
                for x, causal in zip(ins, (False, True))]
    torch.cuda.synchronize()
    for x, causal, (o, lse) in zip(ins, (False, True), outs):
        ro, rlse = flash_fwd_reference(*x, 0.125, causal, 512, 1024)
        live = x[3] > 0
        assert (o.float() - ro.float()).abs().max().item() \
            <= ATOL[torch.bfloat16]
        assert (lse[live] - rlse[live]).abs().max().item() <= 1e-4
        assert torch.all(lse[~live] == -1e30)


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", GRID_SHAPES, ids=GRID_IDS)
def test_flash_bwd_matches_plain_versions(card, dtype, causal, shape):
    """Kernel rows 3 and 4 from the plain forward's o and lse, kv_length
    0 included: dq, dk, dv within GRAD_RTOL of the largest reference."""
    q, k, v, do, lengths = _stream_inputs(card, shape, dtype,
                                          3 + sum(shape))
    scale = shape[3] ** -0.5
    blocks = shape[4:]
    o, lse = flash_fwd_reference(q, k, v, lengths, scale, causal, *blocks)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta, lengths, scale, causal, *blocks)
    reset_launch_counts()
    got = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_bwd_dq=1, flash_bwd_dkv=1)
    ref = (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))
    # with one key a row (Tq = Tk = 1) p is 1, dp equals delta, and dq
    # and dk cancel to exactly 0: there they are held to the scale of the
    # terms that cancel, the plain versions' gradients with delta = 0
    no_delta = args[:5] + (torch.zeros_like(delta),) + args[6:]
    terms = (flash_bwd_dq_reference(*no_delta),
             *flash_bwd_dkv_reference(*no_delta))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, terms):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item() or c.float().abs().max().item()
        assert err <= GRAD_RTOL[dtype] * top, (name, err, top)


def _bwd_args(card, shape, seed, causal):
    """The backward kernels' arguments on seeded bf16 inputs, kv_length 0
    and T among the rows, from the plain forward's o and lse."""
    q, k, v, do, lengths = _stream_inputs(card, shape, torch.bfloat16, seed)
    o, lse = flash_fwd_reference(q, k, v, lengths, 0.125, causal,
                                 *shape[4:])
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta, lengths, 0.125, causal, *shape[4:])


def _assert_bwd_matches_plain(args, got):
    ref = (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item()
        assert err <= GRAD_RTOL[torch.bfloat16] * top, (name, err, top)


def test_flash_bwd_back_to_back_on_a_side_stream(card):
    """Rows 3 and 4 on two inputs, one causal, queued back to back on a
    stream other than the default one, each against its plain versions:
    a stage, a k/v or q/do buffer, a gradient box or a tensor map of one
    launch still in use would spoil the next."""
    shape = (48, 2048, 2048, 64, 512, 1024)
    args = [_bwd_args(card, shape, seed, causal)
            for seed, causal in ((33, False), (34, True))]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        outs = [(flash_bwd_dq(*a), *flash_bwd_dkv(*a)) for a in args]
    torch.cuda.synchronize()
    for a, got in zip(args, outs):
        _assert_bwd_matches_plain(a, got)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_repeats_bit_for_bit(card, causal):
    """Each block owns its output rows and sums in a fixed order, so two
    launches on the same inputs give the same dq, dk and dv to the bit."""
    args = _bwd_args(card, (48, 2048, 2048, 64, 512, 1024), 35, causal)
    first = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    second = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name
    _assert_bwd_matches_plain(args, first)


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_autograd_through_plain(card, dtype, causal):
    """`Flash` (kernel forward, delta, both backward kernels) against
    torch autograd through `flash_fwd_reference`, every kv_length > 0."""
    shape = (6, 512, 1024, 64, 256, 512)
    q, k, v, do, lengths = _stream_inputs(card, shape, dtype, 5,
                                          zero_len=False)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    Flash.apply(*a, lengths, 0.125, causal, 256, 512).backward(do)
    flash_fwd_reference(*b, lengths, 0.125, causal, 256, 512)[0].backward(do)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_fwd=1, flash_bwd_dq=1,
                                 flash_bwd_dkv=1)
    for name, x, y in zip("qkv", a, b):
        assert x.grad.dtype == dtype
        err = (x.grad.float() - y.grad.float()).abs().max().item()
        ref = y.grad.float().abs().max().item()
        assert err <= GRAD_RTOL[dtype] * ref, (name, err, ref)


def test_short_kill_switch_launches_the_streaming_kernel(card, monkeypatch):
    """MXNET_FLASH_ATTENTION_SHORT=0 at T=128 takes the streaming kernel
    (one 128-row block), as in the JAX package."""
    q, k, v, _ = _qkv(card, (2, 3, 128, 64), torch.bfloat16, 13)
    ref = flash_attention(q, k, v)
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_SHORT", "0")
    reset_launch_counts()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_fwd=1)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_long_takes_the_streaming_kernel(card, causal,
                                                              monkeypatch):
    gen = torch.Generator(device=card).manual_seed(2)
    x = [torch.randn(2, 1024, 256, generator=gen, device=card)
         .to(torch.bfloat16) for _ in range(3)]
    valid = torch.tensor([1024, 0], device=card)
    reset_launch_counts()
    out = multi_head_attention(*x, None, valid, num_heads=4, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_fwd=1)
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "0")
    ref = multi_head_attention(*x, None, valid, num_heads=4, causal=causal)
    assert launch_counts == dict(NO_LAUNCH, flash_fwd=1)
    # the padded row: Tk = 1024 is one JAX key tile, which every row
    # visits, so the kernel averages every key as einsum attention does
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_bert_long_train_step_runs_the_streaming_kernels(card):
    """ParallelTrainer steps of a 4-layer BERT in bf16 at T=1024: one
    launch of each streaming kernel per layer and step, finite losses."""
    mx.seed(0)
    net = get_model("bert_classifier", model_name="bert_mini",
                    num_classes=2, dropout=0.0, vocab_size=1000,
                    max_length=1024)
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    net.cast("bfloat16")
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = mx.parallel.ParallelTrainer(
        net, lambda o, y: loss(o.astype("float32"), y), "adam",
        {"learning_rate": 2e-5})
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, 1000, (2, 1024)).astype(np.float32),
             np.zeros((2, 1024), np.float32),
             rng.randint(0, 2, 2).astype(np.float32))
    tr.step(*batch)
    reset_launch_counts()
    out = tr.run_steps(2, *batch).asscalar()
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_fwd=8, flash_bwd_dq=8,
                                 flash_bwd_dkv=8)
    assert np.isfinite(out)


# ---------------------------------------------------------------------
# the BTHD layout (rows 5 and 6)
# ---------------------------------------------------------------------
# (B, T, H, d): the training shape, the kernels' tensor-core shape at a
# small batch, and shapes off it (other T, d, ragged T, T = 512)
BTHD_SHAPES = [(60, 128, 12, 64), (2, 128, 4, 64), (3, 48, 2, 32),
               (2, 256, 3, 64), (2, 7, 3, 8), (1, 512, 2, 256)]
BTHD_IDS = ["x".join(map(str, s)) for s in BTHD_SHAPES]
# the forward also at the serving batch and around the persistent grid,
# with H = 12 and H = 1
BTHD_FWD_SHAPES = BTHD_SHAPES + [(128, 128, 12, 64), (11, 128, 12, 64),
                                 (1, 128, 1, 64), (133, 128, 1, 64)]
BTHD_FWD_IDS = ["x".join(map(str, s)) for s in BTHD_FWD_SHAPES]


def _bthd_inputs(card, shape, dtype, seed, zero_len=True, offset=0):
    """q, k, v as (B, T, H, d) views of one (B, T, 3E) buffer (starting
    `offset` elements into its storage), do, and lengths (B,) int32 with
    0 (or 1) and T among them."""
    B, T, H, d = shape
    E = H * d
    gen = torch.Generator(device=card).manual_seed(seed)
    flat = torch.randn(offset + B * T * 3 * E, generator=gen, device=card)
    buf = flat.to(dtype)[offset:].view(B, T, 3 * E)
    q, k, v = (buf[..., i * E:(i + 1) * E].reshape(B, T, H, d)
               for i in range(3))
    do = torch.randn(shape, generator=gen, device=card).to(dtype)
    lo = 0 if zero_len else 1
    lengths = torch.randint(lo, T + 1, (B,), generator=gen, device=card,
                            dtype=torch.int32)
    lengths[0] = lo
    if B > 2:
        lengths[1] = 1
    lengths[-1] = T
    return q, k, v, do, lengths


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BTHD_FWD_SHAPES, ids=BTHD_FWD_IDS)
def test_bthd_fwd_matches_plain_version(card, dtype, causal, shape):
    """Row 5 in both forms on strided views: o (B, T, H, d) and p (B, H,
    T, T); a batch element with kv_length 0 is the mean of v; o is p·v
    of the saved p."""
    q, k, v, _, lengths = _bthd_inputs(card, shape, dtype, sum(shape))
    scale = shape[3] ** -0.5
    reset_launch_counts()
    o = flash_short_bthd_fwd(q, k, v, lengths, scale, causal)
    ot, p = flash_short_bthd_fwd_train(q, k, v, lengths, scale, causal)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_bthd_fwd=1,
                                 flash_short_bthd_fwd_train=1)
    ro, rp = flash_short_bthd_reference(q, k, v, lengths, scale, causal,
                                        save_p=True)
    assert o.shape == q.shape and o.is_contiguous() and o.dtype == dtype
    assert p.shape == (shape[0], shape[2], shape[1], shape[1])
    assert (o.float() - ro.float()).abs().max().item() <= ATOL[dtype]
    assert (p.float() - rp.float()).abs().max().item() <= P_ATOL[dtype]
    assert torch.equal(o, ot)
    if lengths[0].item() == 0:
        mean_v = v[0].float().mean(0, keepdim=True).expand_as(o[0])
        assert (o[0].float() - mean_v).abs().max().item() <= ATOL[dtype]
    if dtype == torch.bfloat16:
        assert _pv_rel_err(o.transpose(1, 2), p, v.transpose(1, 2)) <= 1e-5


@pytest.mark.parametrize("bthd", [False, True], ids=["bhtd", "bthd"])
@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_short_fwd_back_to_back_on_a_side_stream(card, bthd, train):
    """Two launches with different inputs queued back to back on a
    stream other than the default one, each against its plain version:
    a stage, an output box or a tensor map of the first launch still in
    use would spoil the second."""
    if bthd:
        fwd = flash_short_bthd_fwd_train if train else flash_short_bthd_fwd
        ref = flash_short_bthd_reference
        ins = [(q, k, v, lengths) for q, k, v, _, lengths in (
            _bthd_inputs(card, (128, 128, 12, 64), torch.bfloat16, seed)
            for seed in (11, 12))]
    else:
        fwd = flash_short_fwd_train if train else flash_short_fwd
        ref = flash_short_reference
        ins = [_qkv(card, (1536, 128, 64), torch.bfloat16, seed)
               for seed in (11, 12)]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        outs = [fwd(*x, 0.125, causal) for x, causal in zip(ins,
                                                            (False, True))]
    torch.cuda.synchronize()
    for x, causal, got in zip(ins, (False, True), outs):
        want = ref(*x, 0.125, causal, save_p=train)
        if train:
            assert (got[0].float() - want[0].float()).abs().max().item() \
                <= ATOL[torch.bfloat16]
            assert (got[1].float() - want[1].float()).abs().max().item() \
                <= P_ATOL[torch.bfloat16]
        else:
            assert (got.float() - want.float()).abs().max().item() \
                <= ATOL[torch.bfloat16]


@pytest.mark.parametrize("train", [False, True])
def test_bthd_misaligned_view_is_copied_once(card, train):
    """A buffer that starts 6 bytes into its storage: the wrapper reads
    one aligned copy and gives the plain version's answer."""
    shape = (2, 128, 4, 64)
    q, k, v, do, lengths = _bthd_inputs(card, shape, torch.bfloat16, 3,
                                        offset=3)
    assert q.data_ptr() % 16 != 0
    if train:
        ro, rp = flash_short_bthd_reference(q, k, v, lengths, 0.125, False,
                                            save_p=True)
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2)
        got = flash_short_bthd_bwd(q, k, v, do, delta.contiguous(), rp, 0.125)
        ref = flash_short_bthd_bwd_reference(q, k, v, do, delta, rp, 0.125)
    else:
        got = [flash_short_bthd_fwd(q, k, v, lengths, 0.125)]
        ref = [flash_short_bthd_reference(q, k, v, lengths, 0.125, False)]
    for a, b in zip(got, ref):
        top = max(b.float().abs().max().item(), 1.0)
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * top


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BTHD_SHAPES, ids=BTHD_IDS)
def test_bthd_bwd_matches_plain_version(card, dtype, causal, shape):
    """Row 6 from the plain forward's o and p, kv_length 0 included: dq,
    dk, dv within GRAD_RTOL of the largest reference."""
    q, k, v, do, lengths = _bthd_inputs(card, shape, dtype, 5 + sum(shape))
    scale = shape[3] ** -0.5
    o, p = flash_short_bthd_reference(q, k, v, lengths, scale, causal,
                                      save_p=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    reset_launch_counts()
    got = flash_short_bthd_bwd(q, k, v, do, delta, p, scale)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_bthd_bwd=1)
    ref = flash_short_bthd_bwd_reference(q, k, v, do, delta, p, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == q.shape and \
            a.is_contiguous(), name
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item()
        assert err <= GRAD_RTOL[dtype] * top, (name, err, top)


@DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(60, 128, 12, 64), (3, 48, 2, 40)],
                         ids=["60x128x12x64", "3x48x2x40"])
def test_flash_short_bthd_grads_match_autograd_through_plain(
        card, dtype, causal, shape):
    """`FlashShortBTHD` (row 5's training form, delta, row 6) against
    torch autograd through the plain forward, every kv_length > 0,
    gradients taken into the shared (B, T, 3E) buffer."""
    q, k, v, do, lengths = _bthd_inputs(card, shape, dtype, 9 + sum(shape),
                                        zero_len=False)
    E = shape[2] * shape[3]
    base = torch.cat([t.reshape(shape[0], shape[1], E) for t in (q, k, v)],
                     -1)
    grads = []
    reset_launch_counts()
    for fn in (FlashShortBTHD.apply, flash_short_bthd_reference):
        buf = base.clone().requires_grad_()
        views = [buf[..., i * E:(i + 1) * E].reshape(shape) for i in range(3)]
        fn(*views, lengths, 0.125, causal).backward(do)
        grads.append(buf.grad)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_bthd_fwd_train=1,
                                 flash_short_bthd_bwd=1)
    err = (grads[0].float() - grads[1].float()).abs().max().item()
    top = grads[1].float().abs().max().item()
    assert grads[0].dtype == dtype and err <= GRAD_RTOL[dtype] * top


# the persistent row-6 kernel (bf16, T = 128, d = 64) at batch-heads
# below its grid (B = 1) and not a multiple of it (B = 61)
BTHD_BWD_TMA_SHAPES = [(1, 128, 12, 64), (61, 128, 12, 64)]
BTHD_BWD_TMA_IDS = ["x".join(map(str, s)) for s in BTHD_BWD_TMA_SHAPES]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BTHD_BWD_TMA_SHAPES, ids=BTHD_BWD_TMA_IDS)
def test_bthd_bwd_tma_matches_plain_and_repeats(card, causal, shape):
    """Row 6's persistent kernel on views of a (B, T, 3E) buffer, with
    kv_length 0 among the rows, from the plain forward's o and p: dq, dk,
    dv within GRAD_RTOL of the largest reference, one launch a call, and
    the same bits from a second launch on the same inputs."""
    q, k, v, do, lengths = _bthd_inputs(card, shape, torch.bfloat16,
                                        11 + shape[0])
    scale = shape[3] ** -0.5
    o, p = flash_short_bthd_reference(q, k, v, lengths, scale, causal,
                                      save_p=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    reset_launch_counts()
    got = flash_short_bthd_bwd(q, k, v, do, delta, p, scale)
    again = flash_short_bthd_bwd(q, k, v, do, delta, p, scale)
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_bthd_bwd=2)
    ref = flash_short_bthd_bwd_reference(q, k, v, do, delta, p, scale)
    for name, a, b, a2 in zip(("dq", "dk", "dv"), got, ref, again):
        assert torch.equal(a, a2), name
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item()
        assert err <= GRAD_RTOL[torch.bfloat16] * top, (name, err, top)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_short_bthd_kv_length_zero_follows_the_jax_rule(card, causal):
    """`FlashShortBTHD` on a batch whose kv_length-0 elements have p = 1/T:
    their gradients (into k too) are the plain backward's on the plain
    forward's o and p, within GRAD_RTOL of its largest value."""
    shape = (61, 128, 12, 64)
    q, k, v, do, lengths = _bthd_inputs(card, shape, torch.bfloat16, 23)
    lengths[::7] = 0
    B, T, H, d = shape
    E = H * d
    base = torch.cat([t.reshape(B, T, E) for t in (q, k, v)], -1)
    buf = base.clone().requires_grad_()
    views = [buf[..., i * E:(i + 1) * E].reshape(shape) for i in range(3)]
    FlashShortBTHD.apply(*views, lengths, 0.125, causal).backward(do)
    o, p = flash_short_bthd_reference(q, k, v, lengths, 0.125, causal,
                                      save_p=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    ref = flash_short_bthd_bwd_reference(q, k, v, do, delta, p, 0.125)
    rule = torch.cat([g.reshape(B, T, E) for g in ref], -1)
    dead = lengths == 0
    assert dead.sum().item() > 1
    err = (buf.grad[dead].float() - rule[dead].float()).abs().max().item()
    top = rule[dead].float().abs().max().item()
    assert top > 0 and err <= GRAD_RTOL[torch.bfloat16] * top, (err, top)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_bthd_route_reads_views_in_place(
        card, causal, monkeypatch):
    """With MXNET_FLASH_ATTENTION_BTHD=1 `multi_head_attention` launches
    row 5 on the q, k, v column slices of one (N, T, 3E) buffer and no
    other CUDA kernel: no copy of q, k or v, no transpose of the output."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn(4, 128, 3 * 256, generator=gen, device=card) \
        .to(torch.bfloat16)
    x = [qkv[..., i * 256:(i + 1) * 256] for i in range(3)]
    valid = torch.tensor([128, 3, 0, 77], device=card, dtype=torch.int32)
    ref = multi_head_attention(*x, None, valid, num_heads=4, causal=causal)
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_BTHD", "1")
    reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = multi_head_attention(*x, None, valid, num_heads=4,
                                   causal=causal)
        torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_bthd_fwd=1)
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "short_fwd" in kernels[0], kernels
    assert out.shape == (4, 128, 256)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_bert_train_step_runs_the_bthd_kernels(card, monkeypatch):
    """ParallelTrainer steps of BERT-base (12 layers) in bf16 on the BTHD
    route: 12 launches of each BTHD training kernel per step, no other
    kernel, finite losses."""
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_BTHD", "1")
    mx.seed(0)
    net = get_model("bert_classifier", model_name="bert_12_768_12",
                    num_classes=2, dropout=0.0, vocab_size=1000,
                    max_length=128)
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    net.cast("bfloat16")
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = mx.parallel.ParallelTrainer(
        net, lambda o, y: loss(o.astype("float32"), y), "adam",
        {"learning_rate": 2e-5})
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, 1000, (8, 128)).astype(np.float32),
             np.zeros((8, 128), np.float32),
             rng.randint(0, 2, 8).astype(np.float32))
    tr.step(*batch)
    reset_launch_counts()
    out = tr.run_steps(2, *batch).asscalar()
    torch.cuda.synchronize()
    assert launch_counts == dict(NO_LAUNCH, flash_short_bthd_fwd_train=24,
                                 flash_short_bthd_bwd=24)
    assert np.isfinite(out)


# ---------------------------------------------------------------------
# row 8: the bottleneck backward (`tools/bottleneck_bwd.py`)
# ---------------------------------------------------------------------
# Kernels against their plain versions, mean relative error |a − b| /
# |a| (the JAX tool's measure): 1e-3.  z, dx and dW are f32 sums of the
# same bf16 products in another order; dz and dx are rounded to bf16, and
# a rounding that flips on a last-bit difference moves one element by
# one bf16 step (2^-8 of it).  Against torch autograd of `bn_dot`: the JAX
# test's 2e-2 (dz is rounded to bf16 before dx and dW).
BNB_RTOL = 1e-3
BNB_VJP_RTOL = 2e-2
BNB_SHAPES = [(4096, 64, 256), (4096, 256, 64), (2048, 128, 512),
              (2048, 512, 128), (1000, 256, 1024), (1000, 1024, 256),
              (300, 512, 2048), (300, 2048, 512), (12544, 512, 2048),
              (100, 48, 80)]


def _rel(ref, got):
    ref, got = ref.float(), got.float()
    return ((ref - got).abs().mean() / (ref.abs().mean() + 1e-9)).item()


def _bnb_inputs(card, M, C, K, seed=0):
    from incubator_mxnet_torch.tools.bottleneck_bwd import bn_dot
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(M, C, generator=gen, device=card).to(torch.bfloat16)
    w = (torch.randn(C, K, generator=gen, device=card) * 0.1).to(
        torch.bfloat16)
    gamma = torch.rand(K, generator=gen, device=card) + 0.5
    beta = torch.zeros(K, device=card)
    dy = torch.randn(M, K, generator=gen, device=card).to(torch.bfloat16)
    _, (_z, m, inv) = bn_dot(x, w, gamma, beta)
    return x, w, gamma, beta, dy, m, inv


@pytest.mark.parametrize("shape", BNB_SHAPES,
                         ids=["x".join(map(str, s)) for s in BNB_SHAPES])
def test_bottleneck_kernels_match_plain_versions(card, shape):
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    x, w, gamma, _beta, dy, m, inv = _bnb_inputs(card, *shape)
    bnb.reset_launch_counts()
    s = bnb.bottleneck_bwd_reduce(dy, x, w, m, inv)
    rs = bnb.bottleneck_reduce_reference(dy, x, w, m, inv)
    d = bnb.bottleneck_bwd_apply(dy, x, w, m, inv, gamma, *rs)
    rd = bnb.bottleneck_apply_reference(dy, x, w, m, inv, gamma, *rs)
    torch.cuda.synchronize()
    assert bnb.launch_counts == {"bottleneck_bwd_reduce": 1,
                                 "bottleneck_bwd_apply": 1}
    for name, a, b in zip(("s1", "s2", "dx", "dw"), (*rs, *rd), (*s, *d)):
        assert torch.isfinite(b).all(), name
        assert _rel(a, b) <= BNB_RTOL, (name, _rel(a, b))


@pytest.mark.parametrize("shape", [(4096, 64, 256), (12544, 512, 2048),
                                   (777, 64, 256)])
def test_bottleneck_bwd_matches_autograd_of_bn_dot(card, shape):
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    x, w, gamma, beta, dy, m, inv = _bnb_inputs(card, *shape, seed=1)
    leaves = [t.clone().requires_grad_() for t in (x, w, gamma, beta)]
    ref = torch.autograd.grad(bnb.bn_dot(*leaves)[0], leaves, dy)
    got = bnb.bottleneck_bwd(dy, x, w, m, inv, gamma)
    for name, a, b in zip(("dx", "dw", "dgamma", "dbeta"), ref, got):
        assert _rel(a, b) <= BNB_VJP_RTOL, (name, _rel(a, b))


def test_conv1x1bn_grads_match_autograd(card):
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    x, w, gamma, beta, *_ = _bnb_inputs(card, 4096, 64, 256, seed=2)
    grads = []
    for fn in (bnb.Conv1x1BN.apply, lambda *a: bnb.bn_dot(*a)[0]):
        leaves = [t.clone().requires_grad_() for t in (x, w, gamma, beta)]
        loss = fn(*leaves).float().square().sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(grads[1], grads[0]):
        assert _rel(a, b) <= BNB_VJP_RTOL


def _bnb_apply_cases(card):
    """Row counts of the persistent kernels: ragged, fewer row tiles than
    SMs, and exactly one 64-row tile a block."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    return {"ragged": 4096 + 37, "few_tiles": 100, "one_tile_a_block":
            64 * sms}


@pytest.mark.parametrize("case", ["ragged", "few_tiles", "one_tile_a_block"])
@pytest.mark.parametrize("cin,cout", [(64, 256), (256, 64)],
                         ids=["64x256", "256x64"])
def test_bottleneck_apply_tma_matches_and_repeats(card, case, cin, cout):
    """The persistent apply kernel at both ResNet-50 stage-1 widths:
    dx and dW against the plain version within BNB_RTOL, the pair against
    autograd of `bn_dot` within BNB_VJP_RTOL, one launch a call, and the
    same bits from a second launch on the same inputs."""
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    M = _bnb_apply_cases(card)[case]
    x, w, gamma, beta, dy, m, inv = _bnb_inputs(card, M, cin, cout, seed=3)
    s1, s2 = bnb.bottleneck_reduce_reference(dy, x, w, m, inv)
    bnb.reset_launch_counts()
    got = bnb.bottleneck_bwd_apply(dy, x, w, m, inv, gamma, s1, s2)
    again = bnb.bottleneck_bwd_apply(dy, x, w, m, inv, gamma, s1, s2)
    torch.cuda.synchronize()
    assert bnb.launch_counts == {"bottleneck_bwd_reduce": 0,
                                 "bottleneck_bwd_apply": 2}
    ref = bnb.bottleneck_apply_reference(dy, x, w, m, inv, gamma, s1, s2)
    for name, a, b, a2 in zip(("dx", "dw"), ref, got, again):
        assert torch.equal(b, a2), name
        assert torch.isfinite(b).all(), name
        assert _rel(a, b) <= BNB_RTOL, (name, _rel(a, b))
    leaves = [t.clone().requires_grad_() for t in (x, w, gamma, beta)]
    want = torch.autograd.grad(bnb.bn_dot(*leaves)[0], leaves, dy)
    pair = bnb.bottleneck_bwd(dy, x, w, m, inv, gamma)
    for name, a, b in zip(("dx", "dw", "dgamma", "dbeta"), want, pair):
        assert _rel(a, b) <= BNB_VJP_RTOL, (name, _rel(a, b))


@pytest.mark.parametrize("case", ["ragged", "few_tiles", "one_tile_a_block"])
@pytest.mark.parametrize("cin,cout", [(64, 256), (256, 64)],
                         ids=["64x256", "256x64"])
def test_bottleneck_reduce_tma_matches_and_repeats(card, case, cin, cout):
    """The persistent reduce kernel at both ResNet-50 stage-1 widths: s1
    and s2 against the plain version within BNB_RTOL, one launch a call,
    the same bits from a second launch on the same inputs, and the pair
    (reduce, then apply) against autograd of `bn_dot` within
    BNB_VJP_RTOL."""
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    M = _bnb_apply_cases(card)[case]
    x, w, gamma, beta, dy, m, inv = _bnb_inputs(card, M, cin, cout, seed=4)
    bnb.reset_launch_counts()
    got = bnb.bottleneck_bwd_reduce(dy, x, w, m, inv)
    again = bnb.bottleneck_bwd_reduce(dy, x, w, m, inv)
    torch.cuda.synchronize()
    assert bnb.launch_counts == {"bottleneck_bwd_reduce": 2,
                                 "bottleneck_bwd_apply": 0}
    ref = bnb.bottleneck_reduce_reference(dy, x, w, m, inv)
    for name, a, b, a2 in zip(("s1", "s2"), ref, got, again):
        assert torch.equal(b, a2), name
        assert torch.isfinite(b).all(), name
        assert _rel(a, b) <= BNB_RTOL, (name, _rel(a, b))
    leaves = [t.clone().requires_grad_() for t in (x, w, gamma, beta)]
    want = torch.autograd.grad(bnb.bn_dot(*leaves)[0], leaves, dy)
    pair = bnb.bottleneck_bwd(dy, x, w, m, inv, gamma)
    for name, a, b in zip(("dx", "dw", "dgamma", "dbeta"), want, pair):
        assert _rel(a, b) <= BNB_VJP_RTOL, (name, _rel(a, b))


def test_bottleneck_kernels_refuse_float32(card):
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    x, w, gamma, _beta, dy, m, inv = _bnb_inputs(card, 256, 64, 256)
    with pytest.raises(mx.MXNetError, match="bfloat16"):
        bnb.bottleneck_bwd_reduce(dy.float(), x.float(), w.float(), m, inv)


# -- rtc (row 7): a user CudaModule, the softmax head's kernels --------
# softmax forward and backward against their plain versions: atol 1e-6
# (expf and the row sums in another order; values are at most 1); axpy:
# exact (the kernel rounds a·x and the sum apart, as the plain version
# does, then once to the type)
RTC_ATOL = 1e-6


# rows of 10 and 33 columns (a warp a row in registers, scalar accesses),
# 1000 and 1024 (a warp a row in registers, 16-byte accesses), 1025 and
# 4096 (the online pass and the writing pass)
@pytest.mark.parametrize("rows,cols", [(1024, 10), (8192, 1000), (3, 33),
                                       (257, 33), (64, 1024), (64, 1025),
                                       (64, 4096)])
def test_rtc_softmax_kernels_match_plain(card, rows, cols):
    from incubator_mxnet_torch import rtc, softmax_rtc as srtc
    gen = torch.Generator(device=card).manual_seed(rows)
    x = torch.randn(rows, cols, generator=gen, device=card) * 4
    label = torch.randint(0, cols, (rows,), generator=gen,
                          device=card).float()
    rtc.reset_launch_counts()
    y, dx = torch.empty_like(x), torch.empty_like(x)
    srtc.softmax_fwd(x, y)
    srtc.softmax_bwd(label, y, dx)
    ry, rdx = torch.empty_like(x), torch.empty_like(x)
    srtc.softmax_fwd_plain(x, ry, rows, cols, 1)
    srtc.softmax_bwd_plain(label, y, rdx, rows, cols, 1)
    torch.cuda.synchronize()
    assert (y - ry).abs().max().item() <= RTC_ATOL
    assert (dx - rdx).abs().max().item() <= RTC_ATOL
    srtc.softmax_fwd(x, y, req="add")
    torch.cuda.synchronize()
    assert (y - 2 * ry).abs().max().item() <= 2 * RTC_ATOL
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (torch.randn(rows, cols, generator=gen, device=card)
                .to(dtype) for _ in range(2))
        want = b.clone()
        srtc.axpy_plain(a, want, 0.37, want.numel())
        srtc.axpy(a, b, 0.37)
        torch.cuda.synchronize()
        assert torch.equal(b, want), dtype
    assert dict(rtc.launch_counts) == {
        "softmax_fwd": 2, "softmax_bwd": 1, "axpy<float>": 1,
        "axpy<__nv_bfloat16>": 1}


@pytest.mark.parametrize("rows,cols", [(256, 1000), (64, 4096), (9, 12)])
def test_rtc_softmax_fwd_on_misaligned_views(card, rows, cols):
    """x and y cut one float into a buffer, so neither is 16-byte
    aligned: the forward takes its scalar accesses, writing and adding."""
    from incubator_mxnet_torch import softmax_rtc as srtc
    gen = torch.Generator(device=card).manual_seed(cols)
    n = rows * cols
    bx = torch.randn(n + 1, generator=gen, device=card) * 4
    by = torch.rand(n + 1, generator=gen, device=card)
    x, y = (b[1:].view(rows, cols) for b in (bx, by))
    assert x.data_ptr() % 16 and y.data_ptr() % 16
    want = torch.empty_like(x)
    srtc.softmax_fwd_plain(x, want, rows, cols, 1)
    y0 = y.clone()
    srtc.softmax_fwd(x, y, req="add")
    torch.cuda.synchronize()
    assert (y - (y0 + want)).abs().max().item() <= 2 * RTC_ATOL
    srtc.softmax_fwd(x, y)
    torch.cuda.synchronize()
    assert (y - want).abs().max().item() <= RTC_ATOL


def test_rtc_compile_error_raises_with_nvcc_message(card):
    from incubator_mxnet_torch import rtc
    mod = rtc.CudaModule("__global__ void broken(float *x) { x[0] = 1 }")
    k = mod.get_kernel("broken", "float *x")
    with pytest.raises(mx.MXNetError, match="error"):
        k.launch([torch.zeros(1, device=card)], mx.gpu(0), (1,), (1,))


def test_rtc_checks_raise_before_launch(card):
    from incubator_mxnet_torch import rtc, softmax_rtc as srtc
    rtc.reset_launch_counts()
    x = torch.zeros(4, 10, device=card, dtype=torch.float64)
    with pytest.raises(mx.MXNetError, match="needs torch.float32"):
        srtc.softmax_fwd(x, x)
    with pytest.raises(mx.MXNetError, match="is on cpu"):
        srtc.kernels()["softmax_fwd"].launch(
            [torch.zeros(4, 10, device=card), torch.zeros(4, 10), 4, 10, 1],
            mx.gpu(0), (1,), (128,))
    assert not rtc.launch_counts


def test_rtc_launch_error_and_large_dynamic_shared_memory(card):
    """A block larger than the kernel's launch bounds is refused by the
    launch, with CUDA's message; 100 KB of dynamic shared memory needs
    the attribute the launcher sets above 48 KB."""
    from incubator_mxnet_torch import rtc
    src = r"""
    extern "C" __global__ void __launch_bounds__(64) small(float *x) {
      x[threadIdx.x] = 1.f;
    }
    extern "C" __global__ void big_smem(float *x, int n) {
      extern __shared__ float s[];
      for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = (float)i;
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = s[n - 1 - i];
    }
    """
    mod = rtc.CudaModule(src)
    x = torch.zeros(25600, device=card)
    with pytest.raises(mx.MXNetError, match="launch failed"):
        mod.get_kernel("small", "float *x").launch([x], mx.gpu(0), (1,),
                                                    (128,))
    mod.get_kernel("big_smem", "float *x, int n").launch(
        [x, 25600], mx.gpu(0), (1,), (256,), shared_mem=25600 * 4)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.arange(25599, -1, -1, device=card).float())


def test_rtc_softmax_head_gradients_match_the_loss(card):
    """The softmax_rtc head's gradients are SoftmaxCrossEntropyLoss's
    (rtol 1e-5 of the largest: the same maths, sums in another order)."""
    from incubator_mxnet_torch import autograd, gluon, nd
    from incubator_mxnet_torch import softmax_rtc  # noqa: F401 (registers)
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(64, 10, generator=gen, device=card)
    label = nd.NDArray(torch.randint(0, 10, (64,), generator=gen,
                                     device=card).float())
    grads = []
    for head in ("rtc", "loss"):
        xa = nd.NDArray(x.clone())
        xa.attach_grad()
        with autograd.record():
            out = nd.Custom(xa, label, op_type="softmax_rtc") if \
                head == "rtc" else \
                gluon.loss.SoftmaxCrossEntropyLoss()(xa, label)
        out.backward()
        grads.append(xa.grad.data)
    top = grads[1].abs().max().item()
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * top
