"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA device. On a CUDA
host (which need not have JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

TF32 is off for the plain versions. Tolerances: 1e-4 for the fuser tail
(fp32 sums of up to 512 terms in another order), 2e-5 for attention (fp32
online vs two-pass softmax); gradients summed over rows are held to the same
figures relative to their largest entry. The native cross-attention (K6,
K7) is held to 2e-5 forward and 1e-4 backward in fp32 (its gradient sums
run over up to 3,100 keys). In bf16 the kernels and the plain versions
round at the same points, but a sum taken in another order can land a
value on the neighbouring bf16 number (2**-8 relative), so bf16 results
are held to 2e-2 of the tensor's largest entry. K3-K6 in bf16 split the
keys across blocks and sum the blocks' partials in block order, so two calls
must agree bit for bit, and the shapes around their block sizes (64 keys
for K5, whole units of 128 for K3, K4 and K6, 32 queries) are covered: one
key, less than a block, one key past a block, and blocks whose keys are all
masked. K7 in bf16 splits the keys as K6 does and sums the splits' dq in
split order: the same holds for it, and for K3, K5, K6 and K7 in fp32,
which split the keys into runs of 64 (or whole tiles of 64 past 512 keys)
whose blocks combine through distributed shared memory in rank order, one
launch a call; fp32 K4 is K3's body with dropout, fp32 K6 and K7 are K3's
and K5's bodies on the native layout. K1 runs its three products as 3xTF32 on
the tensor cores over a fixed order of weight chunks, and K2 its products
too, with its column sums and split partials summed in order: two calls
agree bit for bit for both.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import SELF_TOL, attention_inputs, cross_inputs, fuser_inputs
from r3d_tpu_torch.ops import attention as att
from r3d_tpu_torch.ops import cross_attention as ca
from r3d_tpu_torch.ops import fuser_kernel as fk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.parametrize("N", [1, 15, 16, 2048, 2053, 4096, 8192, 16000])
def test_fused_bn_blend_tail_kernel_matches_plain(cuda, N):
    gen = torch.Generator().manual_seed(N)
    r, d, blend, params = fuser_inputs(N, gen, cuda)
    before = fk.KERNEL.launches
    got = fk.fused_bn_blend_tail(r, d, blend, params)
    torch.cuda.synchronize()
    assert fk.KERNEL.launches == before + 1
    want = fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("Lk", [1, 31, 256, 300, 512, 1024])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_kernel_matches_plain(cuda, Lk, D):
    gen = torch.Generator().manual_seed(Lk + D)
    q, k, v, bias = attention_inputs(8, 8, 8, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    scale = 1.0 / math.sqrt(D)
    before = att.KERNEL.launches
    got = att.flash_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert att.KERNEL.launches == before + 1
    want = att.composed_attention(q, k, v, bias, scale)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    got = att.flash_attention(q, k, v, None, scale)
    torch.testing.assert_close(got, att.composed_attention(q, k, v, None, scale),
                               atol=2e-5, rtol=0)


def test_attention_kernel_gives_zero_not_nan_under_an_all_inf_bias(cuda):
    q = torch.randn(1, 2, 8, 16, device=cuda)
    k = torch.randn(1, 2, 40, 16, device=cuda)
    bias = torch.full((1, 1, 1, 40), -math.inf, device=cuda)
    out = att.flash_attention(q, k, k, bias, 0.25)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("Lk", [1, 31, 300, 512, 1024, 2049])
@pytest.mark.parametrize("Lq", [33, 70])
@pytest.mark.parametrize("D", [16, 64])
def test_attention_kernel_takes_many_query_tiles(cuda, D, Lq, Lk):
    """fp32 K3 (the cluster body) past one query tile of 8, with splits of
    one tile and, from 1,024 keys on, of several (the ring)."""
    gen = torch.Generator().manual_seed(Lq * Lk + D)
    q, k, v, bias = attention_inputs(8, 8, Lq, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    scale = 1.0 / math.sqrt(D)
    got = att.flash_attention(q, k, v, bias, scale)
    torch.testing.assert_close(got, att.composed_attention(q, k, v, bias, scale), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("Lq,Lk", [(8, 256), (8, 512), (70, 300), (20, 1100)])
def test_attention_fp32_kernels_are_deterministic(cuda, Lq, Lk):
    """fp32 K3 and K5 combine their splits' statistics, dq and outputs in
    rank order: two calls agree bit for bit."""
    gen = torch.Generator().manual_seed(Lq + Lk)
    q, k, v, bias = attention_inputs(8, 8, Lq, Lk, 16, gen, cuda, all_masked_row=True)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    assert torch.equal(att.flash_attention(q, k, v, bias, 0.25),
                       att.flash_attention(q, k, v, bias, 0.25))
    first = att.attention_bwd(q, k, v, bias, 5, 0.25, 0.1, g, need_dbias=True)
    again = att.attention_bwd(q, k, v, bias, 5, 0.25, 0.1, g, need_dbias=True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Lk", [256, 512])
def test_attention_fp32_calls_are_one_launch_each(cuda, Lk):
    """One fp32 K3, K4 or K5 call on the card, at the utkinects decoder's
    shape, is one launch of its own kernel, and nothing else (no memset of
    dk and dv)."""
    from chip_smoke import own_launches_per_call

    gen = torch.Generator().manual_seed(Lk)
    q, k, v, bias = attention_inputs(8, 8, 8, Lk, 16, gen, cuda)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    own_launches_per_call(lambda: att.flash_attention(q, k, v, bias, 0.25),
                          ("attention_fwd_cluster_kernel",), 1, "K3 fp32")
    own_launches_per_call(lambda: att.flash_attention_dropout(q, k, v, bias, 3, 0.25, 0.1),
                          ("attention_fwd_cluster_kernel",), 1, "K4 fp32")
    for rate in (0.0, 0.1):
        own_launches_per_call(lambda: att.attention_bwd(q, k, v, bias, 3, 0.25, rate, g),
                              ("attention_bwd_cluster_kernel",), 1, "K5 fp32")


def test_attention_bwd_kernel_gives_zeros_under_an_all_inf_bias(cuda):
    q = torch.randn(1, 2, 8, 16, device=cuda)
    k = torch.randn(1, 2, 300, 16, device=cuda)
    bias = torch.full((1, 1, 1, 300), -math.inf, device=cuda)
    for x in att.attention_bwd(q, k, k, bias, 1, 0.25, 0.1, q, need_dbias=True):
        assert torch.equal(x, torch.zeros_like(x))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    r, d, blend, params = fuser_inputs(64, gen, cuda)
    with pytest.raises(ValueError, match="float32"):
        fk.fused_bn_blend_tail(r.half(), d, blend, params)
    with pytest.raises(ValueError, match="C == 128"):
        fk.fused_bn_blend_tail(r[:, :64].contiguous(), d[:, :64].contiguous(), blend, params)
    q, k, v, bias = attention_inputs(2, 2, 8, 64, 16, gen, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        att.flash_attention(q.transpose(0, 1), k, v, bias, 0.25)
    with pytest.raises(ValueError, match="head dim"):
        att.flash_attention(q[..., :8], k[..., :8], v[..., :8], bias, 0.25)


# ---- the training kernels: K1's no-blend route, K2, K4, K5 ----

def _close(got, want, rel, name="", floor=1.0):
    """|got - want| <= rel * max(max|want|, floor): the kernels sum in
    another order than the plain versions, and gradients summed over
    thousands of rows grow with the row count."""
    scale = max(float(want.abs().max()), floor)
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all(), name
    assert err <= rel * scale, f"{name}: max|diff| {err:.3e} > {rel} * {scale:.3e}"


@pytest.mark.parametrize("outer", [False, True], ids=["plain-tail", "outer-residual"])
@pytest.mark.parametrize("N", [1, 16, 2053, 4096, 16000])
def test_fused_safuser_tail_kernel_matches_plain(cuda, N, outer):
    gen = torch.Generator().manual_seed(N)
    r, d, blend, params = fuser_inputs(N, gen, cuda)
    kernel = fk.TAIL_KERNEL_OUTER if outer else fk.TAIL_KERNEL
    before = kernel.launches
    got = fk.fused_safuser_tail(r, d, params, outer)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, fk.composed_tail(r, d, params, outer), atol=1e-4, rtol=0)
    got = fk.fused_bn_blend_tail(r, d, blend, params, outer)
    want = fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params, outer)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("N", [15, 2048, 4096, 16000])
def test_fused_tail_kernel_is_deterministic(cuda, N):
    """K1 (3xTF32 products over a fixed order of weight chunks): two calls
    of each route agree bit for bit, below one row tile (15 rows) and at the
    utkinects buckets' two tile sizes (32 rows of each stream from 8 x 512)."""
    gen = torch.Generator().manual_seed(N + 3)
    r, d, blend, params = fuser_inputs(N, gen, cuda)
    for outer in (False, True):
        assert torch.equal(fk.fused_safuser_tail(r, d, params, outer),
                           fk.fused_safuser_tail(r, d, params, outer))
        assert torch.equal(fk.fused_bn_blend_tail(r, d, blend, params, outer),
                           fk.fused_bn_blend_tail(r, d, blend, params, outer))


@pytest.mark.parametrize("outer", [False, True], ids=["plain-tail", "outer-residual"])
@pytest.mark.parametrize("N", [1, 16, 2053, 2048, 4096, 16000])
def test_fused_tail_bwd_kernel_matches_plain(cuda, N, outer):
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    gen = torch.Generator().manual_seed(N + 1)
    r, d, _, params = fuser_inputs(N, gen, cuda)
    g = torch.randn(N, 128, generator=gen).to(cuda)
    kernel = fkb.KERNEL_OUTER if outer else fkb.KERNEL
    before = kernel.launches
    dr, dd, dp = fkb.fused_tail_bwd(r, d, g, params, outer)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    wr, wd, wp = fkb.composed_tail_bwd(r, d, g, params, outer)
    _close(dr, wr, 1e-4, "dr")
    _close(dd, wd, 1e-4, "dd")
    for name, a, b in zip(fk.FuserTailParams._fields, dp, wp):
        _close(a, b, 1e-4, name)


BF16_STEP = 2.0 ** -7   # one bf16 step at the top of a binade, relative


def _close_bf16(got, want, steps, name, share=0.01):
    """bf16 ``got`` within ``steps`` bf16 steps of ``want``'s largest entry,
    and at most ``share`` of the entries off at all: the kernel and the plain
    version round at the same points, so only a sum that lands on the other
    side of a rounding boundary moves a value (and what it feeds)."""
    assert got.dtype == want.dtype == torch.bfloat16, name
    assert torch.isfinite(got.float()).all(), name
    diff = (got.float() - want.float()).abs()
    big = float(want.float().abs().max())
    assert float(diff.max()) <= steps * BF16_STEP * big, (name, float(diff.max()), big)
    assert float((diff > 0).float().mean()) <= share, (name, float((diff > 0).float().mean()))


@pytest.mark.parametrize("outer", [False, True], ids=["plain-tail", "outer-residual"])
@pytest.mark.parametrize("N", [1, 16, 2053, 4096, 16000])
def test_fused_tail_bf16_kernel_matches_plain(cuda, N, outer):
    """bf16 K1 on both routes (bf16 streams, fp32 parameters) against the
    plain version in bf16: within two bf16 steps of the largest entry, at
    most 1 % of the entries off; each call one launch on its own counter;
    two calls bit-equal."""
    gen = torch.Generator().manual_seed(N + 7)
    r, d, blend, params = fuser_inputs(N, gen, cuda)
    r, d = r.bfloat16(), d.bfloat16()
    tail = fk.TAIL_KERNEL_BF16_OUTER if outer else fk.TAIL_KERNEL_BF16
    before = tail.launches, fk.KERNEL_BF16.launches, fk.TAIL_KERNEL.launches, fk.KERNEL.launches
    got = fk.fused_safuser_tail(r, d, params, outer)
    got_blend = fk.fused_bn_blend_tail(r, d, blend, params, outer)
    torch.cuda.synchronize()
    after = tail.launches, fk.KERNEL_BF16.launches, fk.TAIL_KERNEL.launches, fk.KERNEL.launches
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
    _close_bf16(got, fk.composed_tail(r, d, params, outer), 2, "no-blend")
    want = fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params, outer)
    _close_bf16(got_blend, want, 2, "blend")
    assert torch.equal(got, fk.fused_safuser_tail(r, d, params, outer))
    assert torch.equal(got_blend, fk.fused_bn_blend_tail(r, d, blend, params, outer))


@pytest.mark.parametrize("outer", [False, True], ids=["plain-tail", "outer-residual"])
@pytest.mark.parametrize("N", [1, 16, 2053, 4096, 16000])
def test_fused_tail_bwd_bf16_kernel_matches_plain(cuda, N, outer):
    """bf16 K2 (bf16 r, d, g in, bf16 dr, dd out, fp32 inside): dr and dd
    within one bf16 step of the largest entry (the fp32 body agrees to 1e-4
    before its one rounding), the fp32 parameter gradients within K2's
    fp32 1e-4; its own counter; two calls bit-equal."""
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    gen = torch.Generator().manual_seed(N + 9)
    r, d, _, params = fuser_inputs(N, gen, cuda)
    r, d = r.bfloat16(), d.bfloat16()
    g = torch.randn(N, 128, generator=gen).to(cuda).bfloat16()
    kernel = fkb.KERNEL_BF16_OUTER if outer else fkb.KERNEL_BF16
    before = kernel.launches, fkb.KERNEL.launches
    dr, dd, dp = fkb.fused_tail_bwd(r, d, g, params, outer)
    torch.cuda.synchronize()
    assert (kernel.launches, fkb.KERNEL.launches) == (before[0] + 1, before[1])
    wr, wd, wp = fkb.composed_tail_bwd(r, d, g, params, outer)
    _close_bf16(dr, wr, 1, "dr")
    _close_bf16(dd, wd, 1, "dd")
    for name, a, b in zip(fk.FuserTailParams._fields, dp, wp):
        assert a.dtype == torch.float32, name
        _close(a, b, 1e-4, name)
    again = fkb.fused_tail_bwd(r, d, g, params, outer)
    for a, b in zip((dr, dd, *dp), (again[0], again[1], *again[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [1, 16, 2053, 2048, 4096, 8192, 16000])
def test_fused_tail_bwd_kernel_is_deterministic(cuda, N):
    """K2 sums its tiles' column sums and its splits' partials in a fixed
    order: two calls agree bit for bit, the outer residual off and on."""
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    gen = torch.Generator().manual_seed(N + 5)
    r, d, _, params = fuser_inputs(N, gen, cuda)
    g = torch.randn(N, 128, generator=gen).to(cuda)
    for outer in (False, True):
        first = fkb.fused_tail_bwd(r, d, g, params, outer)
        again = fkb.fused_tail_bwd(r, d, g, params, outer)
        for a, b in zip((first[0], first[1], *first[2]), (again[0], again[1], *again[2])):
            assert torch.equal(a, b)


def test_fused_tail_bwd_call_is_its_own_four_launches(cuda):
    """One K2 call at N = 8 x 512 is the weights' transpose, the row phase,
    the weight gradients and the ordered sum, and nothing else (no memset)."""
    from chip_smoke import own_launches_per_call
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    gen = torch.Generator().manual_seed(9)
    r, d, _, params = fuser_inputs(4096, gen, cuda)
    g = torch.randn(4096, 128, generator=gen).to(cuda)
    own_launches_per_call(lambda: fkb.fused_tail_bwd(r, d, g, params),
                          ("transpose_weights_kernel", "fuser_tail_bwd_rows_kernel",
                           "fuser_tail_wgrad_kernel", "fuser_tail_bwd_sum_kernel"), 4, "K2")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq", [8, 33, 70])
@pytest.mark.parametrize("Lk", [1, 31, 65, 256, 300, 512, 1100])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_dropout_kernel_matches_plain(cuda, Lk, D, Lq, rate):
    """fp32 K4 (the cluster body with dropout; from ``FP32_MANY_QUERY_MIN``
    queries the many-query forward): one launch, two calls bit for bit,
    within 2e-5 of the plain version, with a fully masked row."""
    gen = torch.Generator().manual_seed(Lk * D + Lq)
    q, k, v, bias = attention_inputs(8, 8, Lq, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    scale = 1.0 / math.sqrt(D)
    kernel = att.DROPOUT_KERNEL_MANY if Lq >= att.FP32_MANY_QUERY_MIN else att.DROPOUT_KERNEL
    before = kernel.launches
    got = att.flash_attention_dropout(q, k, v, bias, 1234 + Lk, scale, rate)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = att.composed_attention_dropout(q, k, v, bias, 1234 + Lk, scale, rate)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert torch.equal(got, att.flash_attention_dropout(q, k, v, bias, 1234 + Lk, scale, rate))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq", [8, 33, 70])
@pytest.mark.parametrize("Lk", [1, 31, 256, 300, 512, 1024])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_bwd_kernel_matches_plain(cuda, Lk, D, Lq, rate):
    gen = torch.Generator().manual_seed(Lk + D)
    q, k, v, bias = attention_inputs(8, 8, Lq, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    scale = 1.0 / math.sqrt(D)
    kernel = att.BWD_KERNEL_MANY if Lq >= att.FP32_MANY_QUERY_MIN else att.BWD_KERNEL
    before = kernel.launches
    got = att.attention_bwd(q, k, v, bias, 77, scale, rate, g, need_dbias=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = att.composed_attention_bwd(q, k, v, bias, 77, scale, rate, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(a, b, 2e-5, name)


@pytest.mark.parametrize("S", [256, 512, 777, 1024, 2000])
def test_attention_fp32_kernels_with_s_queries_match_plain(cuda, S):
    """fp32 K3, K4 and K5 with S queries against S keys (the encoder's
    self-attention, ``use_encoder=True``) at B = H = 8, D = 16, ragged rows
    and one fully masked: one launch a call, counted on the ``*_MANY``
    kernels (K3 and K4 the many-query forward, K5 the many-query backward),
    two calls bit for bit, forward within 2e-5; K5's sums run over
    up to 2,000 queries or keys, so its gradients are held to 2e-5 of their
    largest entry to 512 and 1e-4 past it (as fp32 K7's over 3,100 keys)."""
    gen = torch.Generator().manual_seed(S + 11)
    q, k, v, bias = attention_inputs(8, 8, S, S, 16, gen, cuda, all_masked_row=True)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    calls = (
        (att.KERNEL_MANY, lambda: att.flash_attention(q, k, v, bias, 0.25),
         lambda: att.composed_attention(q, k, v, bias, 0.25)),
        (att.DROPOUT_KERNEL_MANY, lambda: att.flash_attention_dropout(q, k, v, bias, 7, 0.25, 0.1),
         lambda: att.composed_attention_dropout(q, k, v, bias, 7, 0.25, 0.1)))
    for kernel, fn, plain in calls:
        before = kernel.launches
        got = fn()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, kernel.name
        torch.testing.assert_close(got, plain(), atol=2e-5, rtol=0)
        assert torch.equal(got, fn()), kernel.name
    rel = 2e-5 if S <= 512 else 1e-4
    for rate in (0.0, 0.1):
        before = att.BWD_KERNEL_MANY.launches
        got = att.attention_bwd(q, k, v, bias, 7, 0.25, rate, g, need_dbias=True)
        torch.cuda.synchronize()
        assert att.BWD_KERNEL_MANY.launches == before + 1
        want = att.composed_attention_bwd(q, k, v, bias, 7, 0.25, rate, g)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            _close(a, b, rel, f"{name} rate {rate}")
        again = att.attention_bwd(q, k, v, bias, 7, 0.25, rate, g, need_dbias=True)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("depth", [1, 2])
def test_cmfuser_grad_on_the_card_matches_the_cpu(cuda, depth):
    """``CMFuserGrad`` (the outer residual) at the utkinects width over 8 x
    512 rows, train mode with dropout 0: at depth 1 one K1 no-blend launch
    forward and one K2 launch backward, both counted as outer-residual
    calls, at depth 2 none (the composed blocks, as in JAX); the output
    within 1e-4 and every gradient within 1e-4 of its largest entry of the
    same module on the CPU (the plain version). The training ranking swaps
    channels [0, 32) on the card."""
    from r3d_tpu_torch.models.fuser import CMFuserGrad
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    torch.manual_seed(depth)
    cpu = CMFuserGrad(128, depth=depth, drop_rate=0.0).train()
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    card = CMFuserGrad(128, depth=depth, drop_rate=0.0).to(cuda).train()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(depth + 40)
    rgb, dep, w = (torch.randn(8, 512, 128, generator=gen) for _ in range(3))
    mask_r, mask_d = card.masks(rgb.to(cuda), dep.to(cuda))
    first = torch.arange(128, device=cuda) < 32
    assert torch.equal(mask_r, first) and torch.equal(mask_d, first)
    before = fk.TAIL_KERNEL_OUTER.launches, fkb.KERNEL_OUTER.launches
    r, d = rgb.to(cuda).requires_grad_(), dep.to(cuda).requires_grad_()
    out = card(r, d)
    (out * w.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    launched = fk.TAIL_KERNEL_OUTER.launches - before[0], fkb.KERNEL_OUTER.launches - before[1]
    assert launched == ((1, 1) if depth == 1 else (0, 0)), launched
    rc, dc = rgb.clone().requires_grad_(), dep.clone().requires_grad_()
    want = cpu(rc, dc)
    (want * w).sum().backward()
    _close(out.detach().cpu(), want.detach(), 1e-4, "out")
    for name, a, b in (("rgb", r.grad, rc.grad), ("depth", d.grad, dc.grad)):
        _close(a.cpu(), b, 1e-4, name)
    grads = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        _close(p.grad.cpu(), grads[name].grad, 1e-4, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_attention_bwd_kernel_takes_many_query_tiles(cuda, dtype):
    gen = torch.Generator().manual_seed(5)
    q, k, v, bias = attention_inputs(2, 2, 300, 300, 32, gen, cuda)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    if dtype == "bf16":
        q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    got = att.attention_bwd(q, k, v, bias, 3, 0.2, 0.1, g, need_dbias=True)
    want = att.composed_attention_bwd(q, k, v, bias, 3, 0.2, 0.1, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype, name
        _close(a.float(), b.float(), 2e-5 if dtype == "fp32" else 2e-2, name)


def _grads(fn, inputs):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    g = torch.ones_like(out) + torch.arange(out.numel(), device=out.device).view(out.shape) % 7
    return [x if x is not None else torch.zeros_like(l)
            for x, l in zip(torch.autograd.grad(out, leaves, g, allow_unused=True), leaves)]


def test_autograd_functions_match_autograd_of_plain(cuda):
    """The four autograd.Functions' gradients on the card against autograd
    through the plain versions."""
    gen = torch.Generator().manual_seed(11)
    r, d, blend, params = fuser_inputs(2053, gen, cuda)
    P = fk.FuserTailParams
    got = _grads(lambda r_, d_, *p: fk.fused_safuser_tail(r_, d_, P(*p)), (r, d, *params))
    want = _grads(lambda r_, d_, *p: fk.composed_tail(r_, d_, P(*p)), (r, d, *params))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    Bl = fk.BlendParams
    got = _grads(lambda r_, d_, *t: fk.fused_bn_blend_tail(r_, d_, Bl(*t[:7]), P(*t[7:])),
                 (r, d, *blend, *params))
    want = _grads(lambda r_, d_, *t: fk.composed_tail(
        *fk.composed_bn_blend(r_, d_, Bl(*t[:7])), P(*t[7:])), (r, d, *blend, *params))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    q, k, v, bias = attention_inputs(8, 8, 8, 512, 16, gen, cuda)
    got = _grads(lambda *t: att.flash_attention(*t, bias, 0.25), (q, k, v))
    want = _grads(lambda *t: att.composed_attention(*t, bias, 0.25), (q, k, v))
    for a, b in zip(got, want):
        _close(a, b, 2e-5)
    got = _grads(lambda *t: att.flash_attention_dropout(*t, bias, 9, 0.25, 0.1), (q, k, v))
    want = _grads(lambda *t: att.composed_attention_dropout(*t, bias, 9, 0.25, 0.1), (q, k, v))
    for a, b in zip(got, want):
        _close(a, b, 2e-5)


# ---- the 50salads slice: K6, K7, and K3-K5 in bf16 ----

BF16_TOL = 2e-2
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [1, 31, 257, 777, 1024, 3100])
@pytest.mark.parametrize("Lq,C,H", [(20, 512, 8), (8, 128, 8), (64, 64, 2), (33, 128, 4),
                                   (64, 512, 8)],
                         ids=["50salads", "breakfast", "64-queries", "33-queries",
                              "50salads-width-64-queries"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_attention_kernels_match_plain(cuda, dtype, Lq, C, H, S, rate):
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(S + C + Lq)
    q, k, v, bias = cross_inputs(4, Lq, S, C, gen, cuda, dt, all_masked_row=S > 1)
    scale = 1.0 / math.sqrt(C // H)
    fwd, bwd = ca.BY_DTYPE[dt]
    before = fwd.launches
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 5 + S, scale, rate, H)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    w_out, w_m, w_l = ca.composed_cross_attention(q, k, v, bias, 5 + S, scale, rate, H)
    _close(out.float(), w_out.float(), 2e-5 if dtype == "fp32" else BF16_TOL, "out")
    # a fully masked row's m is finfo.min on both sides
    torch.testing.assert_close(m, w_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, w_l, atol=1e-5, rtol=1e-5)
    g = torch.randn(q.shape, generator=gen).to(cuda, dt)
    before = bwd.launches
    got = ca.cross_attention_bwd(q, k, v, bias, 5 + S, scale, rate, H, g, out, m, l,
                                 need_dbias=True)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    want = ca.composed_cross_attention_bwd(q, k, v, bias, 5 + S, scale, rate, H, g, out, m, l)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype, name
        _close(a.float(), b.float(), 1e-4 if dtype == "fp32" else BF16_TOL, name)


def test_cross_attention_kernel_is_deterministic_and_keeps_its_rate(cuda):
    gen = torch.Generator().manual_seed(3)
    q, k, v, bias = cross_inputs(8, 20, 3100, 512, gen, cuda, torch.bfloat16)
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 7, 0.125, 0.1, 8)
    first = ca.cross_attention_bwd(q, k, v, bias, 7, 0.125, 0.1, 8, g, out, m, l, True)
    again = ca.cross_attention_bwd(q, k, v, bias, 7, 0.125, 0.1, 8, g, out, m, l, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    kept = float((att.dropout_keep(7, 0.1, (8, 8, 20, 3100), cuda) > 0).double().mean())
    assert abs(kept - 0.9) < 5 * (0.09 / (8 * 8 * 20 * 3100)) ** 0.5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_attention_kernel_takes_splits_with_every_key_masked(cuda, dtype):
    """Row 1 keeps 10 keys of 1,024, so all its splits but the first hold
    only masked keys (weight 0 in the combine, not NaN); row 2 keeps none
    (the uniform average over all 1,024); row 3 keeps 300 (a warp and a
    split that are masked in part)."""
    from r3d_tpu_torch.models.layers import attention_bias_from_padding

    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(41)
    q, k, v, _ = cross_inputs(4, 20, 1024, 512, gen, cuda, dt)
    lengths = torch.tensor([1024, 10, 0, 300])
    bias = attention_bias_from_padding((torch.arange(1024)[None] >= lengths[:, None]).to(cuda))
    g = torch.randn(q.shape, generator=gen).to(cuda, dt)
    for rate in (0.0, 0.1):
        out, m, l = ca.cross_attention_fwd(q, k, v, bias, 9, 0.125, rate, 8)
        w_out, w_m, w_l = ca.composed_cross_attention(q, k, v, bias, 9, 0.125, rate, 8)
        assert torch.isfinite(out.float()).all()
        _close(out.float(), w_out.float(), 2e-5 if dtype == "fp32" else BF16_TOL, "out")
        torch.testing.assert_close(m, w_m, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(l, w_l, atol=1e-5, rtol=1e-5)
        # K7 on the same rows: its later splits of rows 1 and 3 hold only
        # masked keys, and row 2 none
        got = ca.cross_attention_bwd(q, k, v, bias, 9, 0.125, rate, 8, g, out, m, l, True)
        want = ca.composed_cross_attention_bwd(q, k, v, bias, 9, 0.125, rate, 8, g, out, m, l)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            _close(a.float(), b.float(), 1e-4 if dtype == "fp32" else BF16_TOL, name)
    assert float(l[2].min()) == 1024.0 and float(m[2].max()) == torch.finfo(torch.float32).min


@pytest.mark.parametrize("Lq,S", [(64, 777), (20, 257)])
def test_cross_attention_bwd_kernel_is_deterministic(cuda, Lq, S):
    """K7 in bf16 sums its splits' dq and its heads' dbias in a fixed order:
    two calls agree bit for bit, with a fully masked row."""
    gen = torch.Generator().manual_seed(Lq + S)
    q, k, v, bias = cross_inputs(8, Lq, S, 512, gen, cuda, torch.bfloat16, all_masked_row=True)
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 7, 0.125, 0.1, 8)
    first = ca.cross_attention_bwd(q, k, v, bias, 7, 0.125, 0.1, 8, g, out, m, l, True)
    again = ca.cross_attention_bwd(q, k, v, bias, 7, 0.125, 0.1, 8, g, out, m, l, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_cross_attention_bwd_call_is_its_own_two_launches(cuda):
    """One bf16 K7 call on the card is its main and its sum kernel, and
    nothing else (no memset, no cast)."""
    from chip_smoke import own_launches_per_call

    gen = torch.Generator().manual_seed(2)
    q, k, v, bias = cross_inputs(8, 20, 3100, 512, gen, cuda, torch.bfloat16)
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 0, 0.125, 0.0, 8)
    own_launches_per_call(lambda: ca.cross_attention_bwd(q, k, v, bias, 0, 0.125, 0.0, 8, g, out,
                                                         m, l),
                          ("cross_bwd_bf16_kernel", "cross_bwd_sum_kernel"), 2, "K7 bf16")


@pytest.mark.parametrize("S", [257, 3100])
def test_cross_attention_fwd_kernel_is_deterministic(cuda, S):
    gen = torch.Generator().manual_seed(S)
    q, k, v, bias = cross_inputs(8, 20, S, 512, gen, cuda, torch.bfloat16, all_masked_row=True)
    first = ca.cross_attention_fwd(q, k, v, bias, 7, 0.125, 0.1, 8)
    again = ca.cross_attention_fwd(q, k, v, bias, 7, 0.125, 0.1, 8)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Lq,Lk", [(20, 512), (70, 300)])
def test_attention_bwd_bf16_kernel_is_deterministic(cuda, Lq, Lk):
    gen = torch.Generator().manual_seed(Lq + Lk)
    q, k, v, bias = attention_inputs(8, 8, Lq, Lk, 64, gen, cuda, all_masked_row=True)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    first = att.attention_bwd(q, k, v, bias, 5, 0.125, 0.1, g, need_dbias=True)
    again = att.attention_bwd(q, k, v, bias, 5, 0.125, 0.1, g, need_dbias=True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_cross_attention_autograd_matches_autograd_of_plain(cuda):
    gen = torch.Generator().manual_seed(12)
    q, k, v, bias = cross_inputs(4, 20, 1100, 512, gen, cuda, torch.float32)
    for rate in (0.0, 0.1):
        got = _grads(lambda *t: ca.cross_attention_native(*t, 4, 0.125, rate, 8), (q, k, v, bias))
        want = _grads(lambda *t: ca.composed_cross_attention(*t, 4, 0.125, rate, 8)[0],
                      (q, k, v, bias))
        for a, b in zip(got, want):
            _close(a, b, 1e-4)


@pytest.mark.parametrize("Lq,Lk", [(q, k) for q in (20, 33, 70)
                                   for k in (1, 31, 65, 256, 300, 512, 1024, 2048)]
                         + [(512, 512)])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_kernels_bf16_match_plain(cuda, Lk, D, Lq):
    """K3, K4 and K5 on bf16 inputs at the 50salads query count, at query
    counts of more than one tile of 32, on the self-attention route (Lq ==
    Lk), at key counts around the forwards' splits (one, less than one of
    128, 8 of 128 at 1,024, 8 of 256 at 2,048); at Lk = 512 also with rows
    whose later splits hold only masked keys. From ``MANY_QUERY_MIN``
    queries on (33, 70, 512) the calls take the many-query bodies."""
    from chip_smoke import masked_split_bias

    gen = torch.Generator().manual_seed(Lk + 7 * D)
    q, k, v, bias = attention_inputs(8, 8, Lq, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    # from MANY_QUERY_MIN queries on the many-query bodies, whose backward
    # runs its forward first when it is not handed what that keeps
    many = Lq >= att.MANY_QUERY_MIN
    kerns = ((att.KERNEL_BF16_MANY, att.DROPOUT_KERNEL_BF16_MANY, att.BWD_KERNEL_BF16_MANY) if many
             else (att.KERNEL_BF16, att.DROPOUT_KERNEL_BF16, att.BWD_KERNEL_BF16))
    counts = [kern.launches for kern in kerns]
    got = att.flash_attention(q, k, v, bias, scale)
    _close(got.float(), att.composed_attention(q, k, v, bias, scale).float(), BF16_TOL, "K3")
    got = att.flash_attention_dropout(q, k, v, bias, 21, scale, 0.1)
    want = att.composed_attention_dropout(q, k, v, bias, 21, scale, 0.1)
    _close(got.float(), want.float(), BF16_TOL, "K4")
    for rate in (0.0, 0.1):
        got = att.attention_bwd(q, k, v, bias, 21, scale, rate, g, need_dbias=True)
        want = att.composed_attention_bwd(q, k, v, bias, 21, scale, rate, g)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            assert a.dtype == b.dtype, name
            _close(a.float(), b.float(), BF16_TOL, name)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kerns] == [c + n for c, n in
                                                 zip(counts, (2, 2, 2) if many else (1, 1, 2))]
    if Lk == 512:
        bias = masked_split_bias(8, Lk, (512, 10, 0, 128, 129, 300, 384, 1), cuda)
        got = att.flash_attention(q, k, v, bias, scale)
        _close(got.float(), att.composed_attention(q, k, v, bias, scale).float(), BF16_TOL,
               "K3, masked splits")
        got = att.flash_attention_dropout(q, k, v, bias, 22, scale, 0.1)
        want = att.composed_attention_dropout(q, k, v, bias, 22, scale, 0.1)
        _close(got.float(), want.float(), BF16_TOL, "K4, masked splits")


@pytest.mark.parametrize("B,H,S,D", [(8, 8, 256, 64), (8, 8, 512, 64), (8, 8, 1024, 64),
                                     (8, 8, 3100, 64), (16, 8, 2000, 16), (8, 8, 777, 64)])
def test_attention_kernels_bf16_with_s_queries_match_plain(cuda, B, H, S, D):
    """bf16 K3, K4 and K5 with S queries against S keys, the decoder
    attention of futr_proposed: the 50salads_proposed buckets at D = 64,
    Breakfast's 2000 bucket at D = 16 and B = 16, and a ragged S; random key
    lengths per row; each against its plain version, within ``SELF_TOL`` of
    each tensor's own largest entry (no floor of 1: the entries there are
    far below 1), and twice bit-equal."""
    gen = torch.Generator().manual_seed(S + D)
    q, k, v, bias = attention_inputs(B, H, S, S, D, gen, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    got = att.flash_attention(q, k, v, bias, scale)
    _close(got.float(), att.composed_attention(q, k, v, bias, scale).float(), SELF_TOL, "K3",
           floor=0.0)
    assert torch.equal(got, att.flash_attention(q, k, v, bias, scale))
    got = att.flash_attention_dropout(q, k, v, bias, 23, scale, 0.1)
    want = att.composed_attention_dropout(q, k, v, bias, 23, scale, 0.1)
    _close(got.float(), want.float(), SELF_TOL, "K4", floor=0.0)
    assert torch.equal(got, att.flash_attention_dropout(q, k, v, bias, 23, scale, 0.1))
    del got, want
    for rate in (0.0, 0.1):
        got = att.attention_bwd(q, k, v, bias, 23, scale, rate, g, need_dbias=True)
        want = att.composed_attention_bwd(q, k, v, bias, 23, scale, rate, g)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            _close(a.float(), b.float(), SELF_TOL, name, floor=0.0)
        del want
        torch.cuda.empty_cache()
    again = att.attention_bwd(q, k, v, bias, 23, scale, 0.1, g, need_dbias=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("Lq,Lk", [(20, 512), (70, 300), (20, 2049)])
def test_attention_fwd_bf16_kernels_are_deterministic(cuda, Lq, Lk):
    """K3 and K4 in bf16 sum their splits' statistics and partials in a
    fixed order: two calls agree bit for bit."""
    gen = torch.Generator().manual_seed(Lq * Lk)
    q, k, v, bias = attention_inputs(8, 8, Lq, Lk, 64, gen, cuda, all_masked_row=True)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    assert torch.equal(att.flash_attention(q, k, v, bias, 0.125),
                       att.flash_attention(q, k, v, bias, 0.125))
    assert torch.equal(att.flash_attention_dropout(q, k, v, bias, 5, 0.125, 0.1),
                       att.flash_attention_dropout(q, k, v, bias, 5, 0.125, 0.1))


def test_cross_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    q, k, v, bias = cross_inputs(2, 20, 600, 512, gen, cuda, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ca.cross_attention_native(q, k, v, bias, 0, 0.1, 0.0, 4)   # D = 128
    with pytest.raises(ValueError, match="contiguous"):
        ca.cross_attention_native(q, k.half(), v, bias, 0, 0.1, 0.0, 8)
    big = torch.zeros(2, 65, 512, device=cuda)
    with pytest.raises(ValueError, match="queries"):
        ca.cross_attention_native(big, k, v, bias, 0, 0.1, 0.0, 8)


# ---- fp32 K6 and K7: the cluster bodies on the native layout ----

def _fp32_cross(B, Lq, S, C, seed, lengths=None):
    """fp32 native-layout q, k, v, g on the card and a key-padding bias: with
    ``lengths`` rows keeping those numbers of keys (0: fully masked), else
    random lengths and a fully masked last row."""
    from chip_smoke import masked_split_bias

    gen = torch.Generator().manual_seed(seed)
    q, k, v, bias = cross_inputs(B, Lq, S, C, gen, "cuda", torch.float32, all_masked_row=True)
    if lengths is not None:
        bias = masked_split_bias(B, S, lengths, "cuda")
    return q, k, v, bias, torch.randn(q.shape, generator=gen).to("cuda")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,D,S", [(1, 16, 513), (8, 16, 1024), (8, 16, 2000), (3, 32, 777),
                                   (20, 32, 1025), (33, 64, 2049), (64, 16, 3100),
                                   (64, 64, 1500)])
def test_fp32_cross_attention_kernels_match_plain(cuda, Lq, D, S, rate):
    """fp32 K6 and K7 at Lq 1-64, D 16-64 and S 513-3,100 with ragged key
    tails and a fully masked row: out, m and l within 2e-5, the gradients
    within 1e-4 of each one's largest entry; each call one launch of the
    wrapper."""
    H = 8 if D == 16 else 4
    q, k, v, bias, g = _fp32_cross(3, Lq, S, H * D, S + Lq + D)
    scale = 1.0 / math.sqrt(D)
    fwd, bwd = ca.FWD_KERNEL_FP32, ca.BWD_KERNEL_FP32
    before = fwd.launches, bwd.launches, ca.FWD_KERNEL.launches, ca.BWD_KERNEL.launches
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 3 + S, scale, rate, H)
    got = ca.cross_attention_bwd(q, k, v, bias, 3 + S, scale, rate, H, g, out, m, l, True)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches, ca.FWD_KERNEL.launches, ca.BWD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])   # the bf16 counters stay
    w_out, w_m, w_l = ca.composed_cross_attention(q, k, v, bias, 3 + S, scale, rate, H)
    _close(out, w_out, 2e-5, "out")
    torch.testing.assert_close(m, w_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, w_l, atol=1e-5, rtol=1e-5)
    want = ca.composed_cross_attention_bwd(q, k, v, bias, 3 + S, scale, rate, H, g, out, m, l)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(a, b, 1e-4, name)


@pytest.mark.parametrize("S", [1024, 2000, 2049])
def test_fp32_cross_attention_takes_splits_with_every_key_masked(cuda, S):
    """Rows keeping 10, 300 and 0 keys: the later runs of the first two
    hold only masked keys (weight 0 in the combine), the third averages V
    over every key; K7 on the same rows; two calls of each bit-equal."""
    q, k, v, bias, g = _fp32_cross(4, 8, S, 128, S, lengths=(S, 10, 300, 0))
    for rate in (0.0, 0.1):
        out, m, l = ca.cross_attention_fwd(q, k, v, bias, 9, 0.25, rate, 8)
        w_out, w_m, w_l = ca.composed_cross_attention(q, k, v, bias, 9, 0.25, rate, 8)
        assert torch.isfinite(out).all()
        _close(out, w_out, 2e-5, "out")
        torch.testing.assert_close(m, w_m, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(l, w_l, atol=1e-5, rtol=1e-5)
        got = ca.cross_attention_bwd(q, k, v, bias, 9, 0.25, rate, 8, g, out, m, l, True)
        want = ca.composed_cross_attention_bwd(q, k, v, bias, 9, 0.25, rate, 8, g, out, m, l)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            _close(a, b, 1e-4, name)
        for a, b in zip((out, m, l), ca.cross_attention_fwd(q, k, v, bias, 9, 0.25, rate, 8)):
            assert torch.equal(a, b)
        for a, b in zip(got, ca.cross_attention_bwd(q, k, v, bias, 9, 0.25, rate, 8, g, out, m,
                                                    l, True)):
            assert torch.equal(a, b)
    assert float(l[3].min()) == float(S)


def test_fp32_cross_attention_gives_zeros_under_an_all_inf_bias(cuda):
    """Every score -inf: out 0 and (m, l) = (-inf, 0), and zero gradients
    from those statistics, not NaN."""
    q, k, v, _, g = _fp32_cross(2, 8, 777, 128, 1)
    bias = torch.full((2, 1, 1, 777), -math.inf, device=cuda)
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 1, 0.25, 0.1, 8)
    assert torch.equal(out, torch.zeros_like(out)) and bool((m == -math.inf).all())
    assert torch.equal(l, torch.zeros_like(l))
    for x in ca.cross_attention_bwd(q, k, v, bias, 1, 0.25, 0.1, 8, g, out, m, l, True):
        assert torch.equal(x, torch.zeros_like(x))


@pytest.mark.parametrize("S", [1024, 2000])
def test_fp32_cross_attention_calls_are_one_launch_each(cuda, S):
    """At the utkinects buckets' shape one fp32 K6 call is one launch of the
    forward cluster kernel, one K7 call without dbias one of the backward's,
    and one with dbias that launch and the wrapper's sum over heads; the
    names are the ones chip_smoke.py times."""
    from chip_smoke import cross_fp32_kernel_names, own_launches_per_call

    q, k, v, bias, g = _fp32_cross(8, 8, S, 128, S)
    fwd_name, bwd_name = cross_fp32_kernel_names(16)
    own_launches_per_call(lambda: ca.cross_attention_fwd(q, k, v, bias, 0, 0.25, 0.0, 8),
                          (fwd_name,), 1, "K6 fp32")
    out, m, l = ca.cross_attention_fwd(q, k, v, bias, 0, 0.25, 0.0, 8)
    own_launches_per_call(lambda: ca.cross_attention_bwd(q, k, v, bias, 0, 0.25, 0.0, 8, g, out,
                                                         m, l),
                          (bwd_name,), 1, "K7 fp32")
    own_launches_per_call(lambda: ca.cross_attention_bwd(q, k, v, bias, 0, 0.25, 0.0, 8, g, out,
                                                         m, l, True),
                          (bwd_name, "reduce_kernel"), 2, "K7 fp32 with dbias")


def test_fp32_cross_attention_fwd_refuses_more_than_8_splits(cuda):
    """The forward's cluster holds at most the portable 8 blocks: 16 runs of
    64 keys at S = 1,024 are refused (cudaErrorInvalidValue), not launched."""
    q, k, v, bias, _ = _fp32_cross(8, 8, 1024, 128, 1)
    got = (torch.empty_like(q), torch.empty((8, 8, 8), device=q.device),
           torch.empty((8, 8, 8), device=q.device))
    stream = torch.cuda.current_stream().cuda_stream
    err = ca.FWD_KERNEL_FP32.load()(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                    *(t.data_ptr() for t in got), None, 64, 8, 8, 1024, 8, 16,
                                    0.25, 0, 0, 0, 1.0, stream)
    torch.cuda.synchronize()
    assert err == 1   # cudaErrorInvalidValue


# ---- checkpoints and the MoC sweep on the card ----

def _utk_card_config(root=""):
    """utkinects at its widths (hidden 128, 8 heads: K1's C and K3's D),
    narrow inputs (64 features, 8x6 depth frames), buckets 128-512."""
    import dataclasses

    from r3d_tpu_torch.config import get_config

    base = get_config("utkinects")
    return base.replace(
        data=dataclasses.replace(base.data, data_root=root, depth_shape=(8, 6),
                                 seq_buckets=(128, 256, 512)),
        model=dataclasses.replace(base.model, input_dim=64, max_pos_len=512),
        train=dataclasses.replace(base.train, batch_size=4, min_train_batch=0, warmup_epochs=0))


def _trained(device, cfg, steps=2):
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.train.loop import Trainer

    src = build_source(cfg.data, "train_split.txt")
    loader = build_loader(src, cfg.data, 4, 8, seed=0)
    trainer = Trainer(cfg, src.n_class, device=device)
    state = trainer.init_state(len(loader), seed=1)
    batches = list(loader)[:steps]
    for epoch, b in enumerate(batches):
        trainer.train_step(state, b, epoch)
    return trainer, state, batches


@pytest.fixture(scope="module")
def utk_disk(tmp_path_factory):
    from chip_smoke import write_utkinect_dataset

    return write_utkinect_dataset(tmp_path_factory.mktemp("card_utk"), 4, 3, (300, 560),
                                  n_actions=16, input_dim=64, depth_shape=(8, 6))


@pytest.mark.parametrize("saved_on", ["cuda", "cpu"])
def test_checkpoint_round_trip_across_devices(cuda, utk_disk, tmp_path, saved_on):
    """A state trained on one device, saved, restored onto the other and
    back: bit-exact parameters, BN buffers, AdamW moments and step, every
    restored tensor on its template's device."""
    from r3d_tpu_torch.train.checkpoint import Checkpointer

    cfg = _utk_card_config(utk_disk)
    other = "cpu" if saved_on == "cuda" else "cuda"
    trainer, state, batches = _trained(saved_on, cfg)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save_last(state, seed=1)
    from r3d_tpu_torch.train.loop import Trainer

    there = ckpt.restore_last(1, Trainer(cfg, trainer.n_class, device=other).init_state(
        len(batches), seed=2))
    ckpt.save(there, "moved")
    back = ckpt.restore("moved", trainer.init_state(len(batches), seed=3))
    for restored, device in ((there, other), (back, saved_on)):
        want, got = state.model.state_dict(), restored.model.state_dict()
        for k in want:
            assert got[k].device.type == device
            assert torch.equal(got[k].cpu(), want[k].cpu()), k
        want_opt = state.optimizer.state_dict()["state"]
        got_opt = restored.optimizer.state_dict()["state"]
        assert sorted(got_opt) == sorted(want_opt)
        for i, s in want_opt.items():
            for name in ("exp_avg", "exp_avg_sq"):
                assert got_opt[i][name].device.type == device
                assert torch.equal(got_opt[i][name].cpu(), s[name].cpu()), (i, name)
            assert float(got_opt[i]["step"]) == float(s["step"])
        assert restored.step == state.step == len(batches)


def test_predictor_on_the_card_matches_its_cpu_self(cuda, utk_disk):
    """The 9-ratio sweep of 3 videos (windows in the 128-512 buckets) on the
    card against the CPU from the same weights: every chunk launches K1, the
    256/512 chunks K3; action logits and durations within 5e-2 (the
    utkinects bound of ``chip_smoke.E2E_TOL``: bf16 embeds); MoC and
    accuracies equal wherever no window decodes differently."""
    from chip_smoke import E2E_TOL, SweepRecorder, decode_flips
    from r3d_tpu_torch.data.datasets import build_source
    from r3d_tpu_torch.eval.predict import Predictor
    from r3d_tpu_torch.models import build_model, init_weights

    cfg = _utk_card_config(utk_disk)
    src = build_source(cfg.data, "val_split.txt")
    model = init_weights(build_model(cfg.model, src.n_class, cfg.data.depth_shape),
                         torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for device in ("cuda", "cpu"):
        pred = Predictor(cfg, build_model(cfg.model, src.n_class, cfg.data.depth_shape),
                         src.n_class, device=device)
        with SweepRecorder([fk.KERNEL, att.KERNEL]) as rec:
            runs[device] = (pred.predict_multi(sd, src, list(cfg.eval.obs_percs)), rec.chunks)
    (gres, gchunks), (cres, cchunks) = runs["cuda"], runs["cpu"]
    assert {c["S"] for c in gchunks} == {128, 256, 512}
    for c in gchunks:
        assert c["launches"]["fused_bn_blend_tail"] >= 1
        assert (c["launches"]["flash_attention"] >= 1) == (c["S"] in (256, 512))
    for c in cchunks:
        assert sum(c["launches"].values()) == 0
    err = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(gchunks, cchunks)
              for k in ("action", "duration"))
    assert err <= E2E_TOL
    flipped, unexplained = decode_flips(gchunks, cchunks, err, src.n_class)
    assert unexplained == 0
    if flipped == 0:
        for o in cres:
            for k in cres[o]:
                if k.startswith("obs"):
                    assert gres[o][k] == cres[o][k], (o, k)


# ---- the fp32 many-query forward (csrc/attention_many_f32.cu) ----

@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk", [(33, 1), (33, 300), (64, 64), (65, 65), (130, 2049),
                                   (777, 129), (2000, 63)])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_fp32_many_query_forward_matches_plain(cuda, D, Lq, Lk, rate):
    """fp32 K3 (rate 0) and K4 on the many-query forward at query counts
    around its blocks of 64 and key counts around its tiles of 64 (one key,
    a last tile of one key, more than the ring's three stages), with a
    fully masked row where Lk > 1 and without a bias: one launch on its
    counter, within 2e-5 of the plain version, two calls bit for bit; a
    training call keeps (the statistics, None, the keep bits or None at
    rate 0), and its out is bit for bit the out of a call without
    gradients."""
    gen = torch.Generator().manual_seed(Lq * 3 + Lk + D)
    q, k, v, bias = attention_inputs(2, 3, Lq, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    scale = 1.0 / math.sqrt(D)
    assert att.fp32_many_query(q) and not att.many_query(q)
    kernel = att.DROPOUT_KERNEL_MANY if rate > 0.0 else att.KERNEL_MANY
    for b in (bias, None):
        before = kernel.launches
        got, saved = att._attention_fwd_dropout(q, k, v, b, 9, scale, rate, for_grad=True) \
            if rate > 0.0 else att._attention_fwd(q, k, v, b, scale, for_grad=True)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        stats, none, bits = saved
        assert none is None and stats.shape == (2, 6, Lq) and torch.isfinite(stats).all()
        assert (bits is None) == (rate == 0.0)
        want = att.composed_attention_dropout(q, k, v, b, 9, scale, rate)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        again = (att.flash_attention_dropout(q, k, v, b, 9, scale, rate) if rate > 0.0
                 else att.flash_attention(q, k, v, b, scale))
        assert torch.equal(got, again)


def _many_bwd_tol(Lq, Lk):
    """fp32 K5 over each gradient's max(1, largest entry): 2e-5 to 512 rows
    a sum, 1e-4 past it (``chip_smoke.K3_TOL``, ``SELF32_BWD_TOL``)."""
    return 2e-5 if max(Lq, Lk) <= 512 else 1e-4


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk", [(33, 300), (65, 65), (200, 513), (777, 1), (1000, 257),
                                   (2000, 2000)])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_fp32_many_query_backward_matches_plain(cuda, D, Lq, Lk, rate):
    """fp32 K5 on the many-query backward (``attention_many_bwd_f32.cu``) at
    query and key counts that are not multiples of its tiles of 64, one
    key, S = 2,000, with a fully masked row where Lk > 1, the bias's
    cotangent and without a bias: one launch on ``attention_bwd_many``,
    within ``_many_bwd_tol`` of the plain version, twice bit-equal, and bit
    for bit the same with the forward's saved tensors given and not given."""
    gen = torch.Generator().manual_seed(Lq * 5 + Lk + D)
    q, k, v, bias = attention_inputs(2, 3, Lq, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    scale = 1.0 / math.sqrt(D)
    for b in (bias, None):
        _, saved = (att._attention_fwd_dropout(q, k, v, b, 5, scale, rate, for_grad=True)
                    if rate > 0.0 else att._attention_fwd(q, k, v, b, scale, for_grad=True))
        before = att.BWD_KERNEL_MANY.launches
        got = att.attention_bwd(q, k, v, b, 5, scale, rate, g, need_dbias=True, saved=saved)
        torch.cuda.synchronize()
        assert att.BWD_KERNEL_MANY.launches == before + 1
        want = att.composed_attention_bwd(q, k, v, b, 5, scale, rate, g)
        assert (got[3] is None) == (b is None)
        for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
            if y is not None:
                _close(x, y, _many_bwd_tol(Lq, Lk), f"{name} bias={b is not None}")
        again = att.attention_bwd(q, k, v, b, 5, scale, rate, g, need_dbias=True, saved=saved)
        unsaved = att.attention_bwd(q, k, v, b, 5, scale, rate, g, need_dbias=True)
        for x, y, z in zip(got, again, unsaved):
            assert (x is None and y is None and z is None) or (torch.equal(x, y)
                                                              and torch.equal(x, z))


def test_fp32_many_query_backward_gives_zeros_under_an_all_inf_bias(cuda):
    """A row whose every score is -inf: zeros out and zeros in every
    gradient, no NaN."""
    q = torch.randn(1, 2, 70, 16, device=cuda)
    k = torch.randn(1, 2, 300, 16, device=cuda)
    bias = torch.full((1, 1, 1, 300), -math.inf, device=cuda)
    for rate in (0.0, 0.1):
        out, saved = (att._attention_fwd_dropout(q, k, k, bias, 1, 0.25, rate, for_grad=True)
                      if rate > 0.0 else att._attention_fwd(q, k, k, bias, 0.25, for_grad=True))
        assert torch.equal(out, torch.zeros_like(out))
        for x in att.attention_bwd(q, k, k, bias, 1, 0.25, rate, q, need_dbias=True, saved=saved):
            assert torch.equal(x, torch.zeros_like(x))


def test_fp32_many_query_calls_are_their_own_launches(cuda):
    """One fp32 many-query backward call with its forward's saved tensors is
    the two launches of ``attention_many_bwd_f32.cu`` and nothing else (no
    memset, no cast); without them, its forward's launch first."""
    from chip_smoke import BWD_MANY_F32, own_launches_per_call

    gen = torch.Generator().manual_seed(4)
    q, k, v, bias = attention_inputs(4, 4, 512, 512, 16, gen, cuda)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    _, saved = att._attention_fwd_dropout(q, k, v, bias, 3, 0.25, 0.1, for_grad=True)
    own_launches_per_call(lambda: att.attention_bwd(q, k, v, bias, 3, 0.25, 0.1, g, saved=saved),
                          BWD_MANY_F32, 2, "K5 fp32 many-query")
    own_launches_per_call(lambda: att.attention_bwd(q, k, v, bias, 3, 0.25, 0.1, g),
                          BWD_MANY_F32 + ("attention_fwd_many_f32_kernel",), 3,
                          "K5 fp32 many-query, its forward first")


def test_fp32_many_query_training_call_takes_the_many_query_backward(cuda):
    """An fp32 S-query call under autograd: the forward on the many-query
    body, which saves (the statistics, the keep bits), the backward on
    the many-query backward counted as ``BWD_KERNEL_MANY``, one launch of
    each a step and none of the cluster bodies; gradients within 2e-5 of
    the plain backward's largest entry."""
    gen = torch.Generator().manual_seed(41)
    q, k, v, bias = attention_inputs(2, 4, 300, 300, 16, gen, cuda, all_masked_row=True)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels = (att.DROPOUT_KERNEL_MANY, att.BWD_KERNEL_MANY, att.DROPOUT_KERNEL, att.BWD_KERNEL)
    before = [kern.launches for kern in kernels]
    out = att.flash_attention_dropout(*leaves, bias, 3, 0.25, 0.1)
    saved = out.grad_fn.saved_tensors   # q, k, v, the bias, then what K5 takes
    assert len(saved) == 7 and saved[5] is None
    assert saved[4].shape == (2, 8, 300) and saved[6].dtype == torch.int32
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert [kern.launches - c for kern, c in zip(kernels, before)] == [1, 1, 0, 0]
    want = att.composed_attention_bwd(q, k, v, bias, 3, 0.25, 0.1, g)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        _close(a, b, 2e-5, name)


# ---- the many-query bf16 bodies (csrc/attention_many.cu, attention_many_bwd.cu) ----

@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk", [(33, 300), (65, 65), (200, 513), (777, 1), (1000, 257)])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_many_query_bodies_match_plain(cuda, D, Lq, Lk, rate):
    """The many-query forward and backward at query counts that are not a
    multiple of their tiles (64 queries a block, 64 keys a tile), with a
    fully masked row (Lk > 1), the bias's cotangent, rate 0 and 0.1, each
    call twice bit-equal; held to the plain versions within ``BF16_TOL``."""
    gen = torch.Generator().manual_seed(Lq * 7 + Lk + D)
    q, k, v, bias = attention_inputs(2, 3, Lq, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    assert att.many_query(q)
    out, saved = att._attention_fwd_dropout(q, k, v, bias, 5, scale, rate, for_grad=True)
    want = att.composed_attention_dropout(q, k, v, bias, 5, scale, rate)
    _close(out.float(), want.float(), BF16_TOL, "out")
    again = att._attention_fwd_dropout(q, k, v, bias, 5, scale, rate, for_grad=True)
    assert torch.equal(out, again[0]) and all(torch.equal(a, b) for a, b in zip(saved, again[1]))
    assert torch.equal(out, att.flash_attention_dropout(q, k, v, bias, 5, scale, rate))
    got = att.attention_bwd(q, k, v, bias, 5, scale, rate, g, need_dbias=True, saved=saved)
    want = att.composed_attention_bwd(q, k, v, bias, 5, scale, rate, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype, name
        _close(a.float(), b.float(), BF16_TOL, name)
    again = att.attention_bwd(q, k, v, bias, 5, scale, rate, g, need_dbias=True, saved=saved)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert att.attention_bwd(q, k, v, bias, 5, scale, rate, g, saved=saved)[3] is None


def test_many_query_autograd_matches_autograd_of_plain(cuda):
    """The autograd Functions on the many-query route (the forward keeps its
    statistics and fp32 output for the backward) against autograd through
    the plain versions, the bias's gradient included."""
    gen = torch.Generator().manual_seed(13)
    q, k, v, bias = attention_inputs(2, 4, 300, 300, 32, gen, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    for fn, plain in ((lambda *t: att.flash_attention(*t, 0.2),
                       lambda *t: att.composed_attention(*t, 0.2)),
                      (lambda *t: att.flash_attention_dropout(*t, 8, 0.2, 0.1),
                       lambda *t: att.composed_attention_dropout(*t, 8, 0.2, 0.1))):
        for a, b in zip(_grads(fn, (q, k, v, bias)), _grads(plain, (q, k, v, bias))):
            _close(a.float(), b.float(), BF16_TOL)


def test_many_query_calls_are_their_own_launches(cuda):
    """One many-query forward call is one launch of its kernel and one
    backward call two, and nothing else; a 20-query call takes the
    few-query bodies."""
    from chip_smoke import BWD_MANY, own_launches_per_call

    gen = torch.Generator().manual_seed(3)
    q, k, v, bias = attention_inputs(4, 4, 512, 512, 64, gen, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen).to(cuda, torch.bfloat16)
    _, saved = att._attention_fwd_dropout(q, k, v, bias, 3, 0.125, 0.1, for_grad=True)
    own_launches_per_call(lambda: att.flash_attention(q, k, v, bias, 0.125),
                          ("attention_fwd_many_kernel",), 1, "K3 many-query")
    own_launches_per_call(lambda: att.flash_attention_dropout(q, k, v, bias, 3, 0.125, 0.1),
                          ("attention_fwd_many_kernel",), 1, "K4 many-query")
    own_launches_per_call(lambda: att.attention_bwd(q, k, v, bias, 3, 0.125, 0.1, g, saved=saved),
                          BWD_MANY, 2, "K5 many-query")
    few = [kern.launches for kern in (att.KERNEL_BF16, att.KERNEL_BF16_MANY)]
    att.flash_attention(q[:, :, :20].contiguous(), k, v, bias, 0.125)
    assert [kern.launches for kern in (att.KERNEL_BF16, att.KERNEL_BF16_MANY)] == [few[0] + 1,
                                                                                    few[1]]


def test_many_query_bodies_give_zeros_under_an_all_inf_bias(cuda):
    q = torch.randn(1, 2, 70, 16, device=cuda).to(torch.bfloat16)
    k = torch.randn(1, 2, 300, 16, device=cuda).to(torch.bfloat16)
    bias = torch.full((1, 1, 1, 300), -math.inf, device=cuda)
    out, saved = att._attention_fwd(q, k, k, bias, 0.25, for_grad=True)
    assert torch.equal(out, torch.zeros_like(out))
    for x in att.attention_bwd(q, k, k, bias, 1, 0.25, 0.0, q, need_dbias=True, saved=saved):
        assert torch.equal(x, torch.zeros_like(x))


# ---- the DARai family: fp32 K3-K5 with 8 queries against the 256/512 buckets ----

@pytest.mark.parametrize("masked", [False, True], ids=["no-bias", "ragged-keys"])
@pytest.mark.parametrize("Lk", [256, 512])
@pytest.mark.parametrize("B", [1, 8])
def test_fp32_attention_at_the_darai_shapes(cuda, B, Lk, masked):
    """The decoder's cross-attention of ``darai`` and ``darai_gaze``: 8
    heads of 16, 8 queries against the 256- and 512-row buckets, batch 8 in
    training and 1 in validation and the sweep (whose forward has no key
    mask): K3, K4 at 0.1 and K5 at rates 0 and 0.1, one launch each, within
    2e-5 of the plain versions."""
    gen = torch.Generator().manual_seed(B * Lk + masked)
    q, k, v, bias = attention_inputs(B, 8, 8, Lk, 16, gen, cuda)
    bias = bias if masked else None
    g = torch.randn(q.shape, generator=gen).to(cuda)
    launches = [kern.launches for kern in (att.KERNEL, att.DROPOUT_KERNEL, att.BWD_KERNEL)]
    torch.testing.assert_close(att.flash_attention(q, k, v, bias, 0.25),
                               att.composed_attention(q, k, v, bias, 0.25), atol=2e-5, rtol=0)
    torch.testing.assert_close(att.flash_attention_dropout(q, k, v, bias, 9, 0.25, 0.1),
                               att.composed_attention_dropout(q, k, v, bias, 9, 0.25, 0.1),
                               atol=2e-5, rtol=0)
    for rate in (0.0, 0.1):
        got = att.attention_bwd(q, k, v, bias, 9, 0.25, rate, g, need_dbias=masked)
        want = att.composed_attention_bwd(q, k, v, bias, 9, 0.25, rate, g)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close(a, b, 2e-5, name)
    torch.cuda.synchronize()
    assert [kern.launches for kern in (att.KERNEL, att.DROPOUT_KERNEL, att.BWD_KERNEL)] == [
        launches[0] + 1, launches[1] + 1, launches[2] + 2]


@pytest.mark.parametrize("name", ["darai", "darai_gaze"])
def test_darai_step_through_the_kernels_matches_the_plain_route(cuda, tmp_path, name):
    """One sticky train step of a 512-bucket batch of 8 at the configs'
    widths (hidden 128, 8 heads, 8 queries; 64 input features) on the card,
    through fp32 K3 and K5 and through the plain route: within
    ``chip_smoke.fp32_step_kernels_vs_plain``'s bounds."""
    import dataclasses

    from chip_smoke import (DARAI_GAZE_ROWS, DARAI_TRAIN, fp32_step_kernels_vs_plain,
                            one_batch, write_darai_dataset)
    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.models import build_model, init_weights

    root = write_darai_dataset(tmp_path, DARAI_TRAIN, (), input_dim=64,
                               gaze_rows=DARAI_GAZE_ROWS)
    base = get_config(name)
    cfg = base.replace(data=dataclasses.replace(base.data, data_root=root),
                       model=dataclasses.replace(base.model, input_dim=64))
    src = build_source(cfg.data, "train_split.txt")
    batch = one_batch(build_loader(src, cfg.data, 8, 8, seed=0), 256)
    assert batch["features"].shape[:2] == (8, 512)
    model = init_weights(build_model(cfg.model, src.n_class), torch.Generator().manual_seed(0))
    fp32_step_kernels_vs_plain(cfg, model.state_dict(), batch, src.n_class,
                               [att.KERNEL, att.DROPOUT_KERNEL, att.BWD_KERNEL])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, dtype):
    """``MoEFeedForward`` (4 experts, top 2, pad rows, a capacity that
    drops) on the card against the CPU from the same weights, the CPU
    taking the card's expert choices (``chip_smoke.MoERouting``): outputs
    and gradients within 1e-5 in fp32, 2e-2 of the largest entry in bf16."""
    from chip_smoke import MoERouting
    from r3d_tpu_torch.models.moe import MoEFeedForward

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 300, 64, generator=gen)
    pad = torch.arange(300)[None, :] >= torch.tensor([300, 250, 128, 7])[:, None]
    m = MoEFeedForward(64, 256, 4, 2, 0.8, dtype=dtype)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    out = {}
    with MoERouting("MoE layer, card vs CPU"):
        for dev in ("cuda", "cpu"):
            mm = m.to(dev)
            mm.zero_grad()
            xd = x.to(dev).requires_grad_()
            y = mm(xd, pad.to(dev))
            ((y.float() ** 2).mean() + mm.aux).backward()
            y = y.detach()
            out[dev] = (y.float().cpu(), xd.grad.float().cpu(),
                        {n: p.grad.float().cpu() for n, p in mm.named_parameters()})
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    (yc, gc, pc), (yh, gh, ph) = out["cuda"], out["cpu"]
    assert float((yc - yh).abs().max()) <= tol * max(1.0, float(yh.abs().max()))
    assert float((gc - gh).abs().max()) <= tol * max(1.0, float(gh.abs().max()))
    for n in ph:
        assert float((pc[n] - ph[n]).abs().max()) <= tol * max(1.0, float(ph[n].abs().max())), n


@pytest.mark.parametrize("model", ["rnn", "tcn"])
def test_baselines_on_the_card_match_the_cpu(cuda, model):
    """The BiLSTM (packed, cuDNN) and the TCN (cuDNN's 1-D convs) at hidden
    128 on ragged rows, in eval mode (the TCN's dropout off) with gradients,
    as a sticky step runs them: outputs on the real rows and the gradients
    within 1e-4 of the CPU's (fp32, TF32 off)."""
    import dataclasses

    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights

    base = get_config("nturgbd")
    cfg = dataclasses.replace(base.model, model=model, input_dim=64, embed_dtype=None)
    net = init_weights(build_model(cfg, 11), torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 256, 64, generator=gen)
    pad = torch.arange(256)[None, :] >= torch.tensor([256, 200, 129, 31])[:, None]
    res = {}
    for dev in ("cuda", "cpu"):
        n = net.to(dev)
        n.zero_grad()
        out = n(x.to(dev), pad.to(dev))
        sum((v[~pad.to(dev)] if k == "supcon" else v).float().pow(2).mean()
            for k, v in out.items()).backward()
        res[dev] = ({k: v.detach().float().cpu() for k, v in out.items()},
                    {k: p.grad.cpu() for k, p in n.named_parameters() if p.grad is not None})
    (oc, gc), (oh, gh) = res["cuda"], res["cpu"]
    for k in oh:
        a, b = (oc[k][~pad], oh[k][~pad]) if k == "supcon" else (oc[k], oh[k])
        assert float((a - b).abs().max()) <= 1e-4, k
    assert gc.keys() == gh.keys()
    for k in gh:
        assert float((gc[k] - gh[k]).abs().max()) <= 1e-4 * max(1.0, float(gh[k].abs().max())), k


def test_depth_source_keeps_its_fixed_dropouts_in_a_sticky_step(cuda, tmp_path):
    """``darai --model futr_unsupervised_depth`` at hidden 128 (64 input
    features): a sticky train step of a 512-bucket batch through the
    kernels keeps the source's and the queries' ``Dropout(0.1)`` on, each
    within 3 sigma of 0.9 with the backward through the forward's mask
    (``chip_smoke.sticky_dropout_on_card``; ROADMAP C4)."""
    import dataclasses

    from chip_smoke import DARAI_TRAIN, one_batch, sticky_dropout_on_card, write_darai_dataset
    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.data.datasets import build_loader, build_source
    from r3d_tpu_torch.models import build_model, init_weights

    root = write_darai_dataset(tmp_path, DARAI_TRAIN[:1], (), input_dim=64)
    base = get_config("darai")
    cfg = base.replace(data=dataclasses.replace(base.data, data_root=root),
                       model=dataclasses.replace(base.model, input_dim=64,
                                                 model="futr_unsupervised_depth"))
    src = build_source(cfg.data, "train_split.txt")
    batch = one_batch(build_loader(src, cfg.data, 8, 8, seed=0), 0)
    model = init_weights(build_model(cfg.model, src.n_class), torch.Generator().manual_seed(0))
    keep = sticky_dropout_on_card(cfg, model.state_dict(), batch, src.n_class)
    assert sorted(keep) == ["query_drop", "src_drop"]


# ---- the serving kernels as registered operators; quantized serving ----

SERVING_OP_ROUTES = ["k1_blend", "k1_blend_outer", "k1_noblend", "k1_noblend_outer", "k3",
                     "k3_many", "k6"]


def _serving_op_case(route, dtype, device):
    """(the operator's call, the direct launch of its kernel, the kernel's
    counter) at the serving shapes: K1 at the 512 bucket's 8 x 512 rows; K3
    at the utkinects decoder's 8 queries x 512 keys (fp32) and 50salads'
    20 x 256 (bf16), the many-query body at 512 x 512; K6 at the utkinects
    2000 bucket (fp32) and 50salads' 3100 (bf16)."""
    gen = torch.Generator().manual_seed(len(route))
    fp32 = dtype == torch.float32
    if route.startswith("k1"):
        r, d, blend, params = fuser_inputs(8 * 512, gen, device)
        r, d = r.to(dtype), d.to(dtype)
        outer = route.endswith("outer")
        if "noblend" in route:
            kernel = {(True, False): fk.TAIL_KERNEL, (True, True): fk.TAIL_KERNEL_OUTER,
                      (False, False): fk.TAIL_KERNEL_BF16,
                      (False, True): fk.TAIL_KERNEL_BF16_OUTER}[fp32, outer]
            return (lambda: fk.safuser_tail_op(r, d, list(params), outer),
                    lambda: fk._safuser_tail_fwd(r, d, params, outer), kernel)
        return (lambda: fk.bn_blend_tail_op(r, d, list(blend), list(params), outer),
                lambda: fk._bn_blend_tail_fwd(r, d, blend, params, outer),
                fk.KERNEL if fp32 else fk.KERNEL_BF16)
    if route.startswith("k3"):
        B, H, D = 8, 8, 16 if fp32 else 64
        Lq, Lk = (512, 512) if route == "k3_many" else ((8, 512) if fp32 else (20, 256))
        q, k, v, bias = attention_inputs(B, H, Lq, Lk, D, gen, device)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        kernel = ({(True, False): att.KERNEL, (True, True): att.KERNEL_MANY,
                   (False, False): att.KERNEL_BF16, (False, True): att.KERNEL_BF16_MANY}
                  [fp32, route == "k3_many"])
        return (lambda: att.flash_attention_op(q, k, v, bias, D ** -0.5),
                lambda: att._attention_fwd(q, k, v, bias, D ** -0.5)[0], kernel)
    B, Lq, S, C = (8, 8, 2000, 128) if fp32 else (8, 20, 3100, 512)
    q, k, v, bias = cross_inputs(B, Lq, S, C, gen, device, dtype)
    scale = (C // 8) ** -0.5
    return (lambda: ca.cross_attention_op(q, k, v, bias, 0, scale, 0.0, 8),
            lambda: ca.cross_attention_fwd(q, k, v, bias, 0, scale, 0.0, 8), ca.BY_DTYPE[dtype][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("route", SERVING_OP_ROUTES)
def test_serving_operator_equals_a_direct_launch(cuda, route, dtype):
    """Each registered operator's CUDA implementation is its hand-written
    kernel: bit-equal to a direct launch, one launch on its counter."""
    op, direct, kernel = _serving_op_case(route, dtype, cuda)
    before = kernel.launches
    got = op()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = direct()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_serving_operators_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 1, 8, 24, device=cuda)   # head dim 24 has no kernel
    with pytest.raises(ValueError, match="head dim"):
        att.flash_attention_op(q, q, q, None, 0.2)


def test_depth_dequantization_on_the_card_equals_the_cpu(cuda):
    """``u * scale + lo`` is one fused multiply-add on both devices."""
    from r3d_tpu_torch.serving import dequantize_depth

    g = torch.Generator().manual_seed(5)
    u = torch.randint(0, 256, (4, 300, 16, 12), generator=g, dtype=torch.uint8)
    qp = torch.stack([torch.rand(4, generator=g) * 3 - 1, torch.rand(4, generator=g) / 50], 1)
    for dtype in (torch.float32, torch.bfloat16):
        want = dequantize_depth(u, qp, dtype)
        got = dequantize_depth(u.to(cuda), qp.to(cuda), dtype).cpu()
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["int8", "uint8", "int8+uint8"])
def test_quantized_sessions_on_the_card_match_the_cpu(cuda, kind):
    """utkinects at full width from a seeded init: one 512-bucket chunk of
    the quantized or uint8 session on the card against the same session on
    the CPU (``E2E_TOL``: the bf16 embeds' roundings); the int8 weights and
    scales live on the card."""
    from chip_smoke import E2E_TOL, N_CLASS, make_videos
    from r3d_tpu_torch.config import get_config
    from r3d_tpu_torch.models import build_model, init_weights
    from r3d_tpu_torch.serving import InferenceSession

    kw = {"int8": dict(quantize="int8"), "uint8": dict(input_dtype="uint8"),
          "int8+uint8": dict(quantize="int8", input_dtype="uint8")}[kind]
    cfg = get_config("utkinects")
    sd = init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                      torch.Generator().manual_seed(3)).state_dict()
    card = InferenceSession(cfg, sd, N_CLASS, max_batch=4, **kw)
    cpu = InferenceSession(cfg, sd, N_CLASS, max_batch=4, device="cpu", **kw)
    if "quantize" in kw:
        assert all(t.device.type == "cuda" for v in card.weights.values() if isinstance(v, tuple)
                   for t in v)
    batch = card._collate(make_videos(np.random.default_rng(3), (512, 300, 400), cfg), 512)
    got, want = card._run(*batch), cpu._run(*batch)
    for key in ("action", "duration", "seg"):
        assert torch.isfinite(got[key]).all()
        assert float((got[key].float().cpu() - want[key]).abs().max()) <= E2E_TOL, key
