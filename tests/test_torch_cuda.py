"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA device. On a CUDA
host (which need not have JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

TF32 is off for the plain versions. Tolerances: 1e-4 for the fuser tail
(fp32 sums of up to 512 terms in another order), 2e-5 for attention (fp32
online vs two-pass softmax); gradients summed over rows are held to the same
figures relative to their largest entry.
"""

import math

import pytest
import torch

from chip_smoke import attention_inputs, fuser_inputs
from r3d_tpu_torch.ops import attention as att
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


@pytest.mark.parametrize("N", [1, 15, 16, 2048, 2053, 4096])
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

def _close(got, want, rel, name=""):
    """|got - want| <= rel * max|want| (+ a floor for all-zero tensors):
    the kernels sum in another order than the plain versions, and gradients
    summed over thousands of rows grow with the row count."""
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all(), name
    assert err <= rel * scale, f"{name}: max|diff| {err:.3e} > {rel} * {scale:.3e}"


@pytest.mark.parametrize("outer", [False, True], ids=["plain-tail", "outer-residual"])
@pytest.mark.parametrize("N", [1, 16, 2053, 4096])
def test_fused_safuser_tail_kernel_matches_plain(cuda, N, outer):
    gen = torch.Generator().manual_seed(N)
    r, d, blend, params = fuser_inputs(N, gen, cuda)
    before = fk.TAIL_KERNEL.launches
    got = fk.fused_safuser_tail(r, d, params, outer)
    torch.cuda.synchronize()
    assert fk.TAIL_KERNEL.launches == before + 1
    torch.testing.assert_close(got, fk.composed_tail(r, d, params, outer), atol=1e-4, rtol=0)
    got = fk.fused_bn_blend_tail(r, d, blend, params, outer)
    want = fk.composed_tail(*fk.composed_bn_blend(r, d, blend), params, outer)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("outer", [False, True], ids=["plain-tail", "outer-residual"])
@pytest.mark.parametrize("N", [1, 16, 2053, 4096])
def test_fused_tail_bwd_kernel_matches_plain(cuda, N, outer):
    from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

    gen = torch.Generator().manual_seed(N + 1)
    r, d, _, params = fuser_inputs(N, gen, cuda)
    g = torch.randn(N, 128, generator=gen).to(cuda)
    before = fkb.KERNEL.launches
    dr, dd, dp = fkb.fused_tail_bwd(r, d, g, params, outer)
    torch.cuda.synchronize()
    assert fkb.KERNEL.launches == before + 1
    wr, wd, wp = fkb.composed_tail_bwd(r, d, g, params, outer)
    _close(dr, wr, 1e-4, "dr")
    _close(dd, wd, 1e-4, "dd")
    for name, a, b in zip(fk.FuserTailParams._fields, dp, wp):
        _close(a, b, 1e-4, name)


@pytest.mark.parametrize("Lk", [1, 31, 256, 300, 512])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_dropout_kernel_matches_plain(cuda, Lk, D):
    gen = torch.Generator().manual_seed(Lk * D)
    q, k, v, bias = attention_inputs(8, 8, 8, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    scale = 1.0 / math.sqrt(D)
    before = att.DROPOUT_KERNEL.launches
    got = att.flash_attention_dropout(q, k, v, bias, 1234 + Lk, scale, 0.1)
    torch.cuda.synchronize()
    assert att.DROPOUT_KERNEL.launches == before + 1
    want = att.composed_attention_dropout(q, k, v, bias, 1234 + Lk, scale, 0.1)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lk", [1, 31, 256, 300, 512, 1024])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_bwd_kernel_matches_plain(cuda, Lk, D, rate):
    gen = torch.Generator().manual_seed(Lk + D)
    q, k, v, bias = attention_inputs(8, 8, 8, Lk, D, gen, cuda, all_masked_row=Lk > 1)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    scale = 1.0 / math.sqrt(D)
    before = att.BWD_KERNEL.launches
    got = att.attention_bwd(q, k, v, bias, 77, scale, rate, g, need_dbias=True)
    torch.cuda.synchronize()
    assert att.BWD_KERNEL.launches == before + 1
    want = att.composed_attention_bwd(q, k, v, bias, 77, scale, rate, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(a, b, 2e-5, name)


def test_attention_bwd_kernel_takes_many_query_tiles(cuda):
    gen = torch.Generator().manual_seed(5)
    q, k, v, bias = attention_inputs(2, 2, 300, 300, 32, gen, cuda)
    g = torch.randn(q.shape, generator=gen).to(cuda)
    got = att.attention_bwd(q, k, v, bias, 3, 0.2, 0.1, g, need_dbias=True)
    want = att.composed_attention_bwd(q, k, v, bias, 3, 0.2, 0.1, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(a, b, 2e-5, name)


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
