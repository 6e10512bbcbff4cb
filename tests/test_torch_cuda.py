"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA device. On a CUDA
host (which need not have JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

TF32 is off for the plain versions. Tolerances: 1e-4 for the fuser tail
(fp32 sums of up to 512 terms in another order), 2e-5 for attention (fp32
online vs two-pass softmax).
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
