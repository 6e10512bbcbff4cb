"""Fused CMFuser forward: BN-affine + bottom-k alpha blend + SA-Fuser tail.

Counterpart of ``r3d_tpu/ops/fuser_kernel.py``. ``fused_bn_blend_tail`` is
the whole BN token fuser of ``futr_fusion_bn`` in one kernel
(``csrc/fuser_tail.cu``):

    rn, dn = r*scale_r + shift_r, d*scale_d + shift_d     (folded BN)
    x_r = mask_r*(a*rn + (1-a)*dn) + (1-mask_r)*rn        (and the mirror)
    x_r += LN1(x_d) @ Wvp^T + b      x_d += LN1(x_r) @ Wvp^T + b
    x_* += W2 GELU(W1 LN2(x_*) + b1) + b2
    out = (LN_out(x_r) + LN_out(x_d)) / 2

The exact two-token attention is a value swap with ``Wvp = W_proj @ W_v``
prefolded (``models/fuser.py``). The matrices are in torch's ``[out, in]``
layout, as the module's ``nn.Linear`` layers hold them. Only the route that
``CMFuserBN`` takes is ported: no outer residual (``CMFuserGrad``) and no
backward (training is a later slice).

``composed_bn_blend`` and ``composed_tail`` are the plain PyTorch version.
The wrapper takes it for CPU tensors only; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from r3d_tpu_torch.ops.build import Kernel


class BlendParams(NamedTuple):
    """Folded BN affine (scale = gamma*rsqrt(var+eps), shift = beta -
    mean*scale) and the bottom-k blend: masks are float 0/1. All [C] fp32."""

    scale_r: torch.Tensor
    shift_r: torch.Tensor
    scale_d: torch.Tensor
    shift_d: torch.Tensor
    mask_r: torch.Tensor
    mask_d: torch.Tensor
    alpha: torch.Tensor


class FuserTailParams(NamedTuple):
    norm1_scale: torch.Tensor   # [C]
    norm1_bias: torch.Tensor
    wvp: torch.Tensor           # [C, C] = W_proj @ W_v, [out, in]
    proj_bias: torch.Tensor     # [C]
    norm2_scale: torch.Tensor
    norm2_bias: torch.Tensor
    mlp1_weight: torch.Tensor   # [Ch, C], [out, in]
    mlp1_bias: torch.Tensor     # [Ch]
    mlp2_weight: torch.Tensor   # [C, Ch], [out, in]
    mlp2_bias: torch.Tensor     # [C]
    norm_out_scale: torch.Tensor
    norm_out_bias: torch.Tensor


def _ln(x, scale, bias, eps=1e-5):
    """LayerNorm with fp32 statistics and biased variance."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def composed_bn_blend(r_raw, d_raw, blend: BlendParams):
    """Plain BN-affine + alpha-blend prologue."""
    rn = r_raw * blend.scale_r + blend.shift_r
    dn = d_raw * blend.scale_d + blend.shift_d
    a, mr, md = blend.alpha, blend.mask_r, blend.mask_d
    ex_r = mr * (a * rn + (1 - a) * dn) + (1 - mr) * rn
    ex_d = md * (a * dn + (1 - a) * rn) + (1 - md) * dn
    return ex_r, ex_d


def composed_tail(r, d, p: FuserTailParams):
    """Plain SA-Fuser tail on two blended [N, C] streams."""
    h_r = _ln(r, p.norm1_scale, p.norm1_bias)
    h_d = _ln(d, p.norm1_scale, p.norm1_bias)
    x_r = r + F.linear(h_d, p.wvp) + p.proj_bias
    x_d = d + F.linear(h_r, p.wvp) + p.proj_bias

    def mlp(x):
        h = _ln(x, p.norm2_scale, p.norm2_bias)
        m = F.gelu(F.linear(h, p.mlp1_weight, p.mlp1_bias), approximate="none")
        return F.linear(m, p.mlp2_weight, p.mlp2_bias)

    x_r = x_r + mlp(x_r)
    x_d = x_d + mlp(x_d)
    return 0.5 * (_ln(x_r, p.norm_out_scale, p.norm_out_bias)
                  + _ln(x_d, p.norm_out_scale, p.norm_out_bias))


KERNEL = Kernel(
    "fused_bn_blend_tail", "fuser_tail.cu", "r3d_fused_bn_blend_tail",
    [ctypes.c_void_p] * 22 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)
KERNEL_CHANNELS = 128   # csrc/fuser_tail.cu: C
KERNEL_HIDDEN_CHUNK = 128


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"fused_bn_blend_tail: {name} must be a contiguous "
                         f"float32 tensor on {device}, got {t.dtype} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_bn_blend_tail: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"fused_bn_blend_tail: {name} is not 16-byte aligned")


def fused_bn_blend_tail(r_raw: torch.Tensor, d_raw: torch.Tensor,
                        blend: BlendParams, params: FuserTailParams) -> torch.Tensor:
    """Raw [N, C] rgb and depth streams -> fused [N, C] (the whole CMFuser
    forward). CPU tensors take the plain version; CUDA tensors the kernel."""
    if r_raw.device.type == "cpu":
        return composed_tail(*composed_bn_blend(r_raw, d_raw, blend), params)
    if r_raw.device.type != "cuda":
        raise ValueError(f"fused_bn_blend_tail: no kernel for {r_raw.device}")
    N, C = r_raw.shape
    Ch = params.mlp1_weight.shape[0]
    if C != KERNEL_CHANNELS or Ch % KERNEL_HIDDEN_CHUNK:
        raise ValueError(f"fused_bn_blend_tail: the kernel takes C == "
                         f"{KERNEL_CHANNELS} and a hidden width that is a "
                         f"multiple of {KERNEL_HIDDEN_CHUNK}; got C={C}, Ch={Ch}")
    dev = r_raw.device
    _check("r_raw", r_raw, (N, C), dev)
    _check("d_raw", d_raw, (N, C), dev)
    for name, t in blend._asdict().items():
        _check(name, t, (C,), dev)
    shapes = {"wvp": (C, C), "mlp1_weight": (Ch, C), "mlp1_bias": (Ch,),
              "mlp2_weight": (C, Ch)}
    for name, t in params._asdict().items():
        _check(name, t, shapes.get(name, (C,)), dev)
    out = torch.empty_like(r_raw)
    KERNEL.launch(
        r_raw.data_ptr(), d_raw.data_ptr(),
        *(t.data_ptr() for t in blend), *(t.data_ptr() for t in params),
        out.data_ptr(), N, C, Ch, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out
