"""Fused CMFuser forward: BN-affine + bottom-k alpha blend + SA-Fuser tail.

Counterpart of ``r3d_tpu/ops/fuser_kernel.py``. One kernel
(``csrc/fuser_tail.cu``) computes the SA-Fuser tail on two [N, C] streams,
with or without the BN-blend prologue and with an optional outer residual:

    rn, dn = r*scale_r + shift_r, d*scale_d + shift_d     (folded BN; blend route)
    x_r = mask_r*(a*rn + (1-a)*dn) + (1-mask_r)*rn        (and the mirror)
    x_r += LN1(x_d) @ Wvp^T + b      x_d += LN1(x_r) @ Wvp^T + b
    x_* += W2 GELU(W1 LN2(x_*) + b1) + b2
    x_* += input                                          (outer residual)
    out = (LN_out(x_r) + LN_out(x_d)) / 2

The exact two-token attention is a value swap with ``Wvp = W_proj @ W_v``
prefolded (``models/fuser.py``). The matrices are in torch's ``[out, in]``
layout, as the module's ``nn.Linear`` layers hold them.

- ``fused_bn_blend_tail`` (blend route; serving, validation, the sticky
  training epochs): kernel forward, and as in JAX (``_bwd_bn``) a backward
  that re-runs the plain blend and tail under autograd.
- ``fused_safuser_tail`` (no-blend route; training epoch 0, after the
  composed blend and dropout): kernel forward, and the backward kernel of
  ``ops/fuser_kernel_bwd.py``.

``composed_bn_blend`` and ``composed_tail`` are the plain PyTorch version.
The wrappers take it for CPU tensors only; for a CUDA tensor they launch the
kernel or raise.

Without gradients (serving, validation) both wrappers call the forward as a
registered operator (``torch.ops.r3d_tpu_torch.fused_bn_blend_tail`` and
``fused_safuser_tail``), so that ``torch.export`` records it in a program
(``serving.InferenceSession.export``): its CPU implementation is the plain
version, its CUDA implementation the kernel, and its fake implementation
gives the output's shape and dtype and launches nothing. A launch is counted
where the kernel runs, never where a program is traced.

The streams are fp32 or bf16; the parameters and blend vectors stay fp32,
as JAX passes them. In bf16 the kernel computes in the stream's dtype at the
rounding points of the Pallas kernel (``r3d_tpu/ops/fuser_kernel.py:180-223``):
each elementwise op of the blend prologue and the residuals rounds to bf16;
LayerNorm keeps fp32 statistics, scale and bias and rounds its output; each
product takes bf16 operands, sums in fp32 and rounds once, and its bias is
added in bf16; the GELU is the fp32 erf form, rounded; the output is the two
rounded output LayerNorms widened, averaged and rounded. The fp32 and bf16
instantiations count their launches on counters of their own.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from r3d_tpu_torch.ops.build import Kernel, check_device


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
    """Plain BN-affine + alpha-blend prologue in the streams' dtype (each op
    rounds to it; the vectors are cast first, as JAX's ``_kernel`` does)."""
    dt = r_raw.dtype
    rn = r_raw * blend.scale_r.to(dt) + blend.shift_r.to(dt)
    dn = d_raw * blend.scale_d.to(dt) + blend.shift_d.to(dt)
    a, mr, md = (t.to(dt) for t in (blend.alpha, blend.mask_r, blend.mask_d))
    ex_r = mr * (a * rn + (1 - a) * dn) + (1 - mr) * rn
    ex_d = md * (a * dn + (1 - a) * rn) + (1 - md) * dn
    return ex_r, ex_d


def linear_in_dtype(x, weight, bias=None):
    """``x W^T + b`` in x's dtype: in bf16 the operands are bf16, the sums
    fp32, the product rounded once and the bias added in bf16 (JAX's
    ``preferred_element_type=f32`` then ``astype``)."""
    if x.dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.float(), weight.to(x.dtype).float()).to(x.dtype)
    return y if bias is None else y + bias.to(x.dtype)


def composed_tail(r, d, p: FuserTailParams, outer_residual: bool = False):
    """Plain SA-Fuser tail on two blended [N, C] streams, in their dtype."""
    dt = r.dtype
    ln = lambda x, scale, bias: _ln(x, scale, bias).to(dt)
    h_r = ln(r, p.norm1_scale, p.norm1_bias)
    h_d = ln(d, p.norm1_scale, p.norm1_bias)
    x_r = r + linear_in_dtype(h_d, p.wvp) + p.proj_bias.to(dt)
    x_d = d + linear_in_dtype(h_r, p.wvp) + p.proj_bias.to(dt)

    def mlp(x):
        h = ln(x, p.norm2_scale, p.norm2_bias)
        m = linear_in_dtype(h, p.mlp1_weight, p.mlp1_bias)
        m = F.gelu(m.float(), approximate="none").to(dt)
        return linear_in_dtype(m, p.mlp2_weight, p.mlp2_bias)

    x_r = x_r + mlp(x_r)
    x_d = x_d + mlp(x_d)
    if outer_residual:
        x_r = x_r + r
        x_d = x_d + d
    return (0.5 * (ln(x_r, p.norm_out_scale, p.norm_out_bias).float()
                   + ln(x_d, p.norm_out_scale, p.norm_out_bias).float())).to(dt)


KERNEL = Kernel(
    "fused_bn_blend_tail", "fuser_tail.cu", "r3d_fused_bn_blend_tail",
    [ctypes.c_void_p] * 22 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
TAIL_KERNEL = Kernel(
    "fused_safuser_tail", "fuser_tail.cu", "r3d_fused_safuser_tail",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
TAIL_KERNEL_OUTER = Kernel(   # TAIL_KERNEL's calls with the outer residual, counted apart
    "fused_safuser_tail_outer", TAIL_KERNEL.source, TAIL_KERNEL.symbol, TAIL_KERNEL.argtypes)
# the bf16 instantiations: bf16 streams and output, fp32 parameters
KERNEL_BF16 = Kernel(
    "fused_bn_blend_tail_bf16", "fuser_tail.cu", "r3d_fused_bn_blend_tail_bf16", KERNEL.argtypes)
TAIL_KERNEL_BF16 = Kernel(
    "fused_safuser_tail_bf16", "fuser_tail.cu", "r3d_fused_safuser_tail_bf16",
    TAIL_KERNEL.argtypes)
TAIL_KERNEL_BF16_OUTER = Kernel(
    "fused_safuser_tail_bf16_outer", TAIL_KERNEL_BF16.source, TAIL_KERNEL_BF16.symbol,
    TAIL_KERNEL.argtypes)
KERNEL_CHANNELS = 128   # csrc/fuser_tail.cu: C
KERNEL_HIDDEN_CHUNK = 128
STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _check(fn, name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def check_kernel_inputs(fn, streams, params: FuserTailParams, blend=None):
    """Raise unless the CUDA kernels take these tensors: ``streams`` a dict
    of [N, C] tensors of one dtype, fp32 or bf16, C == 128 and a hidden
    width that is a multiple of 128, the parameters and blend vectors fp32,
    everything contiguous on one device. Returns (N, C, Ch)."""
    first = next(iter(streams.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {first.device}")
    if first.dtype not in STREAM_DTYPES:
        raise ValueError(f"{fn}: no kernel for {first.dtype} streams (float32 or bfloat16)")
    N, C = first.shape
    Ch = params.mlp1_weight.shape[0]
    if C != KERNEL_CHANNELS or Ch % KERNEL_HIDDEN_CHUNK:
        raise ValueError(f"{fn}: the kernel takes C == {KERNEL_CHANNELS} and a "
                         f"hidden width that is a multiple of "
                         f"{KERNEL_HIDDEN_CHUNK}; got C={C}, Ch={Ch}")
    dev = first.device
    for name, t in streams.items():
        _check(fn, name, t, (N, C), dev, first.dtype)
    for name, t in ({} if blend is None else blend._asdict()).items():
        _check(fn, name, t, (C,), dev)
    shapes = {"wvp": (C, C), "mlp1_weight": (Ch, C), "mlp1_bias": (Ch,),
              "mlp2_weight": (C, Ch)}
    for name, t in params._asdict().items():
        _check(fn, name, t, shapes.get(name, (C,)), dev)
    return N, C, Ch


def _bn_blend_tail_fwd(r_raw, d_raw, blend, params, outer_residual):
    if r_raw.device.type == "cpu":
        return composed_tail(*composed_bn_blend(r_raw, d_raw, blend), params, outer_residual)
    N, C, Ch = check_kernel_inputs("fused_bn_blend_tail", {"r_raw": r_raw, "d_raw": d_raw},
                                   params, blend)
    out = torch.empty_like(r_raw)
    (KERNEL if r_raw.dtype == torch.float32 else KERNEL_BF16).launch(
        r_raw.data_ptr(), d_raw.data_ptr(),
        *(t.data_ptr() for t in blend), *(t.data_ptr() for t in params),
        out.data_ptr(), N, C, Ch, int(outer_residual),
        torch.cuda.current_stream(r_raw.device).cuda_stream,
    )
    return out


def _safuser_tail_fwd(r, d, params, outer_residual):
    if r.device.type == "cpu":
        return composed_tail(r, d, params, outer_residual)
    N, C, Ch = check_kernel_inputs("fused_safuser_tail", {"r": r, "d": d}, params)
    out = torch.empty_like(r)
    if r.dtype == torch.float32:
        kernel = TAIL_KERNEL_OUTER if outer_residual else TAIL_KERNEL
    else:
        kernel = TAIL_KERNEL_BF16_OUTER if outer_residual else TAIL_KERNEL_BF16
    kernel.launch(
        r.data_ptr(), d.data_ptr(), *(t.data_ptr() for t in params),
        out.data_ptr(), N, C, Ch, int(outer_residual),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    return out


class _BnBlendTail(torch.autograd.Function):
    """Kernel forward; backward = autograd of the plain blend + tail, re-run
    (JAX ``_bwd_bn``: no Pallas backward exists for this route)."""

    @staticmethod
    def forward(ctx, outer_residual, r_raw, d_raw, *tensors):
        ctx.outer_residual = outer_residual
        ctx.save_for_backward(r_raw, d_raw, *tensors)
        return _bn_blend_tail_fwd(r_raw, d_raw, BlendParams(*tensors[:7]),
                                  FuserTailParams(*tensors[7:]), outer_residual)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            r_raw, d_raw, *tensors = leaves
            out = composed_tail(
                *composed_bn_blend(r_raw, d_raw, BlendParams(*tensors[:7])),
                FuserTailParams(*tensors[7:]), ctx.outer_residual)
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return (None, *grads)


class _SAFuserTail(torch.autograd.Function):
    """Kernel forward; backward kernel (``fuser_kernel_bwd.fused_tail_bwd``)."""

    @staticmethod
    def forward(ctx, outer_residual, r, d, *params):
        ctx.outer_residual = outer_residual
        ctx.save_for_backward(r, d, *params)
        return _safuser_tail_fwd(r, d, FuserTailParams(*params), outer_residual)

    @staticmethod
    def backward(ctx, g):
        from r3d_tpu_torch.ops.fuser_kernel_bwd import fused_tail_bwd

        r, d, *params = ctx.saved_tensors
        dr, dd, dparams = fused_tail_bwd(r, d, g.contiguous(), FuserTailParams(*params),
                                         ctx.outer_residual)
        return (None, dr, dd, *dparams)


def _needs_graph(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


@torch.library.custom_op("r3d_tpu_torch::fused_bn_blend_tail", mutates_args=(),
                         device_types=("cpu", "cuda"))
def bn_blend_tail_op(r_raw: torch.Tensor, d_raw: torch.Tensor, blend: List[torch.Tensor],
                     params: List[torch.Tensor], outer_residual: bool) -> torch.Tensor:
    """K1's blend route as an operator: the plain version on the CPU, the
    kernel on the card."""
    return _bn_blend_tail_fwd(r_raw, d_raw, BlendParams(*blend), FuserTailParams(*params),
                              outer_residual)


@bn_blend_tail_op.register_fake
def _(r_raw, d_raw, blend, params, outer_residual):
    return torch.empty_like(r_raw)


@torch.library.custom_op("r3d_tpu_torch::fused_safuser_tail", mutates_args=(),
                         device_types=("cpu", "cuda"))
def safuser_tail_op(r: torch.Tensor, d: torch.Tensor, params: List[torch.Tensor],
                    outer_residual: bool) -> torch.Tensor:
    """K1's no-blend route as an operator: the plain version on the CPU, the
    kernel on the card."""
    return _safuser_tail_fwd(r, d, FuserTailParams(*params), outer_residual)


@safuser_tail_op.register_fake
def _(r, d, params, outer_residual):
    return torch.empty_like(r)


def fused_bn_blend_tail(r_raw: torch.Tensor, d_raw: torch.Tensor, blend: BlendParams,
                        params: FuserTailParams, outer_residual: bool = False) -> torch.Tensor:
    """Raw [N, C] rgb and depth streams -> fused [N, C] (the whole CMFuser
    forward). CPU tensors take the plain version; CUDA tensors the kernel.
    Differentiable in every tensor argument."""
    tensors = (r_raw, d_raw, *blend, *params)
    if _needs_graph(tensors):
        return _BnBlendTail.apply(outer_residual, *tensors)
    check_device("fused_bn_blend_tail", r_raw)
    return bn_blend_tail_op(r_raw, d_raw, list(blend), list(params), outer_residual)


def fused_safuser_tail(r: torch.Tensor, d: torch.Tensor, params: FuserTailParams,
                       outer_residual: bool = False) -> torch.Tensor:
    """Blended [N, C] streams -> fused [N, C] (the tail alone). CPU tensors
    take the plain version; CUDA tensors the forward and backward kernels."""
    tensors = (r, d, *params)
    if _needs_graph(tensors):
        return _SAFuserTail.apply(outer_residual, *tensors)
    check_device("fused_safuser_tail", r)
    return safuser_tail_op(r, d, list(params), outer_residual)
