"""Backward of the SA-Fuser tail: dr, dd and the 12 parameter gradients.

Counterpart of ``r3d_tpu/ops/fuser_kernel_bwd.py`` (``pallas_tail_bwd``).
``fused_tail_bwd`` launches the kernels of ``csrc/fuser_tail_bwd.cu`` in
two phases, every product on 3xTF32 tensor cores. A row phase, one block
per tile of ``tile_rows`` token rows, recomputes the forward (the
up-projection once), runs the backward to dr and dd, and leaves the
operands of the weight gradients in a scratch of token rows and each
tile's column sums (the vector gradients) in a row of their own. A
weight-gradient phase computes dW2, dW1 and dWvp as 128 x 128 output tiles
times splits of ``split_rows`` rows, and an ordered pass sums the splits'
partials and the tiles' column sums in order, so two calls agree bit for
bit. ``bwd_plan`` sizes both phases for the card; the scratch (about 60 MB
at N = 8 x 512) comes from torch's caching allocator. The call's four
launches (with the weights' transpose) count as one launch of the kernel.

``composed_tail_bwd`` is the plain version: ``torch.autograd.grad`` through
``composed_tail``, independent of the kernel's hand derivation (the JAX
fallback, ``fuser_kernel.py:303-306``). The wrapper takes it for CPU tensors
only; for a CUDA tensor it launches the kernel or raises.

bf16 streams (the fusion models in bf16): the kernel reads bf16 r, d and g,
computes in fp32 and writes bf16 dr and dd, as JAX's ``_bwd_kernel`` does
(``r3d_tpu/ops/fuser_kernel_bwd.py:70-165``); the parameter gradients stay
fp32. Its calls count on ``KERNEL_BF16`` and ``KERNEL_BF16_OUTER``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from r3d_tpu_torch.ops.build import Kernel
from r3d_tpu_torch.ops.fuser_kernel import FuserTailParams, check_kernel_inputs, composed_tail

KERNEL = Kernel(
    "fused_tail_bwd", "fuser_tail_bwd.cu", "r3d_fuser_tail_bwd",
    [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_OUTER = Kernel(   # KERNEL's calls with the outer residual, counted apart
    "fused_tail_bwd_outer", KERNEL.source, KERNEL.symbol, KERNEL.argtypes)
# bf16 r, d, g in and dr, dd out; fp32 inside and for the parameter gradients
KERNEL_BF16 = Kernel(
    "fused_tail_bwd_bf16", KERNEL.source, "r3d_fuser_tail_bwd_bf16", KERNEL.argtypes)
KERNEL_BF16_OUTER = Kernel(
    "fused_tail_bwd_bf16_outer", KERNEL.source, KERNEL_BF16.symbol, KERNEL.argtypes)
SPLIT_UNIT = 32    # csrc/fuser_tail_bwd.cu: WK, token rows of one chunk of the weight gradients
OUT_TILE = 128     # csrc/fuser_tail_bwd.cu: C x C, an output tile of the weight gradients


class BwdPlan(NamedTuple):
    """The launch shape of K2 at N rows: token rows a block of the row
    phase takes (r's and d's), its blocks, the scratch's token rows, rows of
    a split of the weight-gradient phase and its splits."""
    tile_rows: int
    n_tiles: int
    rows: int
    split_rows: int
    n_split: int


def bwd_plan(N: int, Ch: int, sms: int) -> BwdPlan:
    """64 token rows a block where that still gives nine SMs in ten a block
    (as K1, ``csrc/fuser_tail.cu:tile_rows``), else 32; the weight gradients'
    2 Ch/128 + 1 output tiles times as many splits of whole 32-row chunks as
    fill the card's SMs once (14 splits of 608 rows at N = 8 x 512)."""
    T = 64 if 10 * -(-N // 32) >= 9 * sms else 32
    n_tiles = -(-N // (T // 2))
    R = n_tiles * T
    target = max(1, sms // (2 * Ch // OUT_TILE + 1))
    split_rows = SPLIT_UNIT * max(1, -(-R // (SPLIT_UNIT * target)))
    return BwdPlan(T, n_tiles, R, split_rows, -(-R // split_rows) if R else 1)


def scratch_floats(C: int, Ch: int, plan: BwdPlan) -> int:
    """Floats of the kernel's scratch (``r3d_fuser_tail_bwd``): the
    transposed weights, p and dz [R, Ch], dm, u, dx and the swapped h1
    [R, C], the column sums [tiles, 2 halves, 8C + Ch], the partials
    [splits, out tiles, C, C]."""
    return (2 * Ch * C + C * C + plan.rows * (2 * Ch + 4 * C) + plan.n_tiles * 2 * (8 * C + Ch)
            + plan.n_split * (2 * Ch // OUT_TILE + 1) * OUT_TILE * OUT_TILE)


def composed_tail_bwd(r, d, g, params: FuserTailParams, outer_residual: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, FuserTailParams]:
    """Plain backward: autograd of ``composed_tail`` in fp32. bf16 streams
    and cotangent are widened first and dr, dd rounded back, as JAX's kernel
    computes in fp32 whatever the streams' dtype; the parameter gradients
    stay fp32."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (r, d)]
        leaves += [t.detach().requires_grad_() for t in params]
        out = composed_tail(leaves[0], leaves[1], FuserTailParams(*leaves[2:]),
                            outer_residual)
        grads = torch.autograd.grad(out, leaves, g.float())
    return grads[0].to(r.dtype), grads[1].to(d.dtype), FuserTailParams(*grads[2:])


def grad_layout(C: int, Ch: int):
    """(offset, shape) of each gradient in the kernel's flat output, in
    FuserTailParams order."""
    shapes = {"wvp": (C, C), "mlp1_weight": (Ch, C), "mlp1_bias": (Ch,),
              "mlp2_weight": (C, Ch)}
    out, off = [], 0
    for name in FuserTailParams._fields:
        shape = shapes.get(name, (C,))
        out.append((off, shape))
        off += int(torch.Size(shape).numel())
    return out, off


def fused_tail_bwd(r: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                   params: FuserTailParams, outer_residual: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, FuserTailParams]:
    """(dr, dd, FuserTailParams of gradients) of ``composed_tail(r, d,
    params, outer_residual)`` under the output cotangent ``g`` [N, C].
    Gradients of matrices are in torch's [out, in] layout."""
    if r.device.type == "cpu":
        return composed_tail_bwd(r, d, g, params, outer_residual)
    N, C, Ch = check_kernel_inputs("fused_tail_bwd", {"r": r, "d": d, "g": g}, params)
    layout, P = grad_layout(C, Ch)
    plan = bwd_plan(N, Ch, torch.cuda.get_device_properties(r.device).multi_processor_count)
    dr = torch.empty_like(r)
    dd = torch.empty_like(d)
    scratch = torch.empty(scratch_floats(C, Ch, plan), dtype=torch.float32, device=r.device)
    flat = torch.empty(P, dtype=torch.float32, device=r.device)
    if r.dtype == torch.float32:
        kernel = KERNEL_OUTER if outer_residual else KERNEL
    else:
        kernel = KERNEL_BF16_OUTER if outer_residual else KERNEL_BF16
    kernel.launch(
        r.data_ptr(), d.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in params),
        dr.data_ptr(), dd.data_ptr(), scratch.data_ptr(), flat.data_ptr(),
        N, C, Ch, plan.tile_rows, plan.split_rows, int(outer_residual),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    grads = FuserTailParams(*(flat[off:off + torch.Size(s).numel()].view(s)
                              for off, s in layout))
    return dr, dd, grads
