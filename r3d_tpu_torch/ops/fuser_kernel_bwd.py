"""Backward of the SA-Fuser tail: dr, dd and the 12 parameter gradients.

Counterpart of ``r3d_tpu/ops/fuser_kernel_bwd.py`` (``pallas_tail_bwd``).
``fused_tail_bwd`` launches the kernel of ``csrc/fuser_tail_bwd.cu``, which
recomputes the forward per tile of rows and sums the parameter gradients
deterministically: a fixed number of blocks (at most one per SM) each add
into their own slice of a scratch [G, P], and a second kernel sums the
slices in order. Both launches count as one launch of the kernel.

``composed_tail_bwd`` is the plain version: ``torch.autograd.grad`` through
``composed_tail``, independent of the kernel's hand derivation (the JAX
fallback, ``fuser_kernel.py:303-306``). The wrapper takes it for CPU tensors
only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from r3d_tpu_torch.ops.build import Kernel
from r3d_tpu_torch.ops.fuser_kernel import FuserTailParams, check_kernel_inputs, composed_tail

KERNEL = Kernel(
    "fused_tail_bwd", "fuser_tail_bwd.cu", "r3d_fuser_tail_bwd",
    [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
TILE_ROWS = 16   # csrc/fuser_tail_bwd.cu: TM


def composed_tail_bwd(r, d, g, params: FuserTailParams, outer_residual: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, FuserTailParams]:
    """Plain backward: autograd of ``composed_tail``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (r, d, *params)]
        out = composed_tail(leaves[0], leaves[1], FuserTailParams(*leaves[2:]),
                            outer_residual)
        grads = torch.autograd.grad(out, leaves, g)
    return grads[0], grads[1], FuserTailParams(*grads[2:])


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
    n_tiles = -(-N // TILE_ROWS)
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    n_blocks = max(1, min(n_tiles, sms))
    dr = torch.empty_like(r)
    dd = torch.empty_like(d)
    partial = torch.empty(n_blocks * P, dtype=torch.float32, device=r.device)
    flat = torch.empty(P, dtype=torch.float32, device=r.device)
    KERNEL.launch(
        r.data_ptr(), d.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in params),
        dr.data_ptr(), dd.data_ptr(), partial.data_ptr(), flat.data_ptr(),
        N, C, Ch, n_blocks, int(outer_residual),
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    grads = FuserTailParams(*(flat[off:off + torch.Size(s).numel()].view(s)
                              for off, s in layout))
    return dr, dd, grads
