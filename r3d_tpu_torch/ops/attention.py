"""Attention forward kernel for the decoder cross-attention.

Counterpart of ``r3d_tpu/ops/attention.py`` (forward only). The kernel
(``csrc/attention.cu``) computes ``softmax(q k^T * scale + bias) v`` with an
fp32 online softmax, one block per (batch*head, tile of 8 queries), and
masks its own ragged key edge. ``composed_attention`` is the plain PyTorch
version; the wrapper takes it for CPU tensors only, and for a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from r3d_tpu_torch.ops.build import Kernel

KERNEL = Kernel(
    "flash_attention", "attention.cu", "r3d_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
)
KERNEL_HEAD_DIMS = (16, 32, 64)   # csrc/attention.cu: instantiated D


def composed_attention(q, k, v, bias, scale):
    """Plain attention: q, k, v [B, H, L, D]; bias [B, 1, 1, Lk] additive."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def flash_attention(q, k, v, bias, scale: float) -> torch.Tensor:
    """[B, H, Lq, D] attention over [B, H, Lk, D] keys and values with an
    optional key-padding bias [B, 1, 1, Lk]. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return composed_attention(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {KERNEL_HEAD_DIMS}")
    want = {"q": (B, H, Lq, D), "k": (B, H, Lk, D), "v": (B, H, Lk, D)}
    if bias is not None:
        want["bias"] = (B, 1, 1, Lk)
    for name, shape in want.items():
        t = {"q": q, "k": k, "v": v, "bias": bias}[name]
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"float32 tensor on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, H, Lq, Lk, D, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def attention_kernel_eligible(Lq: int, Lk: int, D: int, device: torch.device) -> bool:
    """The JAX package's routing rule (``r3d_tpu/ops/attention.py:461-466``),
    with "on the card" in place of ``pallas_enabled()``: the kernel when the
    key side is at least 256 long, for cross-attention only up to 512 keys,
    and while one (batch, head)'s K/V stay under 4 MB. The head dim must be
    one the kernel is built for. Whether the H100 should keep the TPU's
    bounds is an open question (PERF.md)."""
    return (
        device.type == "cuda"
        and D in KERNEL_HEAD_DIMS
        and Lk >= 256
        and (Lq == Lk or Lk <= 512 or Lq >= 256)
        and Lk * D * 4 * 2 <= 4 * 1024 * 1024
    )
