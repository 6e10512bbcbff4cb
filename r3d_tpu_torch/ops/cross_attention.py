"""Native-layout decoder cross-attention, forward and backward.

Counterpart of ``r3d_tpu/ops/cross_attention.py``. The decoder's few
queries (``Lq <= 64``; 20 for 50salads) attend to long keys (``S > 512``; up
to 3,100) in the projections' own layout: q ``[B, Lq, C]``, k and v
``[B, S, C]`` with the ``H`` heads inside ``C``, so neither direction
relayouts K or V head-major. Two kernels:

- K6 (``csrc/cross_attention.cu``, ``r3d_cross_attention_fwd``): online
  softmax over the keys, optional dropout on the weights, and the softmax
  statistics (m, l) ``[B, H, Lq]`` for the backward; in bf16 the keys are
  split across blocks (as many as stay resident on the card at once) on
  the tensor cores, and a second launch combines the splits' (m, l, acc) in
  split order; in fp32 it is fp32 K3's cluster body on the native layout
  (``csrc/attention_fwd_cluster.cuh``): the keys split into runs of
  ``fp32_split_keys``, the runs of a (batch*head, query tile) one
  thread-block cluster that combines them in rank order, one launch;
- K7 (``csrc/cross_attention_bwd.cu``, ``r3d_cross_attention_bwd``): dq, dk
  and dv in native layout and the bias's cotangent, from the saved (m, l) and
  the forward output; in bf16 grid (batch*head, key split) with the splits
  sized as K6's (every block resident at once), each block walking its keys
  in tiles of 64 on the tensor cores and owning their dk and dv, and a
  second launch summing the splits' dq (and the heads' dbias) in order; in
  fp32, fp32 K5's cluster body on the native layout with the statistics given
  (``csrc/attention_bwd_cluster.cuh``): the keys split into runs of
  ``fp32_split_keys``, each run's block owning their dk and dv, the runs'
  dq summed in rank order in the cluster, one launch (and the heads' dbias
  summed by the wrapper when asked for).

``FWD_KERNEL`` and ``BWD_KERNEL`` count the bf16 launches,
``FWD_KERNEL_FP32`` and ``BWD_KERNEL_FP32`` the fp32 ones (``BY_DTYPE``).

``cross_attention_native`` is a ``torch.autograd.Function`` over the two.
``composed_cross_attention`` and ``composed_cross_attention_bwd`` are the
plain PyTorch versions with the kernels' rounding points: in bf16, K6 rounds
the unnormalised weights (after dropout) to the input type before the
product with V, and K7 rounds ds to the input type before the dq and dk
products; every sum is fp32. The wrappers take the plain versions for CPU
tensors only, and for a CUDA tensor launch the kernel or raise.

Without gradients ``cross_attention_native`` calls K6 as a registered
operator, ``torch.ops.r3d_tpu_torch.cross_attention`` (its CPU
implementation the plain version, its CUDA implementation the kernel, a
fake implementation for ``torch.export``), so that an exported serving
program runs the kernel. A launch is counted where the kernel runs, never
where a program is traced.

Dropout draws the mask of ``ops/attention.py`` (a hash of the seed and the
element index of the ``[B, H, Lq, S]`` weights), so the plain dropout
version is ``composed_attention_dropout``'s mask in native layout, and K7
redraws K6's mask. The TPU's PRNG bits cannot be reproduced: parity with
the JAX package runs at rate 0.

A fully masked row (every real key's bias ``finfo(float32).min``) averages
V uniformly over the real keys, as the port's K3 does; the Pallas kernel
also averages in its zero pad keys there (ROADMAP §C).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from r3d_tpu_torch.ops.attention import (
    _U32,
    _check_aligned,
    _needs_graph,
    _ptr,
    _stream,
    dropout_keep,
    dropout_threshold,
    fp32_split_keys,
)
from r3d_tpu_torch.ops.build import Kernel, check_device

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # the launchers' `dtype`
FWD_KERNEL = Kernel(
    "cross_attention", "cross_attention.cu", "r3d_cross_attention_fwd",
    [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
       ctypes.c_void_p],
)
BWD_KERNEL = Kernel(
    "cross_attention_bwd", "cross_attention_bwd.cu", "r3d_cross_attention_bwd",
    [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
       ctypes.c_void_p],
)
# fp32 calls: the same launchers, counted apart from the bf16 calls
FWD_KERNEL_FP32 = Kernel("cross_attention_fp32", FWD_KERNEL.source, FWD_KERNEL.symbol,
                         FWD_KERNEL.argtypes)
BWD_KERNEL_FP32 = Kernel("cross_attention_bwd_fp32", BWD_KERNEL.source, BWD_KERNEL.symbol,
                         BWD_KERNEL.argtypes)
BY_DTYPE = {torch.float32: (FWD_KERNEL_FP32, BWD_KERNEL_FP32),   # (K6, K7) counters
            torch.bfloat16: (FWD_KERNEL, BWD_KERNEL)}
CROSS_HEAD_DIMS = (16, 32, 64)   # csrc/cross_attention*.cu: instantiated D
MAX_QUERIES = 64                 # a block of K6 and K7 in bf16 holds every query of a head
FWD_SPLIT_UNIT = 128             # csrc/cross_attention.cu: NW * KT, 4 warps x tiles of 32 keys
FWD_BLOCKS_PER_SM = 2            # resident blocks of K6's bf16 split kernel (96 KB of tiles each)
BWD_TILE_KEYS = 64               # csrc/cross_attention_bwd.cu: KT, keys per tile of the bf16 body
BWD_BLOCKS_PER_SM = 2            # resident blocks of K7's bf16 main kernel (90 KB of tiles each at D = 64)


def _heads(x, H):
    """[B, L, C] -> [B, H, L, D] view, as fp32."""
    B, L, C = x.shape
    return x.float().view(B, L, H, C // H).transpose(1, 2)


def _native(x):
    """[B, H, L, D] -> [B, L, H*D]."""
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


def _scores(q, k, bias, scale, H):
    s = torch.einsum("bhqd,bhkd->bhqk", _heads(q, H), _heads(k, H)) * scale
    return s if bias is None else s + bias.float()


def composed_cross_attention(q, k, v, bias, seed: int, scale: float, rate: float, H: int):
    """Plain K6: q [B, Lq, C], k and v [B, S, C], bias [B, 1, 1, S] or None.
    Returns (out [B, Lq, C] in q's dtype, m [B, H, Lq], l [B, H, Lq]): the
    row max of the scores and the sum of exp(scores - m)."""
    s = _scores(q, k, bias, scale, H)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    if rate > 0.0:
        e = e * dropout_keep(seed, rate, e.shape, q.device)
    out = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(), _heads(v, H))
    out = out / l.clamp_min(1e-30)[..., None]
    return _native(out).to(q.dtype), m, l


def composed_cross_attention_bwd(q, k, v, bias, seed: int, scale: float, rate: float, H: int,
                                 g, o, m, l, need_dbias: bool = True):
    """Plain K7: (dq, dk, dv, dbias [B, 1, 1, S] fp32 or None) under the
    output cotangent g, from the forward's output o and statistics (m, l).
    delta = rowsum(g o o) per head holds under weight dropout too."""
    w = torch.exp(_scores(q, k, bias, scale, H) - m[..., None]) / l.clamp_min(1e-30)[..., None]
    keep = dropout_keep(seed, rate, w.shape, q.device) if rate > 0.0 else 1.0
    gh = _heads(g, H)
    dv = torch.einsum("bhqk,bhqd->bhkd", w * keep, gh)
    dw = torch.einsum("bhqd,bhkd->bhqk", gh, _heads(v, H)) * keep
    delta = (gh * _heads(o, H)).sum(-1)
    ds = w * (dw - delta[..., None])
    ds_r = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_r, _heads(k, H)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_r, _heads(q, H)) * scale
    dbias = ds.sum(dim=(1, 2))[:, None, None, :] if (bias is not None and need_dbias) else None
    return (_native(dq).to(q.dtype), _native(dk).to(k.dtype), _native(dv).to(v.dtype), dbias)


def _check(fn, q, k, v, bias, H, extra=None):
    """Raise unless the CUDA kernels take these tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: no kernel for {q.dtype}")
    B, Lq, C = q.shape
    S = k.shape[1]
    if C % H or C // H not in CROSS_HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {C}/{H} not in {CROSS_HEAD_DIMS}")
    if Lq > MAX_QUERIES:
        raise ValueError(f"{fn}: {Lq} queries, at most {MAX_QUERIES}")
    want = {"q": (q, (B, Lq, C), q.dtype), "k": (k, (B, S, C), q.dtype),
            "v": (v, (B, S, C), q.dtype)}
    if bias is not None:
        want["bias"] = (bias, (B, 1, 1, S), torch.float32)
    want.update(extra or {})
    for name, (t, shape, dtype) in want.items():
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if B * H * Lq * S > 2 ** 32:
        raise ValueError(f"{fn}: B*H*Lq*S must fit a 32-bit index")
    return B, Lq, S, C


def fwd_split_keys(S: int, n_heads: int, n_sm: int) -> int:
    """Keys per block of K6's bf16 split kernel: the most splits that keep
    all ``n_heads`` (batch x head) x splits blocks resident at once
    (``FWD_BLOCKS_PER_SM`` an SM), so each warp streams a long run of keys
    through its ring, in whole units of ``FWD_SPLIT_UNIT`` keys."""
    n_split = max(1, FWD_BLOCKS_PER_SM * n_sm // n_heads)
    return max(1, -(-S // (n_split * FWD_SPLIT_UNIT))) * FWD_SPLIT_UNIT


def bwd_split_keys(S: int, n_heads: int, n_sm: int) -> int:
    """Keys per block of K7's bf16 main kernel: as ``fwd_split_keys``, the
    most splits that keep all ``n_heads`` (batch x head) x splits blocks
    resident at once (``BWD_BLOCKS_PER_SM`` an SM), in whole tiles of
    ``BWD_TILE_KEYS``."""
    n_split = max(1, BWD_BLOCKS_PER_SM * n_sm // n_heads)
    return max(1, -(-S // (n_split * BWD_TILE_KEYS))) * BWD_TILE_KEYS


def bwd_scratch_shape(S: int, B: int, Lq: int, C: int, H: int, split_keys: int,
                      need_dbias: bool):
    """fp32 values of K7's bf16 scratch: each split's dq [n_split, B, Lq, C],
    then (with dbias) each head's dbias [H, B, S]. fp32 K7 takes none."""
    n_split = -(-S // split_keys)
    return (n_split * B * Lq * C + (H * B * S if need_dbias else 0),)


def cross_attention_fwd(q, k, v, bias, seed: int, scale: float, rate: float, H: int):
    """K6: (out, m, l); the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return composed_cross_attention(q, k, v, bias, seed, scale, rate, H)
    B, Lq, S, C = _check("cross_attention", q, k, v, bias, H)
    _check_aligned("cross_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    m = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    partial = None
    if q.dtype == torch.bfloat16:   # each split's (acc, m, l), combined by a second launch
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        split_keys = fwd_split_keys(S, B * H, n_sm)
        partial = torch.empty((-(-S // split_keys) * B * H * Lq, C // H + 2),
                              dtype=torch.float32, device=q.device)
    else:   # one cluster launch
        if B * H > 65535:
            raise ValueError("cross_attention: B*H must be at most 65535 (the grid's z)")
        split_keys = fp32_split_keys(S)
    BY_DTYPE[q.dtype][0].launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), _ptr(partial), split_keys, B, Lq, S, H, C // H,
        float(scale),
        int(rate > 0.0), int(seed) & _U32, dropout_threshold(rate), 1.0 / (1.0 - rate),
        _stream(q))
    return out, m, l


def cross_attention_bwd(q, k, v, bias, seed: int, scale: float, rate: float, H: int, g, o, m, l,
                        need_dbias: bool = False):
    """K7: (dq, dk, dv, dbias [B, 1, 1, S] or None); the plain version for
    CPU tensors."""
    if q.device.type == "cpu":
        return composed_cross_attention_bwd(q, k, v, bias, seed, scale, rate, H, g, o, m, l,
                                            need_dbias)
    stats = (q.shape[0], H, q.shape[1])
    B, Lq, S, C = _check("cross_attention_bwd", q, k, v, bias, H,
                         {"g": (g, tuple(q.shape), q.dtype), "o": (o, tuple(q.shape), q.dtype),
                          "m": (m, stats, torch.float32), "l": (l, stats, torch.float32)})
    need_dbias = need_dbias and bias is not None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:   # each split's dq (and each head's dbias), summed by a second launch
        _check_aligned("cross_attention_bwd", q=q, k=k, v=v, g=g)
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        split_keys = bwd_split_keys(S, B * H, n_sm)
        part = torch.empty(bwd_scratch_shape(S, B, Lq, C, H, split_keys, need_dbias),
                           dtype=torch.float32, device=q.device)
        dbias = (torch.empty((B, 1, 1, S), dtype=torch.float32, device=q.device)
                 if need_dbias else None)
    else:   # one cluster launch; each head's dbias, summed here
        _check_aligned("cross_attention_bwd", q=q, k=k, v=v, g=g, o=o)
        if B * H > 65535:
            raise ValueError("cross_attention_bwd: B*H must be at most 65535 (the grid's y)")
        split_keys, part = fp32_split_keys(S), None
        dbias = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
                 if need_dbias else None)
    BY_DTYPE[q.dtype][1].launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
        g.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), _ptr(part),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias), B, Lq, S, H, C // H, split_keys,
        float(scale), int(rate > 0.0), int(seed) & _U32, dropout_threshold(rate),
        1.0 / (1.0 - rate), _stream(q))
    if dbias is not None and q.dtype == torch.float32:
        dbias = dbias.sum(1)[:, None, None, :]
    return dq, dk, dv, dbias


class _CrossAttention(torch.autograd.Function):
    """K6 forward saving (out, m, l), K7 backward (``cross_attention.py:313-329``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, rate, H):
        out, m, l = cross_attention_fwd(q, k, v, bias, seed, scale, rate, H)
        ctx.args = (seed, scale, rate, H)
        ctx.save_for_backward(q, k, v, bias, out, m, l)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, m, l = ctx.saved_tensors
        dq, dk, dv, db = cross_attention_bwd(q, k, v, bias, *ctx.args, g.contiguous(), out, m, l,
                                             need_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, db, None, None, None, None


@torch.library.custom_op("r3d_tpu_torch::cross_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def cross_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: Optional[torch.Tensor], seed: int, scale: float, rate: float,
                       H: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 as an operator, (out, m, l): the plain version on the CPU, the
    kernel on the card."""
    return cross_attention_fwd(q, k, v, bias, seed, scale, rate, H)


@cross_attention_op.register_fake
def _(q, k, v, bias, seed, scale, rate, H):
    stats = q.new_empty((q.shape[0], H, q.shape[1]), dtype=torch.float32)
    return torch.empty_like(q), stats, torch.empty_like(stats)


def cross_attention_native(q, k, v, bias: Optional[torch.Tensor], seed: int, scale: float,
                           rate: float, H: int) -> torch.Tensor:
    """Multi-head attention on native [B, L, C] projection outputs: q
    [B, Lq, C], k and v [B, S, C], bias [B, 1, 1, S] additive or None;
    returns [B, Lq, C], the heads concatenated. ``rate`` > 0 drops weights
    with the mask drawn from ``seed``. CPU tensors take the plain versions;
    CUDA tensors the kernels (K6 forward, K7 backward). Without gradients,
    the operator ``cross_attention_op``."""
    if _needs_graph(q, k, v, bias):
        return _CrossAttention.apply(q, k, v, bias, seed, scale, rate, H)
    check_device("cross_attention", q)
    return cross_attention_op(q, k, v, bias, seed, scale, rate, H)[0]


def cross_attention_native_eligible(Lq: int, Lk: int, C: int, H: int, rate: float,
                                    device: torch.device) -> bool:
    """The JAX package's rule (``r3d_tpu/ops/cross_attention.py:382-404``):
    opt-in only, under ``R3D_CROSS_NATIVE=1`` (or ``R3D_FORCE_PALLAS=1``),
    read at call time; then few queries against long keys, Lq <= 64, Lk >
    512, C <= 1024, D % 8 == 0. "On the card" stands for both
    ``pallas_enabled()`` and "rate > 0 needs a real TPU", so ``rate`` does
    not change the answer here. The head dim must also be one the kernels
    are built for. JAX keeps the route off by default after a TPU
    measurement; whether the H100 should route it by default is an open
    question (PERF.md)."""
    if not (os.environ.get("R3D_CROSS_NATIVE") == "1"
            or os.environ.get("R3D_FORCE_PALLAS") == "1"):
        return False
    if device.type != "cuda" or C % H != 0 or (C // H) % 8 != 0:
        return False
    return C // H in CROSS_HEAD_DIMS and Lq <= MAX_QUERIES and Lk > 512 and C <= 1024
