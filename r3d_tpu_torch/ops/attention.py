"""Attention kernels for the decoder cross-attention, forward and backward.

Counterpart of ``r3d_tpu/ops/attention.py``. Three kernels:

- K3 (``csrc/attention.cu``, ``r3d_attention_fwd``): ``softmax(q k^T *
  scale + bias) v`` with an fp32 softmax, masking its own ragged key edge;
- K4 (the same source, ``r3d_attention_fwd_dropout``): K3 with dropout on
  the softmax weights, the keep mask a hash of (seed, element index);
- K5 (``csrc/attention_bwd.cu``): the backward of both, redrawing the mask
  (the many-query bodies read it from their forward).

``flash_attention`` (K3 forward, K5 backward at rate 0) and
``flash_attention_dropout`` (K4 forward, K5 backward) are
``torch.autograd.Function``s. ``composed_attention``,
``composed_attention_dropout`` and ``composed_attention_bwd`` are the plain
PyTorch versions, drawing the same keep mask (``dropout_keep``) with torch
integer ops. The wrappers take them for CPU tensors only, and for a CUDA
tensor launch the kernel or raise.

Without gradients ``flash_attention`` calls K3's forward as a registered
operator, ``torch.ops.r3d_tpu_torch.flash_attention`` (its CPU
implementation the plain version, its CUDA implementation the kernel, on
either body; a fake implementation for ``torch.export``), so that an
exported serving program runs the kernel. A launch is counted where the
kernel runs, never where a program is traced.

The mask cannot reproduce the TPU's PRNG bits, so parity with the JAX
package runs at rate 0; dropout is checked by its invariants.

Each kernel is built for fp32 and for bf16 q, k, v (``*_BF16``, counted
apart), with fp32 math and the TPU kernels' rounding points, which the
plain versions share: K3 and K4 round the normalised weights (after
dropout) to V's type before the product with V and write the output in q's
type; K5 computes in fp32 and rounds dq, dk and dv to the inputs' type once.

Every body splits the keys of a (batch, head) across blocks that run at
once. fp32 K3, K4 and K5 (the utkinects decoder: Lq = 8, Lk = 256 or 512,
D = 16) split them into runs of ``fp32_split_keys`` (8 of 64 at Lk = 512),
the runs of one (batch*head, query tile) a thread-block cluster that
combines its statistics through distributed shared memory in rank order,
in one launch: K3 and K4 as flash-decoding (each run's (m, l, acc), K4's
acc over the kept weights scaled 1/(1-p), then the output normalised once),
K5 by combining each query's (m, l, D) before any gradient, each run owning
dk, dv and dbias of its keys and the runs' dq summed in rank order. The
bf16 forwards split the keys into runs of ``fwd_split_keys`` the same way:
they combine their softmax statistics before any weight is rounded, then
their partial outputs, in a fixed order, in one launch. K5's bf16 body
splits the keys into blocks of 64 that own dk and dv, in three launches.

Those bf16 bodies were built for few queries (the 50salads decoder's 20).
A bf16 call with at least ``MANY_QUERY_MIN`` queries (the gt-query FUTR's
decoder: S queries against S keys) takes the many-query bodies instead,
counted apart (``*_MANY``). The forward (``csrc/attention_many.cu``, K3 and
K4 as one template) gives each block 64 queries against every key in an
online softmax on the tensor cores and rounds the UNNORMALISED weights to
bf16 against the running max (as bf16 K6 does; the plain version rounds
the normalised ones, so a weight can differ by one bf16 step). A call that
trains also keeps, for the backward, each query's (m, 1 / l), the output in
fp32 from fp32-accurate weights (for Dq = rowsum(g o out)) and, with
dropout, the keep mask as bits. The backward (``csrc/attention_many_bwd.cu``,
two launches) takes those: Dq and dq over query tiles, then dk, dv and dbias
over key tiles, each owned by one block, ds rounded to bf16 before the dq
and dk products and the weights times the keep mask kept at fp32 accuracy
for dv (bf16 K7's rounding points). The autograd Functions save what the
forward keeps on that route only.

An fp32 call with at least ``FP32_MANY_QUERY_MIN`` queries (S queries
against S keys: the encoder, the depth query source, L3 query generation)
takes the fp32 many-query bodies. The forward (``csrc/attention_many_f32.cu``,
K3 and K4 as one template, ``KERNEL_MANY`` and ``DROPOUT_KERNEL_MANY``): 64
queries a block against every key, 3xTF32 tensor-core products, an online
softmax normalised once, the output in fp32; a call that trains also keeps
each query's (m, 1 / l) and, with dropout, the keep mask as bits, in the
bf16 forward's layout. The backward (``csrc/attention_many_bwd_f32.cu``,
``BWD_KERNEL_MANY``, two launches) follows the bf16 many-query backward's
design in fp32: Dq and dq over query tiles, then dk, dv and dbias over key
tiles, each owned by one block, every product 3xTF32, each tile's share
summed from zero and added once. It forms Dq = sum_k P keep dP from its own
P and dP, as the plain version does, and reads no output, so its saved
tensors are (the statistics, None, the keep bits or None) where bf16's are
(the statistics, out32, the keep bits or None).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from r3d_tpu_torch.ops.build import Kernel, check_device

KERNEL = Kernel(   # (B, H, Lq, Lk, D, split keys)
    "flash_attention", "attention.cu", "r3d_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
)
DROPOUT_KERNEL = Kernel(   # (B, H, Lq, Lk, D, split keys)
    "flash_attention_dropout", "attention.cu", "r3d_attention_fwd_dropout",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p],
)
BWD_KERNEL = Kernel(   # (B, H, Lq, Lk, D, split keys)
    "attention_bwd", "attention_bwd.cu", "r3d_attention_bwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
       ctypes.c_void_p],
)
KERNEL_BF16 = Kernel(
    "flash_attention_bf16", "attention.cu", "r3d_attention_fwd_bf16", KERNEL.argtypes)
DROPOUT_KERNEL_BF16 = Kernel(
    "flash_attention_dropout_bf16", "attention.cu", "r3d_attention_fwd_dropout_bf16",
    DROPOUT_KERNEL.argtypes)
BWD_KERNEL_BF16 = Kernel(   # two more pointers (its scratch); the key-block count
    "attention_bwd_bf16", "attention_bwd.cu", "r3d_attention_bwd_bf16",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + BWD_KERNEL.argtypes[15:],
)
KERNEL_BF16_MANY = Kernel(   # q, k, v, bias, out, out32, stats; (B, H, Lq, Lk, D)
    "flash_attention_bf16_many", "attention_many.cu", "r3d_attention_fwd_many_bf16",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
)
DROPOUT_KERNEL_BF16_MANY = Kernel(   # q, k, v, bias, out, out32, stats, keep bits
    "flash_attention_dropout_bf16_many", "attention_many.cu",
    "r3d_attention_fwd_dropout_many_bf16",
    [ctypes.c_void_p] * 8 + KERNEL_BF16_MANY.argtypes[7:-1] + DROPOUT_KERNEL.argtypes[-4:],
)
BWD_KERNEL_BF16_MANY = Kernel(   # q, k, v, bias, g, out32, stats, keep bits, Dq, dq, dk, dv, dbias
    "attention_bwd_bf16_many", "attention_many_bwd.cu", "r3d_attention_bwd_many_bf16",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
)
KERNEL_MANY = Kernel(   # fp32, many queries: q, k, v, bias, out, stats; (B, H, Lq, Lk, D)
    "flash_attention_many", "attention_many_f32.cu", "r3d_attention_fwd_many_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
)
DROPOUT_KERNEL_MANY = Kernel(   # q, k, v, bias, out, stats, keep bits
    "flash_attention_dropout_many", "attention_many_f32.cu", "r3d_attention_fwd_dropout_many_f32",
    [ctypes.c_void_p] * 7 + KERNEL_MANY.argtypes[6:-1] + DROPOUT_KERNEL.argtypes[-4:],
)
BWD_KERNEL_MANY = Kernel(   # q, k, v, bias, g, stats, keep bits, Dq, dq, dk, dv, dbias
    "attention_bwd_many", "attention_many_bwd_f32.cu", "r3d_attention_bwd_many_f32",
    BWD_KERNEL_BF16_MANY.argtypes[:5] + BWD_KERNEL_BF16_MANY.argtypes[6:],
)
_BY_DTYPE = {  # (forward, dropout forward, backward) per input dtype
    torch.float32: (KERNEL, DROPOUT_KERNEL, BWD_KERNEL),
    torch.bfloat16: (KERNEL_BF16, DROPOUT_KERNEL_BF16, BWD_KERNEL_BF16),
}
KERNEL_HEAD_DIMS = (16, 32, 64)   # csrc/attention*.cu: instantiated D
BWD_BLOCK_KEYS = 64               # csrc/attention_bwd.cu: KB, keys per block of the bf16 body
FWD_SPLIT_UNIT = 128              # csrc/attention.cu: NW * KT, one tile of keys per warp
FWD_MAX_SPLITS = 8                # csrc/attention_cluster.cuh: kMaxSplits, blocks per cluster
FP32_SPLIT_UNIT = 64              # csrc/attention_cluster.cuh: kF32KT, a tile of the fp32 bodies
FP32_QUERY_TILE = 8               # csrc/attention_cluster.cuh: kF32QT, queries a block takes at a time
MANY_QUERY_MIN = 33               # bf16: the many-query bodies from this many queries
# from this many queries the fp32 many-query bodies, forward and backward: at
# Lk = 256, B = H = 8, D = 16, p = 0.1 (NVIDIA H100 80GB HBM3, 700 W;
# chip_smoke.fp32_threshold_ab) the cluster bodies' device time against the
# many-query bodies', K3 / K4 (the many-query K4 keeping its statistics and
# bits) / K5: 8 queries 0.0062 / 0.0069 / 0.0093 against 0.0064 / 0.0092 /
# 0.0149 ms, 16 0.0076 / 0.0085 / 0.0147 against 0.0064 / 0.0093 / 0.0150,
# 17 0.0088 / 0.0102 / 0.0205 against 0.0064 / 0.0093 / 0.0150, 20 0.0088 /
# 0.0102 / 0.0206 against 0.0064 / 0.0093 / 0.0150, 33 0.0138 / 0.0154 /
# 0.0327 against 0.0065 / 0.0093 / 0.0151: a training call's K4 + K5 leads
# from 17 queries, K3 from 16; no fp32 path runs 9-32 queries
FP32_MANY_QUERY_MIN = 20
MANY_KEY_TILE = 64                # csrc/attention_many.cuh: kManyKeyTile, keys per tile

_U32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x < 2**32 held in int64 (or a Python int),
    without overflowing 63 bits: split c into 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _fmix32(h):
    """murmur3's 32-bit finalizer, as ``r3d::fmix32`` in csrc/common.cuh."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed: int, shape, device) -> torch.Tensor:
    """The kernels' dropout bits (``r3d::dropout_bits``) of every element of
    [B, H, Lq, Lk] weights under ``seed``, as uint32 values in int64: a
    hash of the element index ((b*H + h)*Lq + q)*Lk + k."""
    key = _fmix32((int(seed) & _U32) ^ 0x5BD1E995)
    n = int(torch.Size(shape).numel())
    if n > 2 ** 32:
        raise ValueError(f"dropout_bits: {n} elements do not fit a 32-bit index")
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return _fmix32((_fmix32(idx ^ key) + key) & _U32)


def dropout_threshold(rate: float) -> int:
    """Keep an element when its bits are >= rate * 2**32 (``_dropout_keep``,
    ``r3d_tpu/ops/attention.py:182-189``)."""
    return min(int(rate * 4294967296.0), _U32)


def dropout_keep(seed: int, rate: float, shape, device) -> torch.Tensor:
    """Float keep mask scaled 1/(1-rate): what the kernels multiply the
    softmax weights by."""
    keep = dropout_bits(seed, shape, device) >= dropout_threshold(rate)
    return keep.to(torch.float32) / (1.0 - rate)


def fwd_split_keys(Lk: int) -> int:
    """Keys per block of the bf16 forwards: as many splits of one tile per
    warp (128 keys) as cover Lk, up to 8 (a cluster's blocks); past 1,024
    keys each split grows by whole tiles. 4 splits of 128 at Lk = 512."""
    n = min(FWD_MAX_SPLITS, -(-Lk // FWD_SPLIT_UNIT))
    return FWD_SPLIT_UNIT * -(-Lk // (FWD_SPLIT_UNIT * n))


def fp32_split_keys(Lk: int) -> int:
    """Keys per block of the fp32 K3-K7: as many splits of one tile (64 keys,
    one a thread) as cover Lk, up to 8 (a cluster's blocks); past 512 keys
    each split grows by whole tiles. 8 splits of 64 at Lk = 512, of 128 at
    1,024, of 256 at 2,000."""
    n = min(FWD_MAX_SPLITS, -(-Lk // FP32_SPLIT_UNIT))
    return FP32_SPLIT_UNIT * -(-Lk // (FP32_SPLIT_UNIT * n))


def keep_bits_shape(B, H, Lq, Lk):
    """The many-query forward's keep mask for its backward: a record of 32
    words per (block of 16 queries, tile of ``MANY_KEY_TILE`` keys)."""
    return (B * H, -(-Lq // 16), -(-Lk // MANY_KEY_TILE), 32)


def many_query(q) -> bool:
    """Whether a CUDA call on ``q`` [B, H, Lq, D] takes the many-query
    bodies: bf16 with at least ``MANY_QUERY_MIN`` queries (the two bodies'
    A/B at Lk = 256, ``chip_smoke.many_query_threshold_ab``: from 33
    queries the many-query K3 and K5 are both ahead). The few-query bodies
    keep the rest."""
    return q.dtype == torch.bfloat16 and q.shape[2] >= MANY_QUERY_MIN


def many_query_body(dtype: torch.dtype, Lq: int) -> bool:
    """Whether a CUDA call of ``Lq`` queries in ``dtype`` takes a many-query
    body (``many_query``, ``fp32_many_query``)."""
    return Lq >= (MANY_QUERY_MIN if dtype == torch.bfloat16 else FP32_MANY_QUERY_MIN)


def fp32_many_query(q) -> bool:
    """Whether a CUDA call on ``q`` [B, H, Lq, D] takes the fp32 many-query
    bodies, forward and backward: fp32 with at least ``FP32_MANY_QUERY_MIN``
    queries (the A/B against the cluster bodies at Lk = 256,
    ``chip_smoke.fp32_threshold_ab``). ``many_query`` stays bf16's."""
    return q.dtype == torch.float32 and q.shape[2] >= FP32_MANY_QUERY_MIN


def _scores(q, k, bias, scale):
    """fp32 scores of q, k in any input dtype."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    return scores


def _pv(w, v, out_dtype):
    """The weights rounded to V's dtype, times V in fp32, in ``out_dtype``."""
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(), v.float()).to(out_dtype)


def composed_attention(q, k, v, bias, scale):
    """Plain attention: q, k, v [B, H, L, D]; bias [B, 1, 1, Lk] additive."""
    return _pv(torch.softmax(_scores(q, k, bias, scale), dim=-1), v, q.dtype)


def composed_attention_dropout(q, k, v, bias, seed: int, scale, rate: float):
    """Plain attention with the kernels' dropout on the softmax weights."""
    w = torch.softmax(_scores(q, k, bias, scale), dim=-1)
    if rate > 0.0:
        w = w * dropout_keep(seed, rate, w.shape, q.device)
    return _pv(w, v, q.dtype)


def composed_attention_bwd(q, k, v, bias, seed: int, scale, rate: float, g,
                           need_dbias: bool = True):
    """Plain backward of ``composed_attention_dropout`` (rate 0: of
    ``composed_attention``), written out as K5 computes it. Returns (dq, dk,
    dv, dbias [B, 1, 1, Lk] or None)."""
    w = torch.softmax(_scores(q, k, bias, scale), dim=-1)
    keep = dropout_keep(seed, rate, w.shape, q.device) if rate > 0.0 else 1.0
    g = g.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", w * keep, g)
    dw = torch.einsum("bhqd,bhkd->bhqk", g, v.float()) * keep
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dbias = ds.sum(dim=(1, 2), keepdim=True) if (bias is not None and need_dbias) else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check(fn, q, k, v, bias, extra=None):
    """Raise unless the CUDA kernels take these tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {q.device}")
    if q.dtype not in _BY_DTYPE:
        raise ValueError(f"{fn}: no kernel for {q.dtype}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {D} not in {KERNEL_HEAD_DIMS}")
    want = {"q": (q, (B, H, Lq, D), q.dtype), "k": (k, (B, H, Lk, D), q.dtype),
            "v": (v, (B, H, Lk, D), q.dtype)}
    if bias is not None:
        want["bias"] = (bias, (B, 1, 1, Lk), torch.float32)
    for name, t in (extra or {}).items():
        want[name] = (t, (B, H, Lq, D), q.dtype)
    for name, (t, shape, dtype) in want.items():
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
    return B, H, Lq, Lk, D


def _check_aligned(fn, **tensors):
    """The split kernels copy 16 bytes at a time."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_shape(fn, q, k, v, bias):
    """The shape arguments of the forward launchers, checked: (B, H, Lq, Lk,
    D) and the split size (the split bodies copy 16 bytes at a time)."""
    shape = _check(fn, q, k, v, bias)
    _check_aligned(fn, q=q, k=k, v=v)
    if shape[0] * shape[1] > 65535:
        raise ValueError(f"{fn}: B*H must be at most 65535 (the grid's z)")
    if q.dtype == torch.bfloat16:
        return shape + (fwd_split_keys(shape[3]),)
    if -(-shape[2] // FP32_QUERY_TILE) > 65535:
        raise ValueError(f"{fn}: ceil(Lq / {FP32_QUERY_TILE}) must be at most 65535 (the grid's y)")
    return shape + (fp32_split_keys(shape[3]),)


def _many_fwd(q, k, v, bias, scale, for_grad, drop=None):
    """The many-query forward: ``KERNEL_BF16_MANY``, or with ``drop`` =
    (seed, threshold, keep scale) ``DROPOUT_KERNEL_BF16_MANY``. Returns out
    and, with ``for_grad``, what the backward takes from it: (the statistics
    [2, B*H, Lq] fp32, each query's m then 1 / l; out in fp32 from
    fp32-accurate weights; with dropout the keep mask as bits, int32 [B*H,
    ceil(Lq / 16), ceil(Lk / 64), 32] (``csrc/attention_many.cuh``), else
    None)."""
    kernel = KERNEL_BF16_MANY if drop is None else DROPOUT_KERNEL_BF16_MANY
    B, H, Lq, Lk, D = _check(kernel.name, q, k, v, bias)
    _check_aligned(kernel.name, q=q, k=k, v=v)
    if B * H > 65535:
        raise ValueError(f"{kernel.name}: B*H must be at most 65535 (the grid's y)")
    out = torch.empty_like(q)
    stats = torch.empty((2, B * H, Lq), dtype=torch.float32, device=q.device)
    out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) if for_grad else None
    keep_bits = (torch.empty(keep_bits_shape(B, H, Lq, Lk), dtype=torch.int32, device=q.device)
                 if for_grad and drop is not None else None)
    bits = () if drop is None else (_ptr(keep_bits),)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), out.data_ptr(),
                  _ptr(out32), stats.data_ptr(), *bits, B, H, Lq, Lk, D, float(scale),
                  *(drop or ()), _stream(q))
    return out, ((stats, out32, keep_bits) if for_grad else None)


def _many_fwd_f32(q, k, v, bias, scale, for_grad, drop=None):
    """The fp32 many-query forward: ``KERNEL_MANY``, or with ``drop`` =
    (seed, threshold, keep scale) ``DROPOUT_KERNEL_MANY``. Returns out and,
    with ``for_grad``, what the backward takes from it: (the statistics [2,
    B*H, Lq] fp32, each query's m then 1 / l; None, where bf16 keeps its
    fp32 output: the fp32 backward reads no output; with dropout the keep
    mask as bits, int32 [B*H, ceil(Lq / 16), ceil(Lk / 64), 32]
    (``csrc/attention_many.cuh``), else None). Without it the kernel writes
    nothing but out, the same out bit for bit."""
    kernel = KERNEL_MANY if drop is None else DROPOUT_KERNEL_MANY
    B, H, Lq, Lk, D = _check(kernel.name, q, k, v, bias)
    _check_aligned(kernel.name, k=k, v=v)
    if B * H > 65535:
        raise ValueError(f"{kernel.name}: B*H must be at most 65535 (the grid's y)")
    out = torch.empty_like(q)
    stats = (torch.empty((2, B * H, Lq), dtype=torch.float32, device=q.device)
             if for_grad else None)
    keep_bits = (torch.empty(keep_bits_shape(B, H, Lq, Lk), dtype=torch.int32, device=q.device)
                 if for_grad and drop is not None else None)
    bits = () if drop is None else (_ptr(keep_bits),)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), out.data_ptr(),
                  _ptr(stats), *bits, B, H, Lq, Lk, D, float(scale), *(drop or ()), _stream(q))
    return out, ((stats, None, keep_bits) if for_grad else None)


def _attention_fwd(q, k, v, bias, scale, for_grad=False):
    """K3: (out, what the many-query backward takes (``_many_fwd``,
    ``_many_fwd_f32``) or None). The plain version for CPU tensors."""
    if q.device.type == "cpu":
        return composed_attention(q, k, v, bias, scale), None
    if many_query(q):
        return _many_fwd(q, k, v, bias, scale, for_grad)
    if fp32_many_query(q):
        return _many_fwd_f32(q, k, v, bias, scale, for_grad)
    shape = _fwd_shape("flash_attention", q, k, v, bias)
    out = torch.empty_like(q)
    _BY_DTYPE[q.dtype][0].launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                                 out.data_ptr(), *shape, float(scale), _stream(q))
    return out, None


def _attention_fwd_dropout(q, k, v, bias, seed, scale, rate, for_grad=False):
    """K4: (out, what the many-query backward takes (``_many_fwd``,
    ``_many_fwd_f32``) or None). The plain version for CPU tensors."""
    if q.device.type == "cpu":
        return composed_attention_dropout(q, k, v, bias, seed, scale, rate), None
    if q.numel() // q.shape[-1] * k.shape[-2] > 2 ** 32:
        raise ValueError("flash_attention_dropout: B*H*Lq*Lk must fit a 32-bit index")
    drop = (int(seed) & _U32, dropout_threshold(rate), 1.0 / (1.0 - rate))
    if many_query(q):
        return _many_fwd(q, k, v, bias, scale, for_grad, drop)
    if fp32_many_query(q):
        return _many_fwd_f32(q, k, v, bias, scale, for_grad, drop)
    shape = _fwd_shape("flash_attention_dropout", q, k, v, bias)
    out = torch.empty_like(q)
    _BY_DTYPE[q.dtype][1].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), out.data_ptr(), *shape,
        float(scale), *drop, _stream(q))
    return out, None


def attention_bwd(q, k, v, bias, seed: int, scale, rate: float, g,
                  need_dbias: bool = False, saved=None):
    """K5: (dq, dk, dv, dbias [B, 1, 1, Lk] or None) of attention with
    dropout at ``rate`` (0: none) under the output cotangent g. The plain
    version for CPU tensors. On the many-query route ``saved`` is what the
    forward of the same call keeps for it (the second thing
    ``_attention_fwd`` or, at rate > 0, ``_attention_fwd_dropout`` returns
    with ``for_grad``); without it that forward runs first."""
    if q.device.type == "cpu":
        return composed_attention_bwd(q, k, v, bias, seed, scale, rate, g, need_dbias)
    B, H, Lq, Lk, D = _check("attention_bwd", q, k, v, bias, {"g": g})
    if rate > 0.0 and B * H * Lq * Lk > 2 ** 32:
        raise ValueError("attention_bwd: B*H*Lq*Lk must fit a 32-bit index")
    need_dbias = need_dbias and bias is not None
    dbias = torch.empty((B, H, Lk), dtype=torch.float32, device=q.device) if need_dbias else None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tail = (float(scale), int(rate > 0.0), int(seed) & _U32, dropout_threshold(rate),
            1.0 / (1.0 - rate), _stream(q))
    if many_query(q) or fp32_many_query(q):
        if saved is None:
            saved = (_attention_fwd_dropout(q, k, v, bias, seed, scale, rate, for_grad=True)
                     if rate > 0.0 else _attention_fwd(q, k, v, bias, scale, for_grad=True))[1]
        stats, out32, keep_bits = saved   # out32: bf16's only
        bf16 = q.dtype == torch.bfloat16
        want = [("the statistics", stats, (2, B * H, Lq), torch.float32)]
        if bf16:
            want.append(("out32", out32, (B, H, Lq, D), torch.float32))
        if rate > 0.0:
            if keep_bits is None:
                raise ValueError("attention_bwd: no keep bits from a dropout forward")
            want.append(("the keep bits", keep_bits, keep_bits_shape(B, H, Lq, Lk), torch.int32))
        for name, t, shape, dtype in want:
            if (t.device != q.device or t.dtype != dtype or not t.is_contiguous()
                    or tuple(t.shape) != shape):
                raise ValueError(f"attention_bwd: {name} must be a contiguous {dtype} "
                                 f"{list(shape)} tensor on {q.device}")
        _check_aligned("attention_bwd", q=q, k=k, v=v, g=g)
        if bf16:
            _check_aligned("attention_bwd", out32=out32)
        if B * H > 65535:
            raise ValueError("attention_bwd: B*H must be at most 65535 (the grid's y)")
        delta = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
        (BWD_KERNEL_BF16_MANY if bf16 else BWD_KERNEL_MANY).launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), g.data_ptr(),
            *((out32.data_ptr(),) if bf16 else ()), stats.data_ptr(),
            _ptr(keep_bits) if rate > 0.0 else None, delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias), B, H, Lq, Lk, D,
            float(scale), int(rate > 0.0), 1.0 / (1.0 - rate), _stream(q))
    elif q.dtype == torch.bfloat16:
        _check_aligned("attention_bwd", q=q, k=k, v=v, g=g)
        n_kblocks = -(-Lk // BWD_BLOCK_KEYS)
        block_stats = torch.empty((3, n_kblocks, B * H, Lq), dtype=torch.float32, device=q.device)
        dq_partial = torch.empty((n_kblocks, B * H, Lq, D), dtype=torch.float32, device=q.device)
        BWD_KERNEL_BF16.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(dbias), block_stats.data_ptr(), dq_partial.data_ptr(),
            B, H, Lq, Lk, D, n_kblocks, *tail)
    else:   # every output is written by the kernel
        _check_aligned("attention_bwd", q=q, k=k, v=v, g=g)
        if B * H > 65535:
            raise ValueError("attention_bwd: B*H must be at most 65535 (the grid's y)")
        BWD_KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(dbias), B, H, Lq, Lk, D, fp32_split_keys(Lk),
            *tail)
    if dbias is not None:
        dbias = dbias.sum(1)[:, None, None, :]
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    """K3 forward, K5 backward at rate 0 (``attention.py:120-140``); on the
    many-query routes (bf16 and fp32) what the forward keeps for K5 is
    saved."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        out, saved = _attention_fwd(q, k, v, bias, scale, for_grad=True)
        ctx.save_for_backward(q, k, v, bias, *(saved or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, *saved = ctx.saved_tensors
        dq, dk, dv, db = attention_bwd(q, k, v, bias, 0, ctx.scale, 0.0, g.contiguous(),
                                       need_dbias=ctx.needs_input_grad[3],
                                       saved=tuple(saved) or None)
        return dq, dk, dv, db, None


class _FlashAttentionDropout(torch.autograd.Function):
    """K4 forward, K5 backward with the same mask (redrawn, or on the
    many-query routes read from the forward's bits)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, rate):
        ctx.seed, ctx.scale, ctx.rate = seed, scale, rate
        out, saved = _attention_fwd_dropout(q, k, v, bias, seed, scale, rate, for_grad=True)
        ctx.save_for_backward(q, k, v, bias, *(saved or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, *saved = ctx.saved_tensors
        dq, dk, dv, db = attention_bwd(q, k, v, bias, ctx.seed, ctx.scale, ctx.rate,
                                       g.contiguous(), need_dbias=ctx.needs_input_grad[3],
                                       saved=tuple(saved) or None)
        return dq, dk, dv, db, None, None, None


def _needs_graph(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


@torch.library.custom_op("r3d_tpu_torch::flash_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """K3's forward as an operator: the plain version on the CPU, the kernel
    (either body) on the card."""
    return _attention_fwd(q, k, v, bias, scale)[0]


@flash_attention_op.register_fake
def _(q, k, v, bias, scale):
    return torch.empty_like(q)


def flash_attention(q, k, v, bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """[B, H, Lq, D] attention over [B, H, Lk, D] keys and values with an
    optional key-padding bias [B, 1, 1, Lk]. CPU tensors take the plain
    version; CUDA tensors the kernels (K3 forward, K5 backward). Without
    gradients, the operator ``flash_attention_op``."""
    if _needs_graph(q, k, v, bias):
        return _FlashAttention.apply(q, k, v, bias, scale)
    check_device("flash_attention", q)
    return flash_attention_op(q, k, v, bias, scale)


def flash_attention_dropout(q, k, v, bias: Optional[torch.Tensor], seed: int, scale: float,
                            rate: float) -> torch.Tensor:
    """``flash_attention`` with dropout at ``rate`` on the softmax weights
    (torch ``nn.MultiheadAttention`` semantics, scaled 1/(1-rate)), the mask
    drawn from ``seed``: K4 forward, K5 backward on CUDA tensors."""
    if _needs_graph(q, k, v, bias):
        return _FlashAttentionDropout.apply(q, k, v, bias, seed, scale, rate)
    return _attention_fwd_dropout(q, k, v, bias, seed, scale, rate)[0]


def attention_kernel_eligible(Lq: int, Lk: int, D: int, device: torch.device) -> bool:
    """The JAX package's routing rule (``r3d_tpu/ops/attention.py:461-466``),
    with "on the card" in place of ``pallas_enabled()``: the kernel when the
    key side is at least 256 long, for cross-attention only up to 512 keys,
    and while one (batch, head)'s K/V stay under 4 MB. The head dim must be
    one the kernel is built for. It also routes the dropout kernel: the JAX
    train rule (``attention.py:469-473``) adds only "on a real TPU", which
    the CUDA check already stands for. Whether the H100 should keep the
    TPU's bounds is an open question (PERF.md)."""
    return (
        device.type == "cuda"
        and D in KERNEL_HEAD_DIMS
        and Lk >= 256
        and (Lq == Lk or Lk <= 512 or Lq >= 256)
        and Lk * D * 4 * 2 <= 4 * 1024 * 1024
    )


