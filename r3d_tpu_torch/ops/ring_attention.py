"""Ring attention over the mesh's sequence-parallel (sp) axis.

Counterpart of ``r3d_tpu/ops/ring_attention.py``: self-attention whose
queries, keys and values are each rank's ``[B, H, S/sp, D]`` block of the
sequence. ``_ring_local`` (``:45-84``) runs sp steps of online softmax in
fp32, rotating the keys, values and key-padding bias one hop to rank
``(i + 1) % sp`` after each step, so rank r sees blocks r, r-1, ...; after
sp steps every query has seen every key and ``out = acc / max(l, 1e-30)``.
This keeps JAX's order, so the fp32 sums stay close to its. No rank holds
more than a ``[S/sp, S/sp]`` block of scores, and no rank gathers the keys.

JAX differentiates through its scan and ``ppermute``; autograd cannot
differentiate through ``send``/``recv``, so the backward is a second ring,
written out: each hop's P is recomputed from the saved row maxima ``m`` and
normalisers ``l``, ``D = rowsum(dO * O)``, dq accumulates on the rank, and
dk and dv travel with their block and land home after sp hops.

Both hops' products are plain ``torch.einsum`` in fp32, as JAX's are plain
jnp: the ring is no Pallas kernel, so it has no CUDA kernel here.

Transport (``rotate``): ``dist.batch_isend_irecv`` on the sp group with the
peers' global ranks, where the backend carries point-to-point on the
tensors' device (NCCL; gloo on CPU tensors). gloo does not carry a send of
a CUDA tensor: on an H100 machine with torch 2.11 it aborted the sending
process (``gloo::IoException``, ``writev``: Bad address;
``chip_smoke.gloo_p2p_probe``). So with gloo on CUDA tensors each hop is
one ``all_gather_into_tensor`` (which gloo takes on CUDA) of the hop's
tensors packed in one fp32 buffer, from which the rank keeps rank r-1's
block.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from r3d_tpu_torch.parallel.tensor import Axis

_NEG = float(torch.finfo(torch.float32).min)


def ring_attention_eligible(Lq: int, Lk: int, sp: int) -> bool:
    """``r3d_tpu/ops/ring_attention.py:121-129``: self-attention on an sp
    axis above 1 with block-divisible lengths, at least 64 queries a rank.
    ``Lq`` and ``Lk`` are the whole lengths, not a rank's."""
    return sp > 1 and Lq == Lk and Lq % sp == 0 and Lq >= 64 * sp


def _p2p(t: torch.Tensor, group: dist.ProcessGroup) -> bool:
    """Whether ``group``'s backend sends and receives tensors on ``t``'s device."""
    return t.device.type == "cpu" or dist.get_backend(group) == "nccl"


def rotate(tensors: List[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
    """One hop of the ring: each tensor goes to sp rank ``(r + 1) % sp``;
    returns those of rank ``(r - 1) % sp``."""
    group = axis.group
    if _p2p(tensors[0], group):
        nxt = dist.get_global_rank(group, (axis.rank + 1) % axis.size)
        prv = dist.get_global_rank(group, (axis.rank - 1) % axis.size)
        sent = [t.contiguous() for t in tensors]
        got = [torch.empty_like(t) for t in sent]
        ops = ([dist.P2POp(dist.isend, t, nxt, group, tag=i) for i, t in enumerate(sent)]
               + [dist.P2POp(dist.irecv, t, prv, group, tag=i) for i, t in enumerate(got)])
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return got
    # gloo on CUDA tensors: every rank's hop in one gather, rank r-1's kept
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    every = flat.new_empty(axis.size * flat.numel())
    dist.all_gather_into_tensor(every, flat, group=group)
    mine = every.view(axis.size, -1)[(axis.rank - 1) % axis.size]
    out, at = [], 0
    for t in tensors:
        out.append(mine[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _scores(q32, k, bias, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k.float()) * scale
    return s if bias is None else s + bias.float()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, axis: Axis):
        q32 = q.float()
        B, H, Sb, D = q.shape
        m = q32.new_full((B, H, Sb), _NEG)
        l = q32.new_zeros((B, H, Sb))
        acc = q32.new_zeros((B, H, Sb, D))
        blk = [k, v] + ([] if bias is None else [bias])
        for step in range(axis.size):
            s = _scores(q32, blk[0], blk[2] if bias is not None else None, scale)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)   # rescale the old state
            e = torch.exp(s - m_new[..., None])
            l = l * alpha + e.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", e.to(v.dtype).float(), blk[1].float())
            m = m_new
            if step < axis.size - 1:
                blk = rotate(blk, axis)
        out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, out, m, l)
        ctx.scale, ctx.axis = scale, axis
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, m, l = ctx.saved_tensors
        scale, axis = ctx.scale, ctx.axis
        q32, g32 = q.float(), g.float()
        Dr = (g32 * out.float()).sum(-1)
        dq = torch.zeros_like(q32)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        blk = [k, v] + ([] if bias is None else [bias])
        for step in range(axis.size):
            kb, vb = blk[0].float(), blk[1].float()
            s = _scores(q32, kb, blk[2] if bias is not None else None, scale)
            p = torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None]
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, g32)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", g32, vb) - Dr[..., None])
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
            if step < axis.size - 1:
                # the block's gradients travel with it
                moved = rotate(blk + [dk, dv], axis)
                blk, (dk, dv) = moved[:-2], moved[-2:]
        # after sp - 1 hops this rank holds block r + 1's: one hop sends it home
        dk, dv = rotate([dk, dv], axis)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], scale: float, sp_axis: Axis) -> torch.Tensor:
    """Attention of each rank's ``[B, H, S/sp, D]`` blocks over the whole
    sequence, the blocks in sp rank order; ``bias`` the rank's additive
    key-padding block ``[B, 1, 1, S/sp]`` (``finfo(float32).min`` at
    padding) or None. Composes with tp (the rank's H/tp heads) and dp (its
    rows)."""
    return _Ring.apply(q, k, v, bias, scale, sp_axis)
