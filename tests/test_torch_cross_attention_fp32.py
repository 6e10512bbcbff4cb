"""The cluster algorithm of fp32 K6, the native cross-attention forward's
CUDA kernel, emulated on the CPU and held to the plain version
(``r3d_tpu_torch/ops/cross_attention.py``): runs of ``fp32_split_keys``
walked in tiles of 64 and combined in rank order, fp32 within 2e-6. The
helpers here also emulate fp32 K7 from the forward's statistics, whose test
is ``tests/test_torch_cross_attention_fp32_bwd.py``. Split out of
``tests/test_torch_cross_attention.py`` unchanged.
"""

import numpy as np
import pytest
import torch

from r3d_tpu_torch.ops import cross_attention as pt_ca
from test_torch_cross_attention import SCALE

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


FP32_TILE = 64   # csrc/attention_cluster.cuh: kF32KT, keys a tile
FP32_QT = 8      # csrc/attention_cluster.cuh: kF32QT, queries a block takes at a time


def _fp32_combine(parts):
    """``_combine`` in rank order, with a part that saw no key (m = -inf)
    weighing 0 even where every part did (the row's m is then -inf)."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = torch.where(m_i == -torch.inf, torch.zeros_like(m), torch.exp(m_i - m))
        l = l + l_i * w
        acc = acc + acc_i * w[..., None]
    return m, l, acc


def _cluster_forward(q, k, v, bias, seed, scale, rate, H, split_keys):
    """fp32 K6 as its cluster kernel computes it: (out, m, l). Each block (a
    run of ``split_keys`` keys) walks its run in tiles of 64 with an online
    softmax (m_i, l_i, acc_i), acc_i over the kept weights times the keep
    factor and l_i over every weight; the cluster's blocks are combined in
    rank order, the output normalised once, and (m, l) written out."""
    from r3d_tpu_torch.ops.attention import dropout_keep

    s = pt_ca._scores(q, k, bias, scale, H)
    keep = dropout_keep(seed, rate, s.shape, q.device) if rate > 0.0 else None
    vh = pt_ca._heads(v, H)
    S = s.shape[-1]
    parts = []
    for s0 in range(0, S, split_keys):
        m = torch.full(s.shape[:-1], -torch.inf)
        l = torch.zeros(s.shape[:-1])
        acc = torch.zeros(s.shape[:-1] + (vh.shape[-1],))
        for t0 in range(s0, min(s0 + split_keys, S), FP32_TILE):
            sl = slice(t0, min(t0 + FP32_TILE, S))
            m_new = torch.maximum(m, s[..., sl].amax(-1))
            corr = torch.where(m_new == -torch.inf, torch.ones_like(m), torch.exp(m - m_new))
            p = torch.where(s[..., sl] == -torch.inf, 0.0, torch.exp(s[..., sl] - m_new[..., None]))
            l = l * corr + p.sum(-1)
            pa = p if keep is None else p * keep[..., sl]
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", pa, vh[:, :, sl])
            m = m_new
        parts.append((m, l, acc))
    m, l, acc = _fp32_combine(parts)
    out = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    return pt_ca._native(out), m, l


def _cluster_backward(q, k, v, bias, seed, scale, rate, H, g, o, m, l):
    """fp32 K7 as its cluster kernel computes it: (dq, dk, dv, dbias). w from
    the forward's (m, l), and ds = w (g . (keep v - o)): delta = rowsum(g o
    o) folded into the dot per (query, key); each block (a run
    of ``fp32_split_keys`` keys) owns dk, dv and the per-head dbias of its
    keys, summed over the query tiles of 8 in order; dq is the blocks'
    shares summed in rank order, dbias the heads' slices summed in head
    order."""
    from r3d_tpu_torch.ops.attention import dropout_keep, fp32_split_keys

    s = pt_ca._scores(q, k, bias, scale, H)
    S, Lq = s.shape[-1], s.shape[-2]
    split_keys = fp32_split_keys(S)
    keep = dropout_keep(seed, rate, s.shape, q.device) if rate > 0.0 else torch.ones_like(s)
    qh, kh, vh, gh, oh = (pt_ca._heads(x, H) for x in (q, k, v, g, o))
    w = torch.where(s == -torch.inf, 0.0,
                    torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None])
    ds = w * (gh[:, :, :, None] * (keep[..., None] * vh[:, :, None] - oh[:, :, :, None])).sum(-1)
    dk, dv = torch.zeros(kh.shape), torch.zeros(vh.shape)
    dbias = torch.zeros(s.shape[:2] + (S,))
    blocks = [slice(s0, min(s0 + split_keys, S)) for s0 in range(0, S, split_keys)]
    for blk in blocks:
        for q0 in range(0, Lq, FP32_QT):
            qs = slice(q0, q0 + FP32_QT)
            dv[:, :, blk] += torch.einsum("bhqk,bhqd->bhkd", (w * keep)[:, :, qs, blk], gh[:, :, qs])
            dk[:, :, blk] += torch.einsum("bhqk,bhqd->bhkd", ds[:, :, qs, blk], qh[:, :, qs])
            dbias[:, :, blk] += ds[:, :, qs, blk].sum(2)
    dq = torch.zeros(qh.shape)
    for blk in blocks:   # the blocks' shares, in rank order
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds[..., blk], kh[:, :, blk])
    db = torch.zeros(s.shape[0], S)
    for h in range(H):
        db = db + dbias[:, h]
    return (pt_ca._native(dq * scale), pt_ca._native(dk * scale), pt_ca._native(dv),
            db[:, None, None, :])


def _fp32_inputs(S, Lq, D, seed):
    """fp32 q, k, v, g [3 rows] with H = 128 / D heads, and a bias whose
    rows keep every key, 10 keys (the later splits all masked) and none (a
    fully masked row)."""
    rng = np.random.RandomState(seed)
    C = 128
    q, k, v, g = (torch.from_numpy(rng.randn(3, L, C).astype(np.float32)) for L in (Lq, S, S, Lq))
    pad = np.arange(S)[None, :] >= np.asarray([S, 10, 0])[:, None]
    bias = torch.from_numpy(
        np.where(pad, np.finfo(np.float32).min, 0.0).astype(np.float32)[:, None, None, :])
    return q, k, v, bias, g, C // D


FP32_CLUSTER_S = [513, 777, 1024, 2000, 3100]


def test_fp32_cross_split_keys():
    """fp32 K6's and K7's runs: 8 of 256 keys at the utkinects 2000 bucket
    and of 128 at 1,024 (the 1024 bucket); at most 8 whole tiles of 64,
    every run holding a key."""
    from r3d_tpu_torch.ops.attention import fp32_split_keys

    assert (fp32_split_keys(2000), fp32_split_keys(1024)) == (256, 128)
    for S in range(1, 4000, 7):
        split = fp32_split_keys(S)
        n = -(-S // split)
        assert split % FP32_TILE == 0 and n <= 8 and (n - 1) * split < S, S


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("Lq", [8, 20, 33, 64])
@pytest.mark.parametrize("S", FP32_CLUSTER_S)
def test_fp32_cluster_forward_matches_plain(S, Lq, D, rate):
    """fp32 K6's cluster algorithm against the plain version: out within
    2e-6 of its largest entry, (m, l) within 1e-6 relative, a fully masked
    row averaging over the real keys."""
    from r3d_tpu_torch.ops.attention import fp32_split_keys

    q, k, v, bias, _, H = _fp32_inputs(S, Lq, D, S + Lq + D)
    seed = 23 + S
    got = _cluster_forward(q, k, v, bias, seed, SCALE, rate, H, fp32_split_keys(S))
    want = pt_ca.composed_cross_attention(q, k, v, bias, seed, SCALE, rate, H)
    assert torch.isfinite(got[0]).all()
    big = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 2e-6 * max(1.0, big)
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got[2], want[2], atol=1e-6, rtol=1e-6)


def test_fp32_cluster_gives_zeros_under_an_all_inf_bias():
    """A row whose every score is -inf: every run has m_i = -inf, so out = 0
    and (m, l) = (-inf, 0), and K7 from those statistics gives zero
    gradients, not NaN."""
    q, k, v, _, g, H = _fp32_inputs(777, 8, 16, 5)
    bias = torch.full((3, 1, 1, 777), -torch.inf)
    out, m, l = _cluster_forward(q, k, v, bias, 3, SCALE, 0.1, H, 128)
    assert torch.equal(out, torch.zeros_like(out)) and bool((m == -torch.inf).all())
    assert torch.equal(l, torch.zeros_like(l))
    for x in _cluster_backward(q, k, v, bias, 3, SCALE, 0.1, H, g, out, m, l):
        assert torch.equal(x, torch.zeros_like(x))
