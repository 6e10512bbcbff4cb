"""The algorithm of the fp32 many-query attention backward, on the CPU.

An fp32 call with at least ``FP32_MANY_QUERY_MIN`` queries (S queries
against S keys: the encoder, the depth query source) takes
``csrc/attention_many_bwd_f32.cu`` on the card for K5, from what the fp32
many-query forward of the same call kept: each query's m and 1 / l and,
with dropout, the keep mask as bits. The kernel cannot run here,
but its algorithm can: a PyTorch emulation of both launches, with the
kernel's tiles, products and sums, is held to the plain version
(``composed_attention_bwd``) at rate 0 and 0.1 and, at rate 0, to the JAX
package's Pallas backward (``jax.vjp`` of ``flash_attention``, in interpret
mode as the JAX tests run it), on the same inputs made with numpy from a
seed.

- Launch 1: blocks of 64 queries walk every key in tiles of 64: s = q k^T
  and dP = g v^T, P = exp(s - m) / l, the keep factors read from the bits
  by the launch's own index rule, u = P keep dP; Dq += sum u, and dq's two
  parts sum u k and sum P k; at the end dq = scale (sum u k - Dq sum P k).
- Launch 2: blocks of 64 keys walk every query in tiles of 64: s^T = k q^T
  and dP^T = v g^T, the same P, keep and ds (the keep bits by launch 2's
  index rule, keys as rows), dv += (P keep)^T g, dk += ds^T q, dbias +=
  colsum(ds).
- Every product 3xTF32 (``test_torch_attention_rows_f32._product``); each
  tile's share of Dq, dq, dk and dv summed from zero and added once.
- The keep bits packed in ``csrc/attention_many.cuh``'s record layout from
  ``dropout_bits``, as the forward writes them.

Tolerance: 2e-5 of max(1, each gradient's largest entry) (``chip_smoke.K3_TOL``
relative, what the card holds fp32 K5 to up to 512 keys).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu.ops import attention as jax_attn
from r3d_tpu_torch.ops import attention as pt_attn
from test_torch_attention_rows_f32 import _inputs, _lengths, _product, many_forward_f32

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

TILE = 64        # csrc/attention_many_bwd_f32.cu: BR and TT, rows a block and columns a tile
REL_TOL = 2e-5   # chip_smoke.K3_TOL, over max(1, each gradient's largest entry)


def pack_keep_bits(keep):
    """The keep mask (bool [B, H, Lq, Lk]) as the forward's records: int32
    [B*H, ceil(Lq / 16), ceil(Lk / 64), 32], word g*4 + t of a (block of 16
    rows, tile of 64 keys) holding row g at bits 0-15 and row g + 8 at bits
    16-31, key nt*8 + 2t + j of the tile at bit nt*2 + j."""
    B, H, Lq, Lk = keep.shape
    n_rb, n_kt = -(-Lq // 16), -(-Lk // TILE)
    full = torch.zeros(B * H, n_rb * 16, n_kt * TILE, dtype=torch.int64)
    full[:, :Lq, :Lk] = keep.reshape(B * H, Lq, Lk).long()
    # [bh, rb, hi, g, kt, nt, t, j] -> [bh, rb, kt, g, t, hi, nt, j]
    x = full.reshape(B * H, n_rb, 2, 8, n_kt, 8, 4, 2).permute(0, 1, 4, 3, 6, 2, 5, 7)
    hi, nt, j = torch.meshgrid(torch.arange(2), torch.arange(8), torch.arange(2), indexing="ij")
    words = (x << (hi * 16 + nt * 2 + j)).sum((-3, -2, -1)).reshape(B * H, n_rb, n_kt, 32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _word(bits, bh_rb_kt_w, bit):
    """Bit ``bit`` of the records' words at the given indices, as 0 or 1."""
    w = bits.long()[bh_rb_kt_w] & 0xFFFFFFFF
    return (w >> bit) & 1


def launch1_keep(bits, rows, keys):
    """The keep bits of ``rows`` x ``keys`` [B*H, rows, keys] as launch 1
    reads them: lane (g, t) of the warp that owns 16 rows takes its word of
    the record, bit hi*16 + nt*2 + j for row g + 8*hi and key nt*8 + 2t + j."""
    r, c = rows[:, None], keys[None, :]
    row, key = r & 15, c & (TILE - 1)
    lane = (row & 7) * 4 + ((key & 7) >> 1)
    bit = (row >> 3) * 16 + (key >> 3) * 2 + (key & 1)
    bh = torch.arange(bits.shape[0])[:, None, None]
    return _word(bits, (bh, r >> 4, c >> 6, lane), bit)


def launch2_keep(bits, keys, rows):
    """The keep bits of ``keys`` x ``rows`` [B*H, keys, rows] as launch 2
    reads them: warp w's thread (gq, t) holds keys w*16 + hi*8 + gq, and
    takes query nt*8 + 2t + odd of a tile from word (2t + odd)*4 + gq / 2 of
    record nt / 2 at bit (2w + hi)*2 + gq % 2 + (nt % 2)*16."""
    c, r = keys[:, None], rows[None, :]
    key, query = c & (TILE - 1), r & (TILE - 1)
    warp, hi, gq = key >> 4, (key >> 3) & 1, key & 7
    nt, t, odd = query >> 3, (query & 7) >> 1, query & 1
    word = (2 * t + odd) * 4 + (gq >> 1)
    bit = (2 * warp + hi) * 2 + (gq & 1) + (nt & 1) * 16
    bh = torch.arange(bits.shape[0])[:, None, None]
    return _word(bits, (bh, (r >> 6) * 4 + (nt >> 1), c >> 6, word), bit)


def many_backward_f32(q, k, v, bias, scale, rate, g, m, inv_l, bits):
    """K5 as the fp32 many-query backward computes it, from the forward's
    (m, 1 / l) and keep bits: (dq, dk, dv, dbias [B, 1, 1, Lk] or None)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    flat = lambda t: t.reshape(B * H, *t.shape[2:])
    q, k, v, g, m, inv_l = map(flat, (q, k, v, g, m, inv_l))
    b_k = (torch.zeros(B * H, Lk) if bias is None
           else bias.reshape(B, 1, Lk).expand(B, H, Lk).reshape(B * H, Lk))
    keep_scale = 1.0 / (1.0 - rate)
    dq, delta = torch.empty_like(q), torch.empty(B * H, Lq)
    for i0 in range(0, Lq, TILE):   # launch 1: a block of 64 queries walks the key tiles
        rows = torch.arange(i0, min(i0 + TILE, Lq))
        acc_u, acc_p = torch.zeros(B * H, len(rows), D), torch.zeros(B * H, len(rows), D)
        acc_d = torch.zeros(B * H, len(rows))
        for j0 in range(0, Lk, TILE):
            keys = torch.arange(j0, min(j0 + TILE, Lk))
            s = _product("nqd,nkd->nqk", q[:, rows], k[:, keys], 3) * scale + b_k[:, None, keys]
            p = torch.exp(s - m[:, rows, None]) * inv_l[:, rows, None]
            dp = _product("nqd,nkd->nqk", g[:, rows], v[:, keys], 3)
            if rate > 0.0:
                dp = dp * launch1_keep(bits, rows, keys) * keep_scale
            u = p * dp
            acc_d += u.sum(-1)   # the tile's shares, once
            acc_u += _product("nqk,nkd->nqd", u, k[:, keys], 3)
            acc_p += _product("nqk,nkd->nqd", p, k[:, keys], 3)
        delta[:, rows] = acc_d   # Dq
        dq[:, rows] = (acc_u - acc_d[..., None] * acc_p) * scale
    dk, dv, dbias = torch.empty_like(k), torch.empty_like(v), torch.empty(B * H, Lk)
    for j0 in range(0, Lk, TILE):   # launch 2: a block of 64 keys walks the query tiles
        keys = torch.arange(j0, min(j0 + TILE, Lk))
        acc_k, acc_v = torch.zeros(B * H, len(keys), D), torch.zeros(B * H, len(keys), D)
        acc_b = torch.zeros(B * H, len(keys))
        for i0 in range(0, Lq, TILE):
            rows = torch.arange(i0, min(i0 + TILE, Lq))
            s = _product("nkd,nqd->nkq", k[:, keys], q[:, rows], 3) * scale + b_k[:, keys, None]
            p = torch.exp(s - m[:, None, rows]) * inv_l[:, None, rows]
            dp = _product("nkd,nqd->nkq", v[:, keys], g[:, rows], 3)
            keep = (launch2_keep(bits, keys, rows) * keep_scale if rate > 0.0
                    else torch.ones_like(p))
            ds = p * (dp * keep - delta[:, None, rows])
            acc_v += _product("nkq,nqd->nkd", p * keep, g[:, rows], 3)
            acc_k += _product("nkq,nqd->nkd", ds, q[:, rows], 3)
            acc_b += ds.sum(-1)
        dk[:, keys], dv[:, keys], dbias[:, keys] = acc_k * scale, acc_v, acc_b
    unflat = lambda t: t.reshape(B, H, *t.shape[1:])
    db = None if bias is None else dbias.reshape(B, H, Lk).sum(1)[:, None, None, :]
    return unflat(dq), unflat(dk), unflat(dv), db


def _backward(q, k, v, bias, seed, scale, rate, g):
    """The forward's statistics and bits, then the emulated backward."""
    _, m, inv_l = many_forward_f32(q, k, v, bias, seed, scale, rate, stats=True)
    bits = (pack_keep_bits(pt_attn.dropout_bits(seed, q.shape[:3] + k.shape[2:3], "cpu")
                           >= pt_attn.dropout_threshold(rate)) if rate > 0.0 else None)
    return many_backward_f32(q, k, v, bias, scale, rate, g, m, inv_l, bits)


def _close(got, want, name):
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    err = float((got - want).abs().max())
    assert err <= REL_TOL * max(1.0, float(want.abs().max())), (name, err)


def test_keep_bits_round_trip():
    """Bits packed from ``dropout_bits`` in the record layout, read back by
    either launch's index rule, are the mask, at ragged Lq and Lk."""
    B, H, Lq, Lk = 2, 3, 45, 150
    keep = pt_attn.dropout_bits(11, (B, H, Lq, Lk), "cpu") >= pt_attn.dropout_threshold(0.3)
    bits = pack_keep_bits(keep)
    assert tuple(bits.shape) == pt_attn.keep_bits_shape(B, H, Lq, Lk)
    rows, keys = torch.arange(Lq), torch.arange(Lk)
    flat = keep.reshape(B * H, Lq, Lk).long()
    assert torch.equal(launch1_keep(bits, rows, keys), flat)
    assert torch.equal(launch2_keep(bits, keys, rows), flat.transpose(1, 2))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [256, 300])
def test_fp32_many_query_backward_algorithm_matches_plain(S, rate):
    """The emulated backward against ``composed_attention_bwd``, random key
    lengths per row and one fully masked row, with the bias (and its
    cotangent) and without: S = 256 and a ragged S (a last query tile and
    key tile cut short)."""
    rng = np.random.RandomState(S + 7)
    q, k, v, bias = _inputs(rng, S, 16, _lengths(rng, S))
    g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    for b in (bias, None):
        got = _backward(q, k, v, b, 23, 0.25, rate, g)
        want = pt_attn.composed_attention_bwd(q, k, v, b, 23, 0.25, rate, g)
        assert (got[3] is None) == (b is None)
        for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
            if y is not None:
                _close(x, y, f"{name} bias={b is not None}")


def test_fp32_many_query_backward_algorithm_matches_pallas_at_rate0():
    """Against ``jax.vjp`` of JAX's ``flash_attention`` in fp32 (the Pallas
    backward in interpret mode) at S = 256, with a fully masked row (Pallas
    pads no keys there)."""
    rng = np.random.RandomState(5)
    q, k, v, bias = _inputs(rng, 256, 16, _lengths(rng, 256))
    g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    J = lambda t: jnp.asarray(t.numpy())
    _, vjp = jax.vjp(lambda *a: jax_attn.flash_attention(*a, 0.25), J(q), J(k), J(v), J(bias))
    got = _backward(q, k, v, bias, 0, 0.25, 0.0, g)
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, vjp(J(g))):
        _close(x, torch.from_numpy(np.array(y)), name)


def test_fp32_many_query_backward_algorithm_holds_one_key():
    """One key against 70 queries of 8 x 8 heads, where every ds is 0 and
    dbias sums 560 of them: Dq formed from the same P and dP as ds keeps
    them 0 (from the forward's output, each ds would carry the two
    products' different roundings)."""
    rng = np.random.RandomState(9)
    f = lambda L: torch.from_numpy(rng.randn(8, 8, L, 16).astype(np.float32))
    q, k, v, g = f(70), f(1), f(1), f(70)
    bias = torch.zeros(8, 1, 1, 1)
    got = _backward(q, k, v, bias, 0, 0.25, 0.0, g)
    want = pt_attn.composed_attention_bwd(q, k, v, bias, 0, 0.25, 0.0, g)
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(x, y, name)
