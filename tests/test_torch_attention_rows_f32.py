"""The algorithm of the fp32 many-query attention forward, on the CPU.

An fp32 call with at least ``FP32_MANY_QUERY_MIN`` queries (S queries
against S keys: the encoder, the depth query source, L3 query generation)
takes ``csrc/attention_many_f32.cu`` on the card, K3 and K4 as one
template. That kernel cannot run here, but its algorithm can: a PyTorch
emulation with the kernel's tile sizes and products is held to the plain
versions (``composed_attention``, ``composed_attention_dropout``) and, at
rate 0, to the JAX package's ``flash_attention`` (Pallas in interpret mode,
as the JAX tests run it), on the same inputs made with numpy from a seed.

- Each block takes 64 queries and walks every key in tiles of 64.
- Both products are 3xTF32 (``csrc/mma_tf32.cuh``): each operand's high
  part rounded to TF32, its low part the remainder truncated to TF32,
  and lo hi + hi lo + hi hi summed in fp32.
- The softmax is online in fp32: the running max m, l summing every
  weight, each tile's P v summed from zero and added once to the output
  rescaled for the tile's max, out = acc / l once, in fp32.
- K4 multiplies each weight of acc (not of l) by the keep mask scaled
  1 / (1 - p), ``dropout_keep``: the hash of the element index that the
  kernel and the fp32 backward draw.

Tolerance: 2e-5 absolute (``chip_smoke.K3_TOL``, what the card holds the
kernel to: an online against a two-pass softmax in fp32, 3xTF32 products
within about 2**-22 of fp32's). One TF32 pass instead of three does not
hold it, which is why the kernel pays three products for each.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r3d_tpu.ops import attention as jax_attn
from r3d_tpu_torch.ops import attention as pt_attn

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

QUERY_BLOCK = 64   # csrc/attention_many_f32.cu: BQ, queries a block
KEY_TILE = 64      # kF32KT, keys a tile
TOL = 2e-5         # chip_smoke.K3_TOL
NEG = np.finfo(np.float32).min


def _tf32(x):
    """x rounded to TF32, to nearest with ties away from zero (``split_tf32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x truncated to TF32: what the mma reads of the low part."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, passes):
    """einsum with TF32 operands and fp32 sums: one pass (hi hi) or the
    kernel's three (lo hi + hi lo + hi hi)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    y = torch.einsum(eq, a_hi, b_hi)
    if passes == 3:
        y = (torch.einsum(eq, _tf32_trunc(a - a_hi), b_hi)
             + torch.einsum(eq, a_hi, _tf32_trunc(b - b_hi)) + y)
    return y


def many_forward_f32(q, k, v, bias, seed, scale, rate, passes=3, stats=False):
    """K3 (rate 0) or K4 as the fp32 many-query kernel computes them: out,
    or with ``stats`` (out, m, 1 / l) as a call that trains keeps them (m 0
    and 1 / l 0 for a row with no finite score)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    keep = pt_attn.dropout_keep(seed, rate, (B, H, Lq, Lk), "cpu") if rate > 0.0 else None
    out = torch.empty_like(q)
    m_all, inv_all = torch.empty(q.shape[:-1]), torch.empty(q.shape[:-1])
    for i0 in range(0, Lq, QUERY_BLOCK):
        rows = slice(i0, i0 + QUERY_BLOCK)
        qb = q[:, :, rows]
        m = torch.full(qb.shape[:-1], -torch.inf)
        l = torch.zeros(qb.shape[:-1])
        acc = torch.zeros(qb.shape)
        for j0 in range(0, Lk, KEY_TILE):
            keys = slice(j0, j0 + KEY_TILE)
            s = _product("bhqd,bhkd->bhqk", qb, k[:, :, keys], passes) * scale
            if bias is not None:
                s = s + bias[..., keys]
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.where(m_new == -torch.inf, torch.ones_like(m), torch.exp(m - m_new))
            mu = torch.where(m_new == -torch.inf, torch.zeros_like(m), m_new)
            p = torch.exp(s - mu[..., None])
            l = l * corr + p.sum(-1)
            if keep is not None:
                p = p * keep[:, :, rows, keys]
            acc = acc * corr[..., None] + _product("bhqk,bhkd->bhqd", p, v[:, :, keys], passes)
            m = m_new
        inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
        out[:, :, rows] = acc * inv[..., None]
        m_all[:, :, rows] = torch.where(m == -torch.inf, torch.zeros_like(m), m)
        inv_all[:, :, rows] = inv
    return (out, m_all, inv_all) if stats else out


def _inputs(rng, S, D, lengths, H=2):
    """fp32 q, k, v [B, H, S, D] and a key-padding bias [B, 1, 1, S]
    keeping ``lengths[b]`` keys of row b (0: a fully masked row)."""
    B = len(lengths)
    f = lambda: torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
    pad = np.arange(S)[None, :] >= np.asarray(lengths)[:, None]
    bias = torch.from_numpy(np.where(pad, NEG, 0.0).astype(np.float32)[:, None, None, :])
    return f(), f(), f(), bias


def _lengths(rng, S, masked=True):
    """A full row, a random length and (``masked``) a fully masked row."""
    return (S, int(rng.randint(1, S)), 0) if masked else (S, int(rng.randint(1, S)))


def _err(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float((got - want).abs().max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S,D", [(256, 16), (256, 64), (300, 16), (777, 32)])
def test_fp32_many_query_algorithm_matches_plain(S, D, rate):
    """The emulated forward against the plain version, random key lengths
    per row and one fully masked row, with and without the bias: S = 256
    and ragged S (a last query block and key tile cut short)."""
    rng = np.random.RandomState(S + D)
    q, k, v, bias = _inputs(rng, S, D, _lengths(rng, S))
    scale = D ** -0.5
    for b in (bias, None):
        got = many_forward_f32(q, k, v, b, 17, scale, rate)
        want = pt_attn.composed_attention_dropout(q, k, v, b, 17, scale, rate)
        assert _err(got, want) <= TOL


def test_one_tf32_pass_does_not_hold_the_tolerance():
    """Three TF32 products a product hold ``TOL``; one does not."""
    rng = np.random.RandomState(3)
    q, k, v, bias = _inputs(rng, 256, 16, _lengths(rng, 256))
    want = pt_attn.composed_attention(q, k, v, bias, 0.25)
    err3, err1 = (_err(many_forward_f32(q, k, v, bias, 0, 0.25, 0.0, passes=n), want)
                  for n in (3, 1))
    assert err3 <= TOL < err1, (err3, err1)


def test_a_fully_masked_row_averages_v():
    """Every real key at finfo.min: the online softmax keeps m = finfo.min
    and weighs every real key alike, as the plain version and ``_NEG`` do."""
    rng = np.random.RandomState(5)
    q, k, v, bias = _inputs(rng, 130, 16, (0, 70))
    got = many_forward_f32(q, k, v, bias, 0, 0.25, 0.0)
    assert _err(got[0], v[0].mean(1, keepdim=True).expand_as(got[0])) <= TOL


@pytest.mark.parametrize("S,D,masked", [(256, 16, True), (256, 64, False), (300, 32, False)])
def test_fp32_many_query_algorithm_matches_pallas_at_rate0(S, D, masked):
    """Against JAX's ``flash_attention`` in fp32 (the Pallas forward in
    interpret mode). A fully masked row only where Pallas pads no keys
    (S = 256): its padded keys would join that row's average."""
    rng = np.random.RandomState(S + D + 1)
    q, k, v, bias = _inputs(rng, S, D, _lengths(rng, S, masked))
    scale = D ** -0.5
    J = lambda t: jnp.asarray(t.numpy())
    want = torch.from_numpy(np.array(jax_attn.flash_attention(J(q), J(k), J(v), J(bias),
                                                                scale)))
    assert _err(many_forward_f32(q, k, v, bias, 0, scale, 0.0), want) <= TOL


class _Launches:
    """Stands in for the card: the wrappers' checks and stream, and every
    kernel's launch, recorded by kernel name, on ``meta`` tensors."""

    def __init__(self, monkeypatch):
        self.names = []
        monkeypatch.setattr(pt_attn, "_check", lambda fn, q, k, v, bias, extra=None:
                            (*q.shape[:3], k.shape[2], q.shape[3]))
        monkeypatch.setattr(pt_attn, "_stream", lambda t: None)
        monkeypatch.setattr(pt_attn.Kernel, "launch",
                            lambda kernel, *args: self.names.append(kernel.name))

    def take(self):
        names, self.names = self.names, []
        return names


def test_the_router_sends_many_fp32_queries_to_the_many_query_forward(monkeypatch):
    """fp32 from ``FP32_MANY_QUERY_MIN`` queries: K3 and K4 on the fp32
    many-query forward (``attention_many_f32.cu``), which with ``for_grad``
    keeps (the statistics, None, the keep bits or None at rate 0) and
    without it nothing; K5 on the fp32 many-query backward
    (``attention_many_bwd_f32.cu``), counted as ``attention_bwd_many``, from
    those or, without them, after its forward; fewer fp32 queries the
    cluster bodies; bf16 its own bodies, the many-query ones from
    ``MANY_QUERY_MIN``. The CPU takes the plain version either way."""
    n = pt_attn.FP32_MANY_QUERY_MIN
    assert pt_attn.KERNEL_MANY.source == pt_attn.DROPOUT_KERNEL_MANY.source == "attention_many_f32.cu"
    assert (pt_attn.BWD_KERNEL_MANY.source, pt_attn.BWD_KERNEL_MANY.symbol) == (
        "attention_many_bwd_f32.cu", "r3d_attention_bwd_many_f32")
    assert pt_attn.BWD_KERNEL_MANY.name == "attention_bwd_many"
    rng = np.random.RandomState(2)
    q, k, v, bias = _inputs(rng, n, 16, (n, 7))
    assert torch.equal(pt_attn.flash_attention(q, k, v, bias, 0.25),
                       pt_attn.composed_attention(q, k, v, bias, 0.25))

    launches = _Launches(monkeypatch)
    meta = lambda Lq, Lk=300, dtype=torch.float32: [
        torch.empty(2, 2, L, 16, dtype=dtype, device="meta") for L in (Lq, Lk, Lk)]
    bias = torch.zeros(2, 1, 1, 300, device="meta")
    for Lq, fwd, drop, bwd in (
            (n, "flash_attention_many", "flash_attention_dropout_many", "attention_bwd_many"),
            (300, "flash_attention_many", "flash_attention_dropout_many", "attention_bwd_many"),
            (n - 1, "flash_attention", "flash_attention_dropout", "attention_bwd"),
            (8, "flash_attention", "flash_attention_dropout", "attention_bwd")):
        q, k, v = meta(Lq)
        g = torch.empty_like(q)
        many = Lq >= n
        assert pt_attn.fp32_many_query(q) == many and not pt_attn.many_query(q)
        kept = pt_attn._attention_fwd(q, k, v, bias, 0.25, for_grad=True)[1]
        _, kept_drop = pt_attn._attention_fwd_dropout(q, k, v, bias, 3, 0.25, 0.1, for_grad=True)
        assert pt_attn._attention_fwd(q, k, v, bias, 0.25)[1] is None
        assert pt_attn._attention_fwd_dropout(q, k, v, bias, 3, 0.25, 0.1)[1] is None
        if many:
            stats, none, bits = kept
            assert stats.shape == (2, 4, Lq) and stats.dtype == torch.float32
            assert none is None and bits is None
            assert kept_drop[2].shape == pt_attn.keep_bits_shape(2, 2, Lq, 300)
            assert kept_drop[2].dtype == torch.int32
        else:
            assert kept is None and kept_drop is None
        pt_attn.attention_bwd(q, k, v, bias, 3, 0.25, 0.1, g, True, saved=kept_drop)
        assert launches.take() == [fwd, drop, fwd, drop, bwd], Lq
        pt_attn.attention_bwd(q, k, v, bias, 3, 0.25, 0.1, g, True)   # its forward first
        assert launches.take() == ([drop, bwd] if many else [bwd]), Lq
    for Lq, fwd in ((pt_attn.MANY_QUERY_MIN, "flash_attention_bf16_many"),
                    (20, "flash_attention_bf16")):
        q, k, v = meta(Lq, dtype=torch.bfloat16)
        assert not pt_attn.fp32_many_query(q)
        pt_attn._attention_fwd(q, k, v, bias, 0.25)
        assert launches.take() == [fwd]
