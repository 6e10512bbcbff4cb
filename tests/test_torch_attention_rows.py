"""The algorithms of the many-query bf16 attention bodies, on the CPU.

A bf16 call with at least ``MANY_QUERY_MIN`` queries (the gt-query FUTR's
decoder: S queries against S keys) takes ``csrc/attention_many.cu`` (K3 and
K4) and ``csrc/attention_many_bwd.cu`` (K5) on the card. Those kernels
cannot run here, but their algorithms can: PyTorch emulations with the
kernels' tile sizes and rounding points are held to the plain versions
(``composed_attention*``) and, at rate 0, to the JAX package's
``flash_attention`` and its backward (Pallas in interpret mode, as the JAX
tests run it), on the same inputs made with numpy from a seed.

- Forward: the keys in tiles of 64, an fp32 online softmax per row, the
  weights rounded to bf16 UNNORMALISED against the running max after the
  keep factor, l summing the unrounded weights, out = acc / l in bf16; for
  the backward each query's (m, 1 / l) and out in fp32 from the weights'
  bf16 high and low parts (out32).
- Backward, two launches, from what the forward kept: Dq = rowsum(g o
  out32) in fp32, dq over the key tiles of 64 with ds rounded to bf16
  before the product with K; dk, dv, dbias over query tiles of 64, dv from
  the weights times the keep mask as a bf16 high and a bf16 low part, dk
  from the rounded ds, dbias from the unrounded ds. (The kernels pass the
  keep mask from the forward to the backward as bits; the mask is the same
  hash of the element index either way.)

Tolerances, over each tensor's own largest entry: out, dq and dk 1e-2
(``SELF_TOL``, what the card holds the kernels to: the plain version rounds
the normalised weights where the kernel rounds the unnormalised ones, so a
weight, and an output, can land on the neighbouring bf16 value, 2**-8
relative; ds is rounded to bf16 before the dq and dk products, where the
plain version keeps it in fp32; 7.4e-3 read); dv 2**-8 (fp32-accurate
weights: only its own rounding; 2.3e-3 read); dbias 2e-6 (fp32 sums of the
unrounded ds in another order; 2.5e-7 read). Against Pallas, which rounds as
the plain version does, the same bounds.

The cases are spread over three files so that a run that gives each file
to one worker runs them side by side: the plain versions at S = 256 here,
at S = 300 in ``test_torch_attention_rows_long.py``, and Pallas in
``test_torch_attention_rows_pallas.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r3d_tpu_torch.ops import attention as pt_attn

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

TILE = 64   # keys per tile of the forward and of launch 1, queries per tile of launch 2
FWD_TOL = 1e-2   # chip_smoke.SELF_TOL
BWD_TOL = {"dq": FWD_TOL, "dk": FWD_TOL, "dv": 2.0 ** -8, "dbias": 2e-6}
NEG = np.finfo(np.float32).min


def _inputs(rng, B, H, S, D, lengths):
    """bf16 q, k, v, g [B, H, S, D] and an fp32 key-padding bias [B, 1, 1,
    S] keeping ``lengths[b]`` keys of row b (0: a fully masked row)."""
    f = lambda: torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32)).to(torch.bfloat16)
    pad = np.arange(S)[None, :] >= np.asarray(lengths)[:, None]
    bias = torch.from_numpy(np.where(pad, NEG, 0.0).astype(np.float32)[:, None, None, :])
    return f(), f(), f(), bias, f()


def _keep(seed, rate, shape):
    return pt_attn.dropout_keep(seed, rate, shape, "cpu") if rate > 0.0 else None


def _many_forward(q, k, v, bias, seed, scale, rate):
    """K3 (rate 0) or K4 as the many-query kernel computes them: (out, (m,
    1 / l, out32))."""
    s = pt_attn._scores(q, k, bias, scale)
    keep = _keep(seed, rate, s.shape)
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(q.shape)
    acc_lo = torch.zeros(q.shape)   # the weights' bf16 remainders times V
    for j0 in range(0, s.shape[-1], TILE):
        sl = slice(j0, j0 + TILE)
        st = s[..., sl]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.where(m_new == -torch.inf, torch.ones_like(m), torch.exp(m - m_new))
        p = torch.where(st == -torch.inf, 0.0, torch.exp(st - m_new[..., None]))
        l = l * corr + p.sum(-1)
        pk = p if keep is None else p * keep[..., sl]
        hi = pk.to(torch.bfloat16).float()
        lo = (pk - hi).to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", hi, v[:, :, sl].float())
        acc_lo = acc_lo * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", lo,
                                                         v[:, :, sl].float())
        m = m_new
    inv_l = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return (acc * inv_l[..., None]).to(q.dtype), (m, inv_l, (acc + acc_lo) * inv_l[..., None])


def _weights(s, m, inv_l):
    """P = exp(s - m) / l from the forward's statistics (0 where s = -inf)."""
    return torch.where(s == -torch.inf, 0.0, torch.exp(s - m[..., None]) * inv_l[..., None])


def _many_backward(q, k, v, bias, seed, scale, rate, g, stats, need_dbias=True):
    """K5 as the many-query kernel computes it from the forward's
    statistics: (dq, dk, dv, dbias [B, 1, 1, Lk] or None)."""
    m, inv_l, out32 = stats
    s = pt_attn._scores(q, k, bias, scale)
    keep = _keep(seed, rate, s.shape)
    if keep is None:
        keep = torch.ones_like(s)
    Lq, Lk = s.shape[-2:]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    bf = lambda x: x.to(torch.bfloat16).float()
    delta = (gf * out32).sum(-1)
    dq = torch.zeros(q.shape)
    for j0 in range(0, Lk, TILE):   # launch 1: each block's queries over the key tiles
        sl = slice(j0, j0 + TILE)
        p = _weights(s[..., sl], m, inv_l)
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf[:, :, sl])
        ds = p * (dp * keep[..., sl] - delta[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", bf(ds), kf[:, :, sl])
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    dbias = torch.zeros(s.shape[:2] + (Lk,))
    for i0 in range(0, Lq, TILE):   # launch 2: each block's keys over the query tiles
        sl = slice(i0, i0 + TILE)
        p = _weights(s[:, :, sl], m[:, :, sl], inv_l[:, :, sl])
        dp = torch.einsum("bhqd,bhkd->bhqk", gf[:, :, sl], vf)
        pk = p * keep[:, :, sl]
        ds = p * (dp * keep[:, :, sl] - delta[:, :, sl, None])
        hi = bf(pk)
        dv = dv + torch.einsum("bhqk,bhqd->bhkd", hi, gf[:, :, sl])
        dv = dv + torch.einsum("bhqk,bhqd->bhkd", bf(pk - hi), gf[:, :, sl])
        dk = dk + torch.einsum("bhqk,bhqd->bhkd", bf(ds), qf[:, :, sl])
        dbias = dbias + ds.sum(2)
    dbias = dbias.sum(1)[:, None, None, :] if need_dbias else None
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype), dbias


def _close(got, want, rel, name):
    if not isinstance(want, torch.Tensor):   # a JAX array
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * top, f"{name}: max|diff| {err:.3e} > {rel} * {top:.3e}"


# (S, D, lengths of the B = 2 rows): ragged key lengths; at S = 256 (no key
# padding in the Pallas kernel) a fully masked row
CASES = [(256, 16, (256, 0)), (256, 64, (200, 256)), (300, 16, (300, 123)),
         (300, 64, (77, 300))]


def check_against_plain(S, D, lengths, rate):
    """The emulated many-query forward and backward against the plain
    versions at one case."""
    rng = np.random.RandomState(S + D)
    q, k, v, bias, g = _inputs(rng, 2, 2, S, D, lengths)
    scale = D ** -0.5
    out, stats = _many_forward(q, k, v, bias, 31, scale, rate)
    assert out.dtype == torch.bfloat16
    _close(out, pt_attn.composed_attention_dropout(q, k, v, bias, 31, scale, rate), FWD_TOL,
           "out")
    got = _many_backward(q, k, v, bias, 31, scale, rate, g, stats)
    want = pt_attn.composed_attention_bwd(q, k, v, bias, 31, scale, rate, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype, name
        _close(a, b, BWD_TOL[name], name)
    no_dbias = _many_backward(q, k, v, bias, 31, scale, rate, g, stats, need_dbias=False)
    assert no_dbias[3] is None
    assert all(torch.equal(a, b) for a, b in zip(no_dbias[:3], got[:3]))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S,D,lengths", CASES[:2])
def test_many_query_algorithms_match_plain(S, D, lengths, rate):
    check_against_plain(S, D, lengths, rate)


def test_a_fully_masked_row_averages_v_and_keeps_its_weights():
    """Every real key at finfo.min, no key padding: the forward averages V
    over the keys, and the statistics keep 1 / l (not folded into m, where
    it would round away), so the backward's weights are 1 / Lk."""
    rng = np.random.RandomState(5)
    q, k, v, bias, g = _inputs(rng, 1, 2, 128, 16, (0,))
    out, (m, inv_l, out32) = _many_forward(q, k, v, bias, 0, 0.25, 0.0)
    assert torch.all(m == NEG) and torch.allclose(inv_l, torch.full_like(inv_l, 1 / 128))
    mean = v.float().mean(2, keepdim=True).expand_as(out)
    _close(out, mean, FWD_TOL, "out")
    got = _many_backward(q, k, v, bias, 0, 0.25, 0.0, g, (m, inv_l, out32))
    want = pt_attn.composed_attention_bwd(q, k, v, bias, 0, 0.25, 0.0, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(a, b, BWD_TOL[name], name)


def test_the_router_sends_many_bf16_queries_to_the_many_query_bodies():
    """bf16 with at least ``MANY_QUERY_MIN`` queries: the many-query bodies;
    fewer queries, or fp32, the bodies built for them. The CPU route is the
    plain version either way."""
    n = pt_attn.MANY_QUERY_MIN
    shape = lambda Lq: torch.empty(1, 1, Lq, 16, dtype=torch.bfloat16)
    assert pt_attn.many_query(shape(n)) and pt_attn.many_query(shape(3100))
    assert not pt_attn.many_query(shape(20)) and not pt_attn.many_query(shape(n - 1))
    assert not pt_attn.many_query(shape(n).float())
    rng = np.random.RandomState(2)
    q, k, v, bias, _ = _inputs(rng, 2, 1, n, 16, (n, 7))
    got = pt_attn.flash_attention(q, k, v, bias, 0.25)
    assert torch.equal(got, pt_attn.composed_attention(q, k, v, bias, 0.25))
