"""The port's native cross-attention against the JAX package's, on the CPU.

The plain versions of K6 and K7 (``r3d_tpu_torch/ops/cross_attention.py``)
against ``r3d_tpu.ops.cross_attention.cross_attention_native``, whose
Pallas kernels run in interpret mode off the TPU, on the same seeded numpy
inputs: the output, the softmax statistics and all four gradients.
Tolerances: fp32 the JAX test's own (2e-5 for values, 3e-4 for gradients,
``tests/test_attention_kernel.py``; read: 2.1e-7 and 2.4e-7); bf16 5e-3
of the tensor's largest entry (read: 9.8e-4), since the two sides round the
unnormalised weights to bf16 against different running maxima (JAX's key
blocks of 512, the port's final max), which moves a weight by at most one
bf16 step (2**-8 relative), and then round the result to bf16. The
routing rule is held to JAX's, and dropout (whose TPU bits cannot be
reproduced) to its invariants.

The bf16 CUDA kernel of K6 cannot run here, but its algorithm can: a short
PyTorch emulation (keys split across blocks of ``fwd_split_keys``, each
warp's private online softmax over its quarter of them in tiles of 32, the
warps and then the splits combined in order) is held to the plain version,
fp32 within 2e-6 and bf16 within one bf16 step of the largest entry; so
is K7's bf16 algorithm. The fp32 K6 and K7 cluster algorithms are
emulated in ``tests/test_torch_cross_attention_fp32.py`` (K6) and
``tests/test_torch_cross_attention_fp32_bwd.py`` (K7), files of their own so
that the test run's workers (``--dist loadfile``) share them out.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu.ops import cross_attention as jax_ca
from r3d_tpu_torch.ops import cross_attention as pt_ca

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

H, C, LQ = 4, 64, 20
SCALE = 0.25
BF16_TOL = 5e-3


def _inputs(rng, Lk, pad_from, B=2):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    pad = np.zeros((B, Lk), bool)
    for b, start in enumerate(pad_from):
        pad[b, start:] = True
    bias = np.where(pad, np.finfo(np.float32).min, 0.0).astype(np.float32)[:, None, None, :]
    return f(B, LQ, C), f(B, Lk, C), f(B, Lk, C), bias, f(B, LQ, C)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# (Lk, pad_from): a ragged Lk (the Pallas kernel pads it to 1024 with zero
# keys), and an Lk of whole key blocks with a fully masked row (only there
# do the two sides average the same keys: the Pallas kernel would average
# its pad keys into such a row)
CASES = [(777, (777, 700)), (1024, (1024, 0))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lk,pad_from", CASES)
def test_plain_kernels_match_pallas(Lk, pad_from, dtype):
    rng = np.random.RandomState(Lk)
    q, k, v, bias, w = _inputs(rng, Lk, pad_from)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    J = [jnp.asarray(x, jdt) for x in (q, k, v)] + [jnp.asarray(bias)]
    T = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    T.append(torch.from_numpy(bias).requires_grad_())

    out_j, m_j, l_j = jax_ca._cross_attention_fwd_impl(*J, 0, SCALE, 0.0, H, with_stats=True)
    out_p, m_p, l_p = pt_ca.composed_cross_attention(*[t.detach() for t in T], 0, SCALE, 0.0, H)
    # JAX's statistics carry the query axis padded to a multiple of 8
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j)[:, :, :LQ], atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(l_p.numpy(), np.asarray(l_j)[:, :, :LQ], atol=2e-5, rtol=1e-5)

    def loss(*args):
        return jnp.sum(jax_ca.cross_attention_native(*args, 0, SCALE, 0.0, H).astype(
            jnp.float32) * w)

    grads_j = jax.grad(loss, argnums=(0, 1, 2, 3))(*J)
    got = pt_ca.cross_attention_native(*T, 0, SCALE, 0.0, H)
    assert got.dtype == tdt and np.isfinite(got.float().detach().numpy()).all()
    (got.float() * torch.from_numpy(w)).sum().backward()

    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
        for name, t, g in zip("qkvb", T, grads_j):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=3e-4, rtol=0,
                                       err_msg=f"d{name}")
    else:
        assert _rel_err(got.detach().float(), out_j) <= BF16_TOL
        for name, t, g in zip("qkvb", T, grads_j):
            assert t.grad.dtype == (tdt if name != "b" else torch.float32)
            assert _rel_err(t.grad.float(), g) <= BF16_TOL, name


def test_plain_kernels_match_jax_composed_without_bias():
    """No bias at all: the JAX kernel's zero bias and the port's None agree."""
    rng = np.random.RandomState(5)
    q, k, v, _, _ = _inputs(rng, 600, (600, 600))
    want = jax_ca.cross_attention_native(*map(jnp.asarray, (q, k, v)), None, 0, SCALE, 0.0, H)
    got = pt_ca.cross_attention_native(*map(torch.from_numpy, (q, k, v)), None, 0, SCALE, 0.0, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


_GRID = [(Lq, Lk, C_, H_) for Lq in (1, 20, 64, 65) for Lk in (256, 512, 513, 3100)
         for C_, H_ in ((64, 4), (512, 8), (256, 8), (1024, 16), (2048, 32))]


@pytest.mark.parametrize("switch", [None, "R3D_CROSS_NATIVE", "R3D_FORCE_PALLAS"])
def test_eligibility_matches_jax_rule(switch, monkeypatch):
    """The port's rule on the card equals JAX's on a TPU (``pallas_enabled``
    and the backend stand in for it), with the switches set and unset; on
    the CPU the port never routes to the kernels. Every head dim of the grid
    (8, 16, 32, 64) passes JAX's D % 8 test; the port also needs D to be one
    it is built for, so D = 8 is refused there alone."""
    from r3d_tpu.ops import fuser_kernel as jax_fk

    for name in ("R3D_CROSS_NATIVE", "R3D_FORCE_PALLAS"):
        monkeypatch.delenv(name, raising=False)
    if switch:
        monkeypatch.setenv(switch, "1")
    monkeypatch.setattr(jax_fk, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jax_ca, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    routed = 0
    for Lq, Lk, C_, H_ in _GRID:
        for rate in (0.0, 0.1):
            want = jax_ca.cross_attention_native_eligible(Lq, Lk, C_, H_, rate)
            want = want and C_ // H_ in pt_ca.CROSS_HEAD_DIMS
            assert pt_ca.cross_attention_native_eligible(Lq, Lk, C_, H_, rate, cuda) is want, (
                Lq, Lk, C_, H_, rate)
            assert not pt_ca.cross_attention_native_eligible(Lq, Lk, C_, H_, rate, cpu)
            routed += want
    assert (routed > 0) is (switch is not None)
    monkeypatch.setenv("R3D_CROSS_NATIVE", "0")   # any value but "1" keeps it off
    if switch != "R3D_FORCE_PALLAS":
        assert not pt_ca.cross_attention_native_eligible(20, 3100, 512, 8, 0.0, cuda)


def test_dropout_keeps_its_rate_and_the_backward_redraws_the_mask():
    """The plain dropout forward drops weights at the rate (binomial bound),
    with ``composed_attention_dropout``'s mask in native layout; the plain
    backward equals autograd of that forward under the same seed only."""
    from r3d_tpu_torch.ops.attention import composed_attention_dropout, dropout_keep

    rng = np.random.RandomState(8)
    q, k, v, bias, _ = (torch.from_numpy(x) for x in _inputs(rng, 700, (700, 555)))
    rate, seed = 0.2, 99
    keep = dropout_keep(seed, rate, (2, H, LQ, 700), "cpu") > 0
    n = keep.numel()
    assert abs(float(keep.double().mean()) - (1 - rate)) < 5 * (rate * (1 - rate) / n) ** 0.5
    heads = lambda x: x.view(2, -1, H, C // H).transpose(1, 2)
    got = pt_ca.composed_cross_attention(q, k, v, bias, seed, SCALE, rate, H)[0]
    want = composed_attention_dropout(heads(q), heads(k), heads(v), bias, seed, SCALE, rate)
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 2).reshape(2, LQ, C).numpy(),
                               atol=1e-5, rtol=0)
    g = torch.from_numpy(rng.randn(2, LQ, C).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = pt_ca.composed_cross_attention(*leaves, seed, SCALE, rate, H)[0]
    want = torch.autograd.grad(out, leaves, g)
    for s, same in ((seed, True), (seed + 1, False)):
        got = torch.autograd.grad(pt_ca.cross_attention_native(*leaves, s, SCALE, rate, H),
                                  leaves, g)
        if same:
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert float((got[2] - want[2]).abs().max()) > 1e-2


def test_wrapper_takes_plain_version_only_on_cpu():
    q = torch.zeros(1, 20, 64, device="meta")
    k = torch.zeros(1, 600, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pt_ca.cross_attention_native(q, k, k, None, 0, 0.25, 0.0, 4)


# ---- the split-key algorithm of the bf16 CUDA kernel, emulated ----

N_WARPS, TILE_KEYS = 4, 32   # csrc/cross_attention.cu: NW, KT


def _combine(parts):
    """(m, l, acc) of partial softmaxes, summed in the order given: a part
    with no key (m = -inf) weighs 0."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = torch.where(m_i == -torch.inf, torch.zeros_like(m), torch.exp(m_i - m))
        l = l + l_i * w
        acc = acc + acc_i * w[..., None]
    return m, l, acc


def _split_forward(q, k, v, bias, seed, scale, rate, H, split_keys):
    """K6 as its bf16 kernel computes it with ``split_keys`` keys a block:
    (out, m, l)."""
    from r3d_tpu_torch.ops.attention import dropout_keep

    s = pt_ca._scores(q, k, bias, scale, H)
    keep = dropout_keep(seed, rate, s.shape, q.device) if rate > 0.0 else None
    vh = pt_ca._heads(v, H)
    S = s.shape[-1]
    splits = []
    warp_keys = split_keys // N_WARPS
    for s0 in range(0, S, split_keys):
        warps = []
        for w0 in range(s0, s0 + split_keys, warp_keys):
            m = torch.full(s.shape[:-1], -torch.inf)
            l = torch.zeros(s.shape[:-1])
            acc = torch.zeros(s.shape[:-1] + (vh.shape[-1],))
            for t0 in range(w0, min(w0 + warp_keys, S), TILE_KEYS):
                sl = slice(t0, min(t0 + TILE_KEYS, S))
                m_new = torch.maximum(m, s[..., sl].amax(-1))
                corr = torch.exp(m - m_new)
                e = torch.exp(s[..., sl] - m_new[..., None])
                l = l * corr + e.sum(-1)
                if keep is not None:
                    e = e * keep[..., sl]
                acc = acc * corr[..., None] + torch.einsum(
                    "bhqk,bhkd->bhqd", e.to(v.dtype).float(), vh[:, :, sl])
                m = m_new
            warps.append((m, l, acc))
        splits.append(_combine(warps))
    m, l, acc = _combine(splits)
    out = acc * torch.where(l > 0, 1.0 / l, torch.zeros_like(l))[..., None]
    return pt_ca._native(out).to(q.dtype), m, l


# (S, first padded key per batch row, SMs of the card): the SM count sets the
# split size. Ragged, 7 splits of 128 with a last one of 9 keys; whole splits
# of 256 with rows whose later splits are all masked and a fully masked row;
# one split whose warps walk 8 tiles each; S below one split; a last split of
# one key
SPLIT_CASES = [(777, (777, 700, 300), 132), (1024, (1024, 10, 0), 24),
               (1024, (1024, 300, 0), 6), (100, (100, 37, 0), 132), (257, (257, 256, 1), 132)]


def test_split_size_keeps_every_block_resident():
    """Whole units of 128 keys, never more splits than blocks that fit the
    card at once, and the 50salads shape's four splits of 896 on 132 SMs."""
    assert pt_ca.fwd_split_keys(3100, 64, 132) == 896
    for S in (1, 31, 257, 777, 1024, 3100):
        for heads in (1, 12, 64, 1000):
            for n_sm in (6, 24, 132):
                split = pt_ca.fwd_split_keys(S, heads, n_sm)
                assert split % pt_ca.FWD_SPLIT_UNIT == 0 and split >= pt_ca.FWD_SPLIT_UNIT
                resident = max(1, pt_ca.FWD_BLOCKS_PER_SM * n_sm // heads)
                assert -(-S // split) <= resident


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq", [20, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,pad_from,n_sm", SPLIT_CASES)
def test_split_key_forward_matches_plain(S, pad_from, n_sm, dtype, Lq, rate):
    rng = np.random.RandomState(S + Lq)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.randn(3, L, C).astype(np.float32)).to(tdt)
               for L in (Lq, S, S))
    pad = np.arange(S)[None, :] >= np.asarray(pad_from)[:, None]
    bias = torch.from_numpy(
        np.where(pad, np.finfo(np.float32).min, 0.0).astype(np.float32)[:, None, None, :])
    split_keys = pt_ca.fwd_split_keys(S, 3 * H, n_sm)
    got = _split_forward(q, k, v, bias, 17, SCALE, rate, H, split_keys)
    want = pt_ca.composed_cross_attention(q, k, v, bias, 17, SCALE, rate, H)
    assert torch.isfinite(got[0].float()).all()
    big = float(want[0].float().abs().max())
    tol = 2e-6 * max(1.0, big) if dtype == "float32" else big * 2.0 ** -7
    assert float((got[0].float() - want[0].float()).abs().max()) <= tol
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got[2], want[2], atol=1e-6, rtol=2e-6)


# ---- the split-key algorithm of K7's bf16 CUDA kernel, emulated ----

BWD_TILE = pt_ca.BWD_TILE_KEYS


def _hi_lo(x):
    """x as the sum of a bf16 high and a bf16 low part, each held in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_backward(q, k, v, bias, seed, scale, rate, H, g, o, m, l, split_keys, parts=2):
    """K7 as its bf16 kernel computes it with ``split_keys`` keys a block:
    (dq, dk, dv, dbias). Each block walks its keys in tiles of 64; a tile's
    dk = ds_r^T q and dv = (w keep)^T g are complete there, dv from the high
    and low bf16 parts of the fp32 w * keep (``parts=1``: the high part
    alone); the block's dq sums over its tiles in order, the splits' dq are
    summed in split order, each head's column sums of the unrounded ds in
    head order."""
    from r3d_tpu_torch.ops.attention import dropout_keep

    s = pt_ca._scores(q, k, bias, scale, H)
    S = s.shape[-1]
    w = torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None]
    keep = dropout_keep(seed, rate, s.shape, q.device) if rate > 0.0 else torch.ones_like(s)
    qh, kh, vh, gh, oh = (pt_ca._heads(x, H) for x in (q, k, v, g, o))
    delta = (gh * oh).sum(-1)
    ds = w * (torch.einsum("bhqd,bhkd->bhqk", gh, vh) * keep - delta[..., None])
    ds_r = ds.to(q.dtype).float()
    wk = _hi_lo(w * keep)[:parts]
    dk, dv = torch.zeros(kh.shape), torch.zeros(vh.shape)
    dq = torch.zeros(qh.shape)
    for s0 in range(0, S, split_keys):
        dq_split = torch.zeros(qh.shape)
        for t0 in range(s0, min(s0 + split_keys, S), BWD_TILE):
            sl = slice(t0, min(t0 + BWD_TILE, S))
            dk[:, :, sl] = torch.einsum("bhqk,bhqd->bhkd", ds_r[..., sl], qh) * scale
            for part in reversed(wk):   # the low part first
                dv[:, :, sl] += torch.einsum("bhqk,bhqd->bhkd", part[..., sl], gh)
            dq_split += torch.einsum("bhqk,bhkd->bhqd", ds_r[..., sl], kh[:, :, sl])
        dq = dq + dq_split * scale
    dbias = torch.zeros(s.shape[0], S)
    for h in range(H):
        dbias = dbias + ds[:, h].sum(1)
    return (pt_ca._native(dq).to(q.dtype), pt_ca._native(dk).to(k.dtype),
            pt_ca._native(dv).to(v.dtype), dbias[:, None, None, :])


def _bwd_inputs(rng, S, Lq, pad_from, dtype, seed, rate):
    """q, k, v, bias, g and the plain forward's (out, m, l)."""
    tdt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(rng.randn(len(pad_from), L, C).astype(np.float32)).to(tdt)
                  for L in (Lq, S, S, Lq))
    pad = np.arange(S)[None, :] >= np.asarray(pad_from)[:, None]
    bias = torch.from_numpy(
        np.where(pad, np.finfo(np.float32).min, 0.0).astype(np.float32)[:, None, None, :])
    out, m, l = pt_ca.composed_cross_attention(q, k, v, bias, seed, SCALE, rate, H)
    return q, k, v, bias, g, out, m, l


# (S, first padded key per batch row, SMs of the card): one key and a fully
# masked row; less than a tile; a last tile of one key; 4 splits of 256 where
# a row's later splits are all masked; 17 splits of 192 at the 50salads keys
BWD_SPLIT_CASES = [(1, (1, 1, 0), 132), (31, (31, 5, 0), 132), (65, (65, 64, 1), 24),
                   (777, (777, 100, 0), 24), (3100, (3100, 10, 0), 132)]


def test_bwd_split_size_keeps_every_block_resident():
    """Whole tiles of 64 keys, never more splits than blocks that fit the
    card at once, and the 50salads shape's four splits of 832 on 132 SMs."""
    assert pt_ca.bwd_split_keys(3100, 64, 132) == 832
    for S in (1, 31, 65, 777, 1024, 3100):
        for heads in (1, 12, 64, 1000):
            for n_sm in (6, 24, 132):
                split = pt_ca.bwd_split_keys(S, heads, n_sm)
                assert split % BWD_TILE == 0 and split >= BWD_TILE
                resident = max(1, pt_ca.BWD_BLOCKS_PER_SM * n_sm // heads)
                assert -(-S // split) <= resident


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq", [8, 20, 33, 64])
@pytest.mark.parametrize("S,pad_from,n_sm", BWD_SPLIT_CASES)
def test_split_key_backward_matches_plain(S, pad_from, n_sm, Lq, dtype, rate):
    """fp32 within 2e-6 of each gradient's largest entry, but dv within 2**-14
    (the two bf16 parts of w * keep: about 2**-16 relative); bf16 within one
    bf16 step of the largest entry."""
    rng = np.random.RandomState(S + Lq)
    q, k, v, bias, g, out, m, l = _bwd_inputs(rng, S, Lq, pad_from, dtype, 31, rate)
    split_keys = pt_ca.bwd_split_keys(S, len(pad_from) * H, n_sm)
    got = _split_backward(q, k, v, bias, 31, SCALE, rate, H, g, out, m, l, split_keys)
    want = pt_ca.composed_cross_attention_bwd(q, k, v, bias, 31, SCALE, rate, H, g, out, m, l)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype and torch.isfinite(a.float()).all(), name
        big = float(b.float().abs().max())
        if dtype == "bfloat16" and name != "dbias":
            tol = big * 2.0 ** -7
        else:
            tol = (2.0 ** -14 if name == "dv" else 2e-6) * max(1.0, big)
        assert float((a.float() - b.float()).abs().max()) <= tol, name


def test_split_key_backward_dv_needs_both_parts_of_w_keep():
    """dv from the high part of w * keep alone (one bf16 product) lands
    outside the 2**-14 that the two parts keep, in fp32 and at the 50salads
    query count: the low part is what keeps dv's rounding point where the
    TPU kernel has it (fp32 w * keep)."""
    rng = np.random.RandomState(5)
    q, k, v, bias, g, out, m, l = _bwd_inputs(rng, 777, 20, (777, 300, 500), "float32", 3, 0.1)
    want = pt_ca.composed_cross_attention_bwd(q, k, v, bias, 3, SCALE, 0.1, H, g, out, m, l)[2]
    big = float(want.abs().max())
    errs = [float((_split_backward(q, k, v, bias, 3, SCALE, 0.1, H, g, out, m, l, 256,
                                   parts)[2] - want).abs().max()) for parts in (2, 1)]
    assert errs[0] <= 2.0 ** -14 * big < errs[1], errs
