"""The port's plain kernel versions against the JAX package's Pallas kernels.

The port's kernel wrappers (``ops/fuser_kernel.py``, ``ops/fuser_kernel_bwd.py``,
``ops/attention.py``) take their plain PyTorch version for CPU tensors.
Here they are held against the Pallas kernels, which off the TPU run in
interpret mode (as ``tests/test_fuser_kernel.py`` runs them), on the same
inputs made with numpy from a seed. Tolerance 2e-5 absolute for outputs:
both sides are fp32 and differ only in summation order; gradients summed
over rows are held to 2e-5 relative to their largest entry. The attention
dropout mask cannot reproduce the TPU's PRNG bits, so the dropout kernels
are held to Pallas at rate 0 (the PRNG-free path) and checked by their
invariants otherwise. The CUDA kernels themselves are held against the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The bf16 CUDA kernel of K5 cannot run here, but its algorithm can: a short
PyTorch emulation (keys split across blocks of ``BWD_BLOCK_KEYS`` that own
their dk, dv and dbias, the softmax statistics from a first pass per block,
dq summed over the blocks' partials in order) is held to the plain version,
fp32 within 2e-6 and bf16 within one bf16 step of the largest entry. So is
the algorithm of K3's and K4's bf16 kernel (keys split into runs of
``fwd_split_keys``, the runs' softmax statistics combined in order before
the normalised weights are rounded, the runs' partials summed in order),
and so are those of K3's and K5's fp32 kernels (keys split into runs of
``fp32_split_keys`` walked in tiles of 64 with an online softmax, the runs'
statistics combined in rank order: K3's partial outputs flash-decoding
style, K4's the same with the keep mask in the partial outputs only, K5's
(m, l, D) before any gradient, each run owning dk, dv and dbias of its
keys, the runs' dq summed in rank order), within 2e-6. K1's and K2's
3xTF32 products are emulated too, K2 with its two phases (the row phase's
tiles, the weight gradients' splits): within 1e-4 of the plain versions,
where one TF32 pass is not.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from r3d_tpu.models.fuser import bottomk_mask as jax_bottomk_mask
from r3d_tpu.ops import attention as jax_attn
from r3d_tpu.ops import fuser_kernel as jax_fk
from r3d_tpu.ops import fuser_kernel_bwd as jax_fkb
from r3d_tpu_torch.models.fuser import bottomk_mask
from r3d_tpu_torch.models.layers import MultiheadAttention
from r3d_tpu_torch.ops import attention as pt_attn
from r3d_tpu_torch.ops import fuser_kernel as pt_fk
from r3d_tpu_torch.ops import fuser_kernel_bwd as pt_fkb

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

ATOL = 2e-5


def _fuser_inputs(rng, N, C, Ch):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    blend = {
        "scale_r": f(C) * 0.5 + 1.0, "shift_r": f(C) * 0.3,
        "scale_d": f(C) * 0.5 + 1.0, "shift_d": f(C) * 0.3,
        "mask_r": (rng.rand(C) < 0.1).astype(np.float32),
        "mask_d": (rng.rand(C) < 0.1).astype(np.float32),
        "alpha": rng.rand(C).astype(np.float32),
    }
    tail = {  # flax layout: kernels are [in, out]
        "norm1_scale": f(C) * 0.3 + 1.0, "norm1_bias": f(C) * 0.3,
        "wvp": f(C, C) * 0.3, "proj_bias": f(C) * 0.3,
        "norm2_scale": f(C) * 0.3 + 1.0, "norm2_bias": f(C) * 0.3,
        "mlp1_kernel": f(C, Ch) * 0.3, "mlp1_bias": f(Ch) * 0.3,
        "mlp2_kernel": f(Ch, C) * 0.3, "mlp2_bias": f(C) * 0.3,
        "norm_out_scale": f(C) * 0.3 + 1.0, "norm_out_bias": f(C) * 0.3,
    }
    return f(N, C), f(N, C), blend, tail


def _port_tail(tail):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return pt_fk.FuserTailParams(
        norm1_scale=t(tail["norm1_scale"]), norm1_bias=t(tail["norm1_bias"]),
        wvp=t(tail["wvp"].T), proj_bias=t(tail["proj_bias"]),
        norm2_scale=t(tail["norm2_scale"]), norm2_bias=t(tail["norm2_bias"]),
        mlp1_weight=t(tail["mlp1_kernel"].T), mlp1_bias=t(tail["mlp1_bias"]),
        mlp2_weight=t(tail["mlp2_kernel"].T), mlp2_bias=t(tail["mlp2_bias"]),
        norm_out_scale=t(tail["norm_out_scale"]), norm_out_bias=t(tail["norm_out_bias"]),
    )


@pytest.mark.parametrize("N,C,Ch", [(77, 64, 256), (512, 64, 256), (300, 128, 512)],
                         ids=["ragged", "tile-multiple", "utkinects-width"])
def test_fused_bn_blend_tail_matches_pallas(N, C, Ch):
    rng = np.random.RandomState(N + C)
    r, d, blend, tail = _fuser_inputs(rng, N, C, Ch)
    want = jax_fk.fused_bn_blend_tail(
        jnp.asarray(r), jnp.asarray(d),
        jax_fk.BlendParams(**{k: jnp.asarray(v) for k, v in blend.items()}),
        jax_fk.FuserTailParams(**{k: jnp.asarray(v) for k, v in tail.items()}),
        False,
    )
    got = pt_fk.fused_bn_blend_tail(
        torch.from_numpy(r), torch.from_numpy(d),
        pt_fk.BlendParams(**{k: torch.from_numpy(v) for k, v in blend.items()}),
        _port_tail(tail),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_composed_bn_blend_matches_jax():
    rng = np.random.RandomState(3)
    r, d, blend, _ = _fuser_inputs(rng, 40, 64, 256)
    want = jax_fk.composed_bn_blend(
        jnp.asarray(r), jnp.asarray(d),
        jax_fk.BlendParams(**{k: jnp.asarray(v) for k, v in blend.items()}))
    got = pt_fk.composed_bn_blend(
        torch.from_numpy(r), torch.from_numpy(d),
        pt_fk.BlendParams(**{k: torch.from_numpy(v) for k, v in blend.items()}))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def _attention_inputs(rng, B, H, Lq, Lk, D, pad_from):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    pad = np.zeros((B, Lk), bool)
    for b, start in enumerate(pad_from):
        pad[b, start:] = True
    bias = np.where(pad, np.finfo(np.float32).min, 0.0).astype(np.float32)[:, None, None, :]
    return f(B, H, Lq, D), f(B, H, Lk, D), f(B, H, Lk, D), bias


@pytest.mark.parametrize("Lk,pad_from", [
    # a padded row, a full row, and a row with every key masked (both sides
    # then average V uniformly; at a Lk the Pallas kernel pads to a multiple
    # of 128 its zero keys would join that average, so only here)
    (256, (200, 256, 0)),
    (300, (300, 123, 1)),     # ragged Lk, and only key 0 valid
    (512, (512, 400, 37)),
])
def test_flash_attention_matches_pallas(Lk, pad_from):
    rng = np.random.RandomState(Lk)
    q, k, v, bias = _attention_inputs(rng, 3, 8, 8, Lk, 16, pad_from)
    want = jax_attn.flash_attention(*map(jnp.asarray, (q, k, v, bias)), 0.25)
    got = pt_attn.flash_attention(*map(torch.from_numpy, (q, k, v, bias)), 0.25)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_composed_attention_without_bias_matches_jax():
    rng = np.random.RandomState(9)
    q, k, v, _ = _attention_inputs(rng, 2, 4, 8, 40, 8, (40, 40))
    want = jax_attn.composed_attention(*map(jnp.asarray, (q, k, v)), None, 0.3)
    got = pt_attn.composed_attention(*map(torch.from_numpy, (q, k, v)), None, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("Lq,Lk,D,cuda,want", [
    (8, 128, 16, True, False),     # below the 256-key floor
    (8, 256, 16, True, True),
    (8, 512, 16, True, True),
    (8, 1024, 16, True, False),    # long-key cross-attention stays plain
    (2000, 2000, 16, True, True),  # self-attention keeps the kernel
    (8, 256, 16, False, False),    # never on the CPU
    (8, 256, 8, True, False),      # a head dim the kernel is not built for
])
def test_attention_router_matches_jax_rule(Lq, Lk, D, cuda, want):
    device = torch.device("cuda" if cuda else "cpu")
    assert pt_attn.attention_kernel_eligible(Lq, Lk, D, device) is want


@pytest.mark.parametrize("case", ["all-ties", "random", "partial-ties", "k-zero"])
def test_bottomk_mask_matches_jax(case):
    rng = np.random.RandomState(4)
    C, k = 128, 12
    scores = {
        "all-ties": np.ones(C, np.float32),
        "random": np.abs(rng.randn(C)).astype(np.float32),
        "partial-ties": np.round(rng.rand(C) * 4).astype(np.float32),
        "k-zero": rng.rand(C).astype(np.float32),
    }[case]
    if case == "k-zero":
        k = 0
    want = np.asarray(jax_bottomk_mask(jnp.asarray(scores), k))
    got = bottomk_mask(torch.from_numpy(scores), k).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "all-ties":  # the init case: |gamma| = 1 everywhere
        np.testing.assert_array_equal(np.nonzero(got)[0], np.arange(k))


def _rel_close(got, want, rel, name=""):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (name, err)


@pytest.mark.parametrize("outer", [False, True], ids=["no-outer", "outer-residual"])
@pytest.mark.parametrize("N,C,Ch", [(77, 64, 256), (300, 128, 512)],
                         ids=["ragged", "utkinects-width"])
def test_fused_safuser_tail_matches_pallas(N, C, Ch, outer):
    """K1's no-blend route (and the outer residual) against the Pallas
    kernel in interpret mode."""
    rng = np.random.RandomState(N + C + outer)
    r, d, _, tail = _fuser_inputs(rng, N, C, Ch)
    want = jax_fk.fused_safuser_tail(
        jnp.asarray(r), jnp.asarray(d),
        jax_fk.FuserTailParams(**{k: jnp.asarray(v) for k, v in tail.items()}), outer)
    got = pt_fk.fused_safuser_tail(torch.from_numpy(r), torch.from_numpy(d),
                                   _port_tail(tail), outer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("outer", [False, True], ids=["no-outer", "outer-residual"])
@pytest.mark.parametrize("N,C,Ch", [(77, 64, 256), (300, 128, 512)],
                         ids=["ragged", "utkinects-width"])
def test_fused_tail_bwd_matches_pallas(N, C, Ch, outer):
    """K2's plain version (autograd of the plain tail) against
    ``pallas_tail_bwd`` in interpret mode: dr, dd and the 12 gradients."""
    rng = np.random.RandomState(2 * N + C + outer)
    r, d, _, tail = _fuser_inputs(rng, N, C, Ch)
    g = rng.randn(N, C).astype(np.float32)
    dr_w, dd_w, dp_w = jax_fkb.pallas_tail_bwd(
        jnp.asarray(r), jnp.asarray(d), jnp.asarray(g),
        jax_fk.FuserTailParams(**{k: jnp.asarray(v) for k, v in tail.items()}), outer)
    dr, dd, dp = pt_fkb.fused_tail_bwd(torch.from_numpy(r), torch.from_numpy(d),
                                       torch.from_numpy(g), _port_tail(tail), outer)
    _rel_close(dr.numpy(), dr_w, 2e-5, "dr")
    _rel_close(dd.numpy(), dd_w, 2e-5, "dd")
    for name, got, want in zip(pt_fk.FuserTailParams._fields, dp, dp_w):
        want = np.asarray(want)
        if name in ("wvp", "mlp1_weight", "mlp2_weight"):
            want = want.T   # flax [in, out] -> torch [out, in]
        _rel_close(got.numpy(), want, 2e-5, name)


@pytest.mark.parametrize("Lk,pad_from", [(256, (200, 256, 9)), (300, (300, 123, 1)),
                                         (512, (512, 400, 37))])
def test_attention_dropout_and_bwd_at_rate0_match_pallas(Lk, pad_from):
    """K4 and K5's plain versions at rate 0 against ``_pallas_attention_dropout``
    and ``_pallas_attention_bwd`` in interpret mode (rate 0 never touches the
    TPU PRNG). No row is fully masked: Pallas pads keys to 128 and would
    average its zero pad keys into such a row."""
    rng = np.random.RandomState(Lk + 1)
    q, k, v, bias = _attention_inputs(rng, 3, 8, 8, Lk, 16, pad_from)
    g = rng.randn(*q.shape).astype(np.float32)
    J = lambda *xs: [jnp.asarray(x) for x in xs]
    T = lambda *xs: [torch.from_numpy(x) for x in xs]
    want = jax_attn._pallas_attention_dropout(*J(q, k, v, bias), 0, 0.25, 0.0)
    got = pt_attn.flash_attention_dropout(*T(q, k, v, bias), 0, 0.25, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    want = jax_attn._pallas_attention_bwd(*J(q, k, v, bias), 0, 0.25, 0.0, jnp.asarray(g))
    got = pt_attn.attention_bwd(*T(q, k, v, bias), 0, 0.25, 0.0, torch.from_numpy(g),
                                need_dbias=True)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _rel_close(a.numpy(), b, 2e-5, name)


def test_dropout_keep_rate_is_binomial():
    """The keep rate of 2**20 draws lies within 5 binomial standard
    deviations of 1 - p, for several rates and seeds."""
    n = 8 * 8 * 8 * 2048
    for rate in (0.1, 0.5):
        sd = (rate * (1 - rate) / n) ** 0.5
        for seed in (0, 1, 2 ** 31 - 2):
            kept = (pt_attn.dropout_keep(seed, rate, (8, 8, 8, 2048), "cpu") > 0).double().mean()
            assert abs(float(kept) - (1 - rate)) < 5 * sd, (rate, seed, float(kept))


def test_dropout_mask_is_a_function_of_seed_and_element_only():
    """Order of evaluation and tiling do not matter: the bits of a
    [B, H, Lq, Lk] mask are those of its flat element index, so any
    sub-block, drawn alone and in any order, gives the same bits; another
    seed gives an independent mask (agreement (1-p)^2 + p^2)."""
    shape = (2, 3, 8, 300)
    bits = pt_attn.dropout_bits(42, shape, "cpu")
    flat = pt_attn.dropout_bits(42, (bits.numel(),), "cpu")
    assert torch.equal(bits.reshape(-1), flat)
    assert torch.equal(pt_attn.dropout_bits(42, shape, "cpu"), bits)
    perm = torch.randperm(flat.numel(), generator=torch.Generator().manual_seed(0))
    again = pt_attn._fmix32((pt_attn._fmix32(perm ^ pt_attn._fmix32(42 ^ 0x5BD1E995))
                             + pt_attn._fmix32(42 ^ 0x5BD1E995)) & 0xFFFFFFFF)
    assert torch.equal(again, flat[perm])
    a = pt_attn.dropout_keep(42, 0.1, shape, "cpu") > 0
    b = pt_attn.dropout_keep(43, 0.1, shape, "cpu") > 0
    assert abs(float((a == b).double().mean()) - (0.9 ** 2 + 0.1 ** 2)) < 0.01


def test_dropout_backward_redraws_the_forward_mask():
    """The plain backward (what K5 computes) equals autograd of the plain
    dropout forward under the same seed, and not under another."""
    rng = np.random.RandomState(3)
    q, k, v, bias = (torch.from_numpy(x) for x in _attention_inputs(rng, 2, 4, 8, 300, 16,
                                                                    (300, 100)))
    g = torch.from_numpy(rng.randn(2, 4, 8, 16).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = pt_attn.composed_attention_dropout(*leaves, 11, 0.25, 0.3)
    want = torch.autograd.grad(out, leaves, g)
    got = pt_attn.composed_attention_bwd(q, k, v, bias, 11, 0.25, 0.3, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    other = pt_attn.composed_attention_bwd(q, k, v, bias, 12, 0.25, 0.3, g)
    assert float((other[2] - want[2]).abs().max()) > 1e-2
    got = torch.autograd.grad(pt_attn.flash_attention_dropout(*leaves, 11, 0.25, 0.3),
                              leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_multihead_attention_dropout_follows_train_mode():
    """In train mode the weights drop at the module's rate (the plain route
    on the CPU), draws from the module's generator, and eval mode is exact."""
    torch.manual_seed(0)
    m = MultiheadAttention(32, 4, dropout=0.5)
    q = torch.randn(2, 8, 32)
    kv = torch.randn(2, 300, 32)
    m.eval()
    ref = m(q, kv, kv)
    m.train()
    m.generator = torch.Generator().manual_seed(1)
    a = m(q, kv, kv)
    m.generator = torch.Generator().manual_seed(1)
    b = m(q, kv, kv)
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    m.dropout = 0.0
    torch.testing.assert_close(m(q, kv, kv), ref)


# ---- the key-block algorithm of K5's bf16 CUDA kernel, emulated ----

def _in_order(parts, zero):
    """Softmax statistics (m_i, *sums_i) combined in the order given, as the
    kernels combine their warps' and blocks': m = max m_i and each sum =
    sum_i sums_i exp(m_i - m); a part with no key (m_i = -inf) weighs 0."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    sums = [torch.zeros_like(x) for x in parts[0][1:]]
    for m_i, *sums_i in parts:
        w = torch.where(m_i == -torch.inf, zero, torch.exp(m_i - m))
        sums = [a + b * w.reshape(w.shape + (1,) * (b.dim() - w.dim()))
                for a, b in zip(sums, sums_i)]
    return (m, *sums)


def _keyblock_backward(q, k, v, bias, seed, scale, rate, g, query_tile=32, warp_keys=16):
    """K5 as its bf16 kernel computes it: (dq, dk, dv, dbias)."""
    KB = pt_attn.BWD_BLOCK_KEYS
    s = pt_attn._scores(q, k, bias, scale)
    Lq, Lk = s.shape[-2:]
    keep = (pt_attn.dropout_keep(seed, rate, s.shape, q.device) if rate > 0.0
            else torch.ones_like(s))
    gf = g.float()
    gv = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    zero = torch.zeros(s.shape[:-1])
    combine = lambda parts: _in_order(parts, zero)

    # first launch: each key block's (m_i, l_i, D-numerator), its warps in order
    stats = []
    for j0 in range(0, Lk, KB):
        warps = []
        for w0 in range(j0, j0 + KB, warp_keys):
            sl = slice(w0, min(w0 + warp_keys, Lk))
            if sl.start >= Lk:
                warps.append((torch.full_like(zero, -torch.inf), zero, zero))
                continue
            m_w = s[..., sl].amax(-1)
            p = torch.exp(s[..., sl] - m_w[..., None])
            warps.append((m_w, p.sum(-1), (p * keep[..., sl] * gv[..., sl]).sum(-1)))
        stats.append(combine(warps))
    # second launch: every block combines all statistics, owns its keys
    m, l, dn = combine(stats)
    inv_l = torch.where(l > 0, 1.0 / l, zero)
    drow = dn * inv_l
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    dbias = torch.zeros(s.shape[:2] + (Lk,))
    dq_parts = []
    for j0 in range(0, Lk, KB):
        sl = slice(j0, min(j0 + KB, Lk))
        w = torch.exp(s[..., sl] - m[..., None]) * inv_l[..., None]
        wk = w * keep[..., sl]
        ds = w * (keep[..., sl] * gv[..., sl] - drow[..., None])
        for q0 in range(0, Lq, query_tile):   # summed in registers over the query tiles
            qs = slice(q0, q0 + query_tile)
            dv[:, :, sl] += torch.einsum("bhqk,bhqd->bhkd", wk[:, :, qs], gf[:, :, qs])
            dk[:, :, sl] += torch.einsum("bhqk,bhqd->bhkd", ds[:, :, qs], q.float()[:, :, qs])
            dbias[:, :, sl] += ds[:, :, qs].sum(2)
        dq_parts.append(torch.einsum("bhqk,bhkd->bhqd", ds, k.float()[:, :, sl]) * scale)
    dq = torch.zeros(q.shape)
    for part in dq_parts:   # third launch: in block order
        dq = dq + part
    return (dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype),
            dbias.sum(1)[:, None, None, :])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq", [20, 33, 70])
@pytest.mark.parametrize("Lk,pad_from", [
    (300, (300, 123, 0)),     # ragged last block; a fully masked row
    (512, (512, 10, 37)),     # whole blocks; rows whose later blocks are all masked
    (31, (31, 5, 31)),        # less than one key block
    (65, (65, 64, 1)),        # a last block of one key
])
def test_keyblock_backward_matches_plain(Lk, pad_from, Lq, dtype, rate):
    rng = np.random.RandomState(Lk + Lq)
    tdt = getattr(torch, dtype)
    q, k, v, bias = (torch.from_numpy(x) for x in _attention_inputs(rng, 3, 4, Lq, Lk, 16,
                                                                    pad_from))
    g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    q, k, v, g = (t.to(tdt) for t in (q, k, v, g))
    got = _keyblock_backward(q, k, v, bias, 23, 0.25, rate, g)
    want = pt_attn.composed_attention_bwd(q, k, v, bias, 23, 0.25, rate, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype and torch.isfinite(a.float()).all(), name
        big = float(b.float().abs().max())
        tol = (2e-6 * max(1.0, big) if dtype == "float32" or name == "dbias"
               else big * 2.0 ** -7)
        assert float((a.float() - b.float()).abs().max()) <= tol, name


# ---- the split-key algorithm of K3/K4's bf16 CUDA kernel, emulated ----

def _split_key_forward(q, k, v, bias, seed, scale, rate, warps=4):
    """K3 (rate 0) or K4 as their bf16 kernel computes them: the keys split
    into runs of ``fwd_split_keys`` (one block each, ``warps`` warps that own
    a quarter each), every run's (m_i, l_i) combined in order into the row's
    (m, l) BEFORE any weight is rounded, the normalised weights rounded to
    V's type after the keep factor, and the runs' partials summed in order."""
    SK = pt_attn.fwd_split_keys(k.shape[2])
    s = pt_attn._scores(q, k, bias, scale)
    Lk = s.shape[-1]
    keep = (pt_attn.dropout_keep(seed, rate, s.shape, q.device) if rate > 0.0
            else torch.ones_like(s))
    zero = torch.zeros(s.shape[:-1])
    runs = [slice(j0, min(j0 + SK, Lk)) for j0 in range(0, Lk, SK)]
    combine = lambda parts: _in_order(parts, zero)

    stats = []
    for run in runs:   # each block's warps, in warp order
        parts = []
        for w0 in range(run.start, run.start + SK, SK // warps):
            sl = slice(w0, min(w0 + SK // warps, Lk))
            if sl.start >= Lk:
                parts.append((torch.full_like(zero, -torch.inf), zero))
                continue
            m_w = s[..., sl].amax(-1)
            parts.append((m_w, torch.exp(s[..., sl] - m_w[..., None]).sum(-1)))
        stats.append(combine(parts))
    m, l = combine(stats)   # the cluster's blocks, in rank order
    inv_l = torch.where(l > 0, 1.0 / l, zero)
    w = (torch.exp(s - m[..., None]) * inv_l[..., None] * keep).to(v.dtype).float()
    out = torch.zeros(q.shape)
    for run in runs:   # the blocks' partials, in rank order
        out = out + torch.einsum("bhqk,bhkd->bhqd", w[..., run], v.float()[:, :, run])
    return out.to(q.dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq", [20, 33, 70])
@pytest.mark.parametrize("Lk,pad_from", [
    (1, (1, 1, 0)),           # one key; a fully masked row
    (31, (31, 5, 0)),         # less than one warp's tile
    (65, (65, 64, 0)),        # a warp whose only key is masked
    (300, (300, 100, 0)),     # ragged last split; a row whose later splits are all masked
    (512, (512, 128, 0)),     # four whole splits; the last three of a row all masked
])
def test_split_key_attention_forward_matches_plain(Lk, pad_from, Lq, dtype, rate):
    rng = np.random.RandomState(Lk + 2 * Lq)
    tdt = getattr(torch, dtype)
    q, k, v, bias = (torch.from_numpy(x) for x in _attention_inputs(rng, 3, 4, Lq, Lk, 16,
                                                                    pad_from))
    q, k, v = (t.to(tdt) for t in (q, k, v))
    got = _split_key_forward(q, k, v, bias, 29, 0.25, rate)
    want = pt_attn.composed_attention_dropout(q, k, v, bias, 29, 0.25, rate)
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    big = float(want.float().abs().max())
    tol = 2e-6 * max(1.0, big) if dtype == "float32" else big * 2.0 ** -7
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_fwd_split_keys_fit_one_cluster():
    """The bf16 forwards' splits: whole tiles of 128 keys (one of 32 a warp),
    at most 8 a cluster; one tile a warp up to 1,024 keys, past that the
    smallest split that 8 blocks cover."""
    unit, most = pt_attn.FWD_SPLIT_UNIT, pt_attn.FWD_MAX_SPLITS
    for Lk in list(range(1, 2100, 7)) + [1024, 1025, 4096, 8191, 8192]:
        split = pt_attn.fwd_split_keys(Lk)
        assert split % unit == 0 and -(-Lk // split) <= most, Lk
        assert split == unit if Lk <= unit * most else (split - unit) * most < Lk, Lk


# ---- the cluster algorithms of K3's and K5's fp32 CUDA kernels, emulated ----

def _online_tile(state, st, *terms):
    """One tile of an online softmax: ``state`` (m, l, *sums), the tile's
    scores ``st`` [..., keys] and, per sum, a function of the tile's weights
    p = exp(st - m_new) giving its share; the old sums rescaled when the max
    grows, a key scoring -inf weighing 0."""
    m, l, *sums = state
    m_new = torch.maximum(m, st.amax(-1))
    corr = torch.where(m_new == -torch.inf, torch.ones_like(m), torch.exp(m - m_new))
    p = torch.where(st == -torch.inf, 0.0, torch.exp(st - m_new[..., None]))
    scaled = lambda x: x * corr.reshape(corr.shape + (1,) * (x.dim() - corr.dim()))
    return (m_new, l * corr + p.sum(-1), *(scaled(x) + f(p) for x, f in zip(sums, terms)))


def _cluster_forward(q, k, v, bias, scale, keep=None):
    """K3 in fp32 as its cluster kernel computes it: the keys split into runs
    of ``fp32_split_keys`` (one block each), each block walking its run in
    tiles of 64 keys with an online softmax (m_i, l_i, acc_i), then the
    blocks' statistics and partials combined in rank order, flash-decoding
    style, and the output normalised once. With ``keep`` (the scaled keep
    mask) K4: acc_i sums the kept weights times the keep factor, l_i every
    weight."""
    Lk = k.shape[2]
    SK, KT = pt_attn.fp32_split_keys(Lk), pt_attn.FP32_SPLIT_UNIT
    s = pt_attn._scores(q, k, bias, scale)
    zero = torch.zeros(s.shape[:-1])
    parts = []
    for j0 in range(0, Lk, SK):
        state = (torch.full_like(zero, -torch.inf), zero, torch.zeros(q.shape))
        for t0 in range(j0, min(j0 + SK, Lk), KT):
            sl = slice(t0, min(t0 + KT, Lk))
            kept = (lambda p: p) if keep is None else (lambda p, sl=sl: p * keep[..., sl])
            state = _online_tile(state, s[..., sl], lambda p, sl=sl, kept=kept: torch.einsum(
                "bhqk,bhkd->bhqd", kept(p), v[:, :, sl]))
        parts.append(state)
    _, l, acc = _in_order(parts, zero)
    return torch.where(l[..., None] > 0, acc / l[..., None], 0.0)


def _cluster_backward(q, k, v, bias, seed, scale, rate, g):
    """K5 in fp32 as its cluster kernel computes it: (dq, dk, dv, dbias).
    Per block (a run of ``fp32_split_keys`` keys), each of its two warps
    keeps (m, l, D-numerator) online over the run's tiles of 64 keys (keys
    32w .. 32w + 31 of each tile); the warps are combined in warp order,
    then the cluster's blocks in rank order; each block owns dk, dv and
    dbias of its keys, summed over the query tiles of 8; dq is the blocks'
    shares summed in rank order."""
    Lq, Lk = q.shape[2], k.shape[2]
    SK, KT, QT = pt_attn.fp32_split_keys(Lk), pt_attn.FP32_SPLIT_UNIT, pt_attn.FP32_QUERY_TILE
    s = pt_attn._scores(q, k, bias, scale)
    keep = (pt_attn.dropout_keep(seed, rate, s.shape, q.device) if rate > 0.0
            else torch.ones_like(s))
    gv = torch.einsum("bhqd,bhkd->bhqk", g, v)
    zero = torch.zeros(s.shape[:-1])
    blocks = [slice(j0, min(j0 + SK, Lk)) for j0 in range(0, Lk, SK)]
    stats = []
    for blk in blocks:
        warps = []
        for w in range(KT // 32):
            state = (torch.full_like(zero, -torch.inf), zero, zero)
            for t0 in range(blk.start, blk.stop, KT):
                sl = slice(t0 + 32 * w, min(t0 + 32 * w + 32, blk.stop))
                if sl.start < sl.stop:   # else every key of the warp scores -inf
                    state = _online_tile(state, s[..., sl],
                                         lambda p: (p * keep[..., sl] * gv[..., sl]).sum(-1))
            warps.append(state)
        stats.append(_in_order(warps, zero))
    m, l, dn = _in_order(stats, zero)
    inv_l = torch.where(l > 0, 1.0 / l, zero)
    w = torch.where(s == -torch.inf, 0.0, torch.exp(s - m[..., None]) * inv_l[..., None])
    ds = w * (keep * gv - (dn * inv_l)[..., None])
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    dbias = torch.zeros(s.shape[:2] + (Lk,))
    dq = torch.zeros(q.shape)
    for blk in blocks:
        for q0 in range(0, Lq, QT):   # summed over the query tiles
            qs = slice(q0, q0 + QT)
            dv[:, :, blk] += torch.einsum("bhqk,bhqd->bhkd", (w * keep)[:, :, qs, blk],
                                          g[:, :, qs])
            dk[:, :, blk] += torch.einsum("bhqk,bhqd->bhkd", ds[:, :, qs, blk], q[:, :, qs])
            dbias[:, :, blk] += ds[:, :, qs, blk].sum(2)
    for blk in blocks:   # the blocks' shares of dq, in rank order
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds[..., blk], k[:, :, blk])
    return dq * scale, dk * scale, dv, dbias.sum(1)[:, None, None, :]


CLUSTER_CASES = [
    (1, (1, 1, 0)),           # one key; a fully masked row
    (31, (31, 5, 31)),        # less than one tile of 64
    (65, (65, 64, 1)),        # a last split of one key
    (300, (300, 123, 0)),     # ragged last split; a fully masked row
    (512, (512, 10, 37)),     # 8 whole splits; rows whose later splits are all masked
    (1100, (1100, 700, 0)),   # splits of three tiles (the ring); a fully masked row
]


@pytest.mark.parametrize("Lq", [8, 20])
@pytest.mark.parametrize("Lk,pad_from", CLUSTER_CASES)
def test_cluster_attention_forward_matches_plain(Lk, pad_from, Lq):
    rng = np.random.RandomState(Lk + 3 * Lq)
    q, k, v, bias = (torch.from_numpy(x) for x in _attention_inputs(rng, 3, 4, Lq, Lk, 16,
                                                                    pad_from))
    got = _cluster_forward(q, k, v, bias, 0.25)
    want = pt_attn.composed_attention(q, k, v, bias, 0.25)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-6 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("Lq", [8, 20])
@pytest.mark.parametrize("Lk,pad_from", CLUSTER_CASES)
def test_cluster_attention_dropout_forward_matches_plain(Lk, pad_from, Lq):
    """fp32 K4 as the cluster kernel computes it (K3's algorithm with the
    keep mask folded into each block's acc_i, not into l_i) against the
    plain dropout forward at p = 0.1."""
    rng = np.random.RandomState(Lk + 7 * Lq)
    q, k, v, bias = (torch.from_numpy(x) for x in _attention_inputs(rng, 3, 4, Lq, Lk, 16,
                                                                    pad_from))
    seed = 17 + Lk
    keep = pt_attn.dropout_keep(seed, 0.1, (3, 4, Lq, Lk), "cpu")
    got = _cluster_forward(q, k, v, bias, 0.25, keep)
    want = pt_attn.composed_attention_dropout(q, k, v, bias, seed, 0.25, 0.1)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-6 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq", [8, 20])
@pytest.mark.parametrize("Lk,pad_from", CLUSTER_CASES)
def test_cluster_backward_matches_plain(Lk, pad_from, Lq, rate):
    rng = np.random.RandomState(Lk + 5 * Lq)
    q, k, v, bias = (torch.from_numpy(x) for x in _attention_inputs(rng, 3, 4, Lq, Lk, 16,
                                                                    pad_from))
    g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    got = _cluster_backward(q, k, v, bias, 31, 0.25, rate, g)
    want = pt_attn.composed_attention_bwd(q, k, v, bias, 31, 0.25, rate, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= 2e-6 * max(1.0, float(b.abs().max())), name


def test_cluster_backward_gives_zeros_under_an_all_inf_bias():
    """A row whose every score is -inf: l = 0 in every block, and the
    gradients are 0, not NaN (the forward gives 0 too)."""
    rng = np.random.RandomState(4)
    q, k, v, _ = (torch.from_numpy(x) for x in _attention_inputs(rng, 1, 2, 8, 300, 16, (300,)))
    bias = torch.full((1, 1, 1, 300), -torch.inf)
    g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    assert torch.equal(_cluster_forward(q, k, v, bias, 0.25), torch.zeros_like(q))
    for x in _cluster_backward(q, k, v, bias, 3, 0.25, 0.1, g):
        assert torch.equal(x, torch.zeros_like(x))


def test_fp32_split_keys_fit_one_cluster():
    """The fp32 K3 and K5 splits, for every key count the router sends to
    them (any head dim, the self-attention route's longest included): whole
    tiles of 64, at most 8 a cluster, every split holding a key; one tile a
    split, so one copy a block, up to 512 keys (the utkinects buckets); past
    that the smallest split that 8 blocks cover."""
    cuda = torch.device("cuda")
    admitted = [Lk for Lk in range(1, 40000)
                if any(pt_attn.attention_kernel_eligible(Lk, Lk, D, cuda)
                       for D in pt_attn.KERNEL_HEAD_DIMS)]
    assert admitted[0] == 256 and admitted[-1] == 32768
    unit, most = pt_attn.FP32_SPLIT_UNIT, pt_attn.FWD_MAX_SPLITS
    for Lk in range(1, admitted[-1] + 1):
        split = pt_attn.fp32_split_keys(Lk)
        n = -(-Lk // split)
        assert split % unit == 0 and n <= most and (n - 1) * split < Lk, Lk
        assert split == unit if Lk <= unit * most else (split - unit) * most < Lk, Lk


# ---- the 3xTF32 products of K1's CUDA kernel, emulated ----

K1_TOL = 1e-4   # chip_smoke.py: K1 against its plain version, fp32 on both sides


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) by clearing the low 13 bits of its
    fp32 pattern, to nearest with ties away from zero (as cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x truncated to TF32: what the mma reads of an fp32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_linear(passes):
    """F.linear with TF32 operands and fp32 sums: one pass, or the 3xTF32 sum
    lo_x hi_w + hi_x lo_w + hi_x hi_w of the kernel (mma_tf32.cuh: hi rounded
    to TF32, lo = x - hi truncated by the mma)."""
    def linear(x, w, b=None):
        x_hi, w_hi = _tf32(x), _tf32(w)
        y = F.linear(x_hi, w_hi)
        if passes == 3:
            y = (F.linear(_tf32_trunc(x - x_hi), w_hi) + F.linear(x_hi, _tf32_trunc(w - w_hi))
                 + y)
        return y if b is None else y + b
    return linear


@pytest.mark.parametrize("outer", [False, True], ids=["no-outer", "outer-residual"])
@pytest.mark.parametrize("blend", [False, True], ids=["no-blend", "blend"])
def test_3xtf32_products_hold_k1_tol_and_one_tf32_pass_does_not(blend, outer, monkeypatch):
    """K1's three products on TF32 tensor cores, emulated through the plain
    tail on both routes at the utkinects widths (C 128, Ch 512) and the
    card check's inputs (``chip_smoke.fuser_inputs``, N = 8 x 256): the
    3xTF32 sums stay within K1_TOL of the fp32 plain version, one TF32 pass
    does not. This is why the kernel pays three products for each."""
    from chip_smoke import fuser_inputs

    gen = torch.Generator().manual_seed(7 + 2 * blend + outer)
    r, d, bl, params = fuser_inputs(8 * 256, gen, "cpu")

    def tail(linear):
        monkeypatch.setattr(pt_fk, "F", types.SimpleNamespace(linear=linear, gelu=F.gelu))
        if blend:
            return pt_fk.composed_tail(*pt_fk.composed_bn_blend(r, d, bl), params, outer)
        return pt_fk.composed_tail(r, d, params, outer)

    want = tail(F.linear)
    err3, err1 = (float((tail(_tf32_linear(n)) - want).abs().max()) for n in (3, 1))
    assert err3 <= K1_TOL < err1, (err3, err1)


# ---- the two-phase algorithm of K2's CUDA kernels, emulated ----

K2_TOL = 1e-4   # chip_smoke.py: K2 against its plain version, relative to each gradient's largest


def _ln_fwd(x):
    """xhat and 1/std of fp32 LayerNorm rows (biased variance, eps 1e-5)."""
    mu = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    return (x - mu) * rstd, rstd


def _ln_bwd(gy, xhat, rstd, scale):
    gh = gy * scale
    return rstd * (gh - gh.mean(-1, keepdim=True) - xhat * (gh * xhat).mean(-1, keepdim=True))


def _two_phase_tail_bwd(r, d, g, p, outer, linear, sms=132):
    """K2 as its kernels compute it on a card of ``sms`` SMs: the token rows
    in the row phase's order (per tile of ``bwd_plan``'s tile rows, the
    tile's r rows, then its d rows, zero rows past N), every product of the
    row phase through ``linear`` (the forward recomputed with the
    up-projection once, the backward to dr and dd), the column sums of each
    half of a tile summed in tile order, and the weight gradients as
    products over splits of ``split_rows`` token rows (through ``linear``
    too) summed in split order. Returns (dr, dd, FuserTailParams of
    gradients)."""
    N, C = r.shape
    plan = pt_fkb.bwd_plan(N, p.mlp1_weight.shape[0], sms)
    n, TM = plan.n_tiles, plan.tile_rows // 2
    pad = lambda x: F.pad(x, (0, 0, 0, n * TM - N))
    tok = lambda a, b: torch.stack([pad(a).view(n, TM, -1), pad(b).view(n, TM, -1)], 1).reshape(
        plan.rows, -1)
    swap = lambda x: x.view(n, 2, TM, -1).flip(1).reshape(x.shape)
    x_in = tok(r, d)
    xh1, rstd1 = _ln_fwd(x_in)
    h1 = xh1 * p.norm1_scale + p.norm1_bias
    x = x_in + linear(swap(h1), p.wvp) + p.proj_bias
    xh2, rstd2 = _ln_fwd(x)
    u = xh2 * p.norm2_scale + p.norm2_bias
    z = linear(u, p.mlp1_weight) + p.mlp1_bias
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    gelu, dgelu = z * cdf, cdf + z * torch.exp(-0.5 * z * z) * 0.3989422804014327
    y = x + (linear(gelu, p.mlp2_weight) + p.mlp2_bias)
    if outer:
        y = y + x_in
    xho, rstdo = _ln_fwd(y)
    gh = 0.5 * tok(g, g)
    dm = _ln_bwd(gh, xho, rstdo, p.norm_out_scale)
    dz = linear(dm, p.mlp2_weight.t()) * dgelu
    du = linear(dz, p.mlp1_weight.t())
    dx = dm + _ln_bwd(du, xh2, rstd2, p.norm2_scale)
    dh = linear(swap(dx), p.wvp.t())
    drd = dx + _ln_bwd(dh, xh1, rstd1, p.norm1_scale) + (dm if outer else 0.0)
    drd = drd.view(n, 2, TM, C)

    def tiles_in_order(x):   # each half of each tile, in order
        total = torch.zeros(x.shape[-1])
        for part in x.view(2 * n, TM, -1).sum(1):
            total = total + part
        return total

    def splits_in_order(X, Y):
        total = 0.0
        for i in range(0, plan.rows, plan.split_rows):
            total = total + linear(X[i:i + plan.split_rows].t(), Y[i:i + plan.split_rows].t())
        return total

    grads = pt_fk.FuserTailParams(
        norm1_scale=tiles_in_order(dh * xh1), norm1_bias=tiles_in_order(dh),
        wvp=splits_in_order(dx, swap(h1)), proj_bias=tiles_in_order(dx),
        norm2_scale=tiles_in_order(du * xh2), norm2_bias=tiles_in_order(du),
        mlp1_weight=splits_in_order(dz, u), mlp1_bias=tiles_in_order(dz),
        mlp2_weight=splits_in_order(dm, gelu), mlp2_bias=tiles_in_order(dm),
        norm_out_scale=tiles_in_order(gh * xho), norm_out_bias=tiles_in_order(gh))
    return drd[:, 0].reshape(n * TM, C)[:N], drd[:, 1].reshape(n * TM, C)[:N], grads


@pytest.mark.parametrize("outer", [False, True], ids=["no-outer", "outer-residual"])
@pytest.mark.parametrize("N", [8 * 256, 8 * 256 + 5], ids=["bucket-256", "ragged"])
def test_two_phase_k2_holds_k2_tol_and_one_tf32_pass_does_not(N, outer):
    """K2's two-phase algorithm, emulated at the utkinects widths (C 128,
    Ch 512) on the card check's inputs (``chip_smoke.fuser_inputs``): with
    every product as 3xTF32 it stays within K2_TOL of the plain backward
    (dr, dd and each gradient, relative to its largest entry); with one TF32
    pass it does not. So the kernel pays three products for each, as K1."""
    from chip_smoke import fuser_inputs

    gen = torch.Generator().manual_seed(11 + N + outer)
    r, d, _, params = fuser_inputs(N, gen, "cpu")
    g = torch.randn(N, 128, generator=gen)
    wr, wd, wp = pt_fkb.composed_tail_bwd(r, d, g, params, outer)

    def worst(passes):
        got = _two_phase_tail_bwd(r, d, g, params, outer, _tf32_linear(passes))
        return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for a, b in zip((got[0], got[1], *got[2]), (wr, wd, *wp)))

    err3, err1 = worst(3), worst(1)
    assert err3 <= K2_TOL < err1, (err3, err1)
