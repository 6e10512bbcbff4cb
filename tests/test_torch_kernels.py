"""The port's plain kernel versions against the JAX package's Pallas kernels.

``r3d_tpu_torch.ops.fuser_kernel.fused_bn_blend_tail`` and
``r3d_tpu_torch.ops.attention.flash_attention`` take their plain PyTorch
version for CPU tensors. Here they are held against the Pallas kernels,
which off the TPU run in interpret mode (as ``tests/test_fuser_kernel.py``
runs them), on the same inputs made with numpy from a seed. Tolerance
2e-5 absolute: both sides are fp32 and differ only in summation order.
The CUDA kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r3d_tpu.models.fuser import bottomk_mask as jax_bottomk_mask
from r3d_tpu.ops import attention as jax_attn
from r3d_tpu.ops import fuser_kernel as jax_fk
from r3d_tpu_torch.models.fuser import bottomk_mask
from r3d_tpu_torch.ops import attention as pt_attn
from r3d_tpu_torch.ops import fuser_kernel as pt_fk

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
