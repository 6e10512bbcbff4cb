"""The cluster algorithm of fp32 K7, the native cross-attention backward's
CUDA kernel, emulated on the CPU (``tests/test_torch_cross_attention_fp32.py``
holds the emulation) and held to the plain backward: every gradient within
2e-6 of its largest entry. Split out of
``tests/test_torch_cross_attention.py`` unchanged.
"""

import pytest
import torch

from r3d_tpu_torch.ops import cross_attention as pt_ca
from test_torch_cross_attention import SCALE
from test_torch_cross_attention_fp32 import FP32_CLUSTER_S, _cluster_backward, _fp32_inputs

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("Lq", [8, 20, 33, 64])
@pytest.mark.parametrize("S", FP32_CLUSTER_S)
def test_fp32_cluster_backward_matches_plain(S, Lq, D, rate):
    """fp32 K7's cluster algorithm (statistics from the forward, each run's
    dk and dv, dq in rank order) against the plain backward: every gradient
    within 2e-6 of its largest entry."""
    q, k, v, bias, g, H = _fp32_inputs(S, Lq, D, 2 * S + Lq + D)
    seed = 29 + S
    out, m, l = pt_ca.composed_cross_attention(q, k, v, bias, seed, SCALE, rate, H)
    got = _cluster_backward(q, k, v, bias, seed, SCALE, rate, H, g, out, m, l)
    want = pt_ca.composed_cross_attention_bwd(q, k, v, bias, seed, SCALE, rate, H, g, out, m, l)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= 2e-6 * max(1.0, float(b.abs().max())), name
