"""The many-query bf16 attention algorithms against JAX's Pallas
``flash_attention`` at rate 0 (``tests/test_torch_attention_rows.py`` says
what is emulated and why each bound holds)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu.ops import attention as jax_attn
from test_torch_attention_rows import (BWD_TOL, CASES, FWD_TOL, _close, _inputs, _many_backward,
                                       _many_forward)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


@pytest.mark.parametrize("S,D,lengths", CASES)
def test_many_query_algorithms_match_pallas_at_rate0(S, D, lengths):
    """Against JAX's ``flash_attention`` and its custom VJP (the Pallas
    forward and backward in interpret mode)."""
    rng = np.random.RandomState(S + D + 1)
    q, k, v, bias, g = _inputs(rng, 2, 2, S, D, lengths)
    scale = D ** -0.5
    J = lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    want, vjp = jax.vjp(lambda *a: jax_attn.flash_attention(*a, scale), J(q), J(k), J(v),
                        J(bias))
    out, stats = _many_forward(q, k, v, bias, 0, scale, 0.0)
    _close(out, want, FWD_TOL, "out")
    got = _many_backward(q, k, v, bias, 0, scale, 0.0, g, stats)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, vjp(J(g))):
        _close(a, b, BWD_TOL[name], name)
