"""Ring attention (``r3d_tpu_torch/ops/ring_attention.py``) and the
sequence-parallel routes of ``MultiheadAttention`` on one spawned group of
4 gloo ranks (``tests/torch_parallel_ranks.py``).

- The ring against JAX's ``ring_attention_sharded`` on ``make_mesh(dp, tp,
  sp)`` over 4 of the tests' CPU devices and against JAX's composed
  attention, forward and the q, k and v gradients of the sum of the squared
  outputs, with a padding tail of 37 keys that crosses the blocks, at
  ``tests/test_ring_attention.py``'s cases and bounds: (dp, tp, sp) in
  {(1, 1, 4), (2, 1, 2), (1, 2, 2)}, values atol 3e-5, gradients atol
  2e-3, rtol 1e-3. Each rank runs its rows, heads and sequence block.
- The eligibility gates of ``tests/test_ring_attention.py:76-86``, and the
  port's rule against JAX's on an sp mesh.
- ``MultiheadAttention`` on the sequence stream of sp 2 against one
  process: the ring (S 128, no dropout, dp 2 x sp 2), the gathered call (S
  64, under the ring's 128) and the gathered call with dropout 0.1 (S 128,
  tp 2 x sp 2 with the layer unplaced: one dp coordinate draws one
  process's masks): each rank's output rows and input gradient within 1e-5
  of one process's, the parameters' gradients summed over the ranks within
  1e-5 of one process's (each rank's loss is its rows').
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from r3d_tpu.ops.attention import composed_attention
from r3d_tpu.ops import ring_attention as jax_ring
from r3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3d_tpu.parallel.mesh import set_active_mesh
from r3d_tpu_torch.ops.ring_attention import ring_attention_eligible
from torch_parallel_ranks import (
    MHA_ROUTES,
    RING_CASES,
    finish,
    mha_inputs,
    mha_run,
    ring_group,
    ring_inputs,
    start,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

WORLD = 4
MHA_TOL = 1e-5


def _jax_ring(dp, tp, sp):
    """JAX's ring and composed attention, values and q/k/v gradients."""
    q, k, v, bias, scale = (jnp.asarray(t) for t in ring_inputs(sp))
    loss = lambda f: lambda a, b, c: jnp.sum(f(a, b, c, bias, scale) ** 2)
    ref = composed_attention(q, k, v, bias, scale)
    ref_g = jax.grad(loss(composed_attention), argnums=(0, 1, 2))(q, k, v)
    mesh = jax_make_mesh(dp=dp, tp=tp, sp=sp, devices=jax.devices()[:dp * tp * sp])
    set_active_mesh(mesh)
    try:
        spec = NamedSharding(mesh, P("dp" if dp > 1 else None, "tp" if tp > 1 else None, "sp"))
        qs, ks, vs = (jax.device_put(t, spec) for t in (q, k, v))
        out = jax.jit(lambda a, b, c: jax_ring.ring_attention_sharded(a, b, c, bias, scale))(
            qs, ks, vs)
        g = jax.jit(jax.grad(loss(jax_ring.ring_attention_sharded), argnums=(0, 1, 2)))(
            qs, ks, vs)
    finally:
        set_active_mesh(None)
    return (np.asarray(out), [np.asarray(t) for t in g]), (np.asarray(ref),
                                                          [np.asarray(t) for t in ref_g])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = start(ring_group, WORLD, tmp_path_factory.mktemp("ring"))
    jax_runs = {case: _jax_ring(*case) for case in RING_CASES}
    one = {route: mha_run(*mha_inputs(S), rate) for route, S, rate in MHA_ROUTES}
    return finish(started), jax_runs, one


@pytest.mark.parametrize("case", RING_CASES, ids=[f"dp{a}_tp{b}_sp{c}" for a, b, c in RING_CASES])
def test_ring_matches_jax_ring_and_composed(runs, case):
    ranks, jax_runs, _ = runs
    for want in jax_runs[case]:   # JAX's ring, then the composed attention
        out, grads = want
        seen = np.zeros(out.shape, bool)
        for r in ranks:
            idx, o, *g = r["ring"][case]
            np.testing.assert_allclose(o.numpy(), out[idx], atol=3e-5, rtol=0)
            for got, w, name in zip(g, grads, "qkv"):
                np.testing.assert_allclose(got.numpy(), w[idx], atol=2e-3, rtol=1e-3,
                                           err_msg=name)
            seen[idx] = True
        assert seen.all()   # the ranks' blocks cover the whole tensors


def test_ring_eligibility_gates():
    """``tests/test_ring_attention.py:76-86``'s gates at sp 4, and the
    port's rule equal to JAX's on ``make_mesh(dp=2, sp=4)`` at each."""
    assert ring_attention_eligible(256, 256, 4)
    assert not ring_attention_eligible(20, 20, 4)       # decoder queries
    assert not ring_attention_eligible(256, 3100, 4)    # cross-attention
    assert not ring_attention_eligible(255, 255, 4)     # not divisible
    assert not ring_attention_eligible(256, 256, 1)     # no sp axis
    assert not ring_attention_eligible(128, 128, 4)     # under 64 a rank
    mesh = jax_make_mesh(dp=2, sp=4, devices=jax.devices()[:8])
    set_active_mesh(mesh)
    try:
        for L in ((256, 256), (20, 20), (256, 3100), (255, 255), (128, 128), (512, 512)):
            assert ring_attention_eligible(*L, 4) == jax_ring.ring_attention_eligible(*L), L
    finally:
        set_active_mesh(None)


@pytest.mark.parametrize("route", [r[0] for r in MHA_ROUTES])
def test_attention_on_the_sequence_stream_matches_one_process(runs, route):
    ranks, _, one = runs
    want_out, want_dx, want_grads = one[route]
    got = [r["mha"][route] for r in ranks]
    taken = "gathered" if route.startswith("gathered") else "ring"
    summed = {n: torch.zeros_like(g) for n, g in want_grads.items()}
    for rows, seq, seen, out, dx, grads in got:
        assert seen == [taken]
        rows = rows if rows is not None else slice(None)
        assert float((out - want_out[rows, seq]).abs().max()) <= MHA_TOL
        assert float((dx - want_dx[rows, seq]).abs().max()) <= MHA_TOL
        for n, g in grads.items():
            summed[n] += g
    # dp 2 x sp 2: each rank's loss is its rows'; tp 2 x sp 2: two copies
    copies = 2 if route == "gathered_dropout" else 1
    for n, w in want_grads.items():
        err = float((summed[n] / copies - w).abs().max())
        assert err <= MHA_TOL * max(1.0, float(w.abs().max())), (n, err)
