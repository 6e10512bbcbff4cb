"""The fuser's kernels in bf16 and AdamW's bf16 first moment, against the
JAX package, on the CPU.

The plain bf16 versions of K1 (``composed_bn_blend`` and
``composed_tail``, both routes, the outer residual off and on) and K2
(``composed_tail_bwd``) against JAX's Pallas kernels in bf16, which run in
interpret mode off the TPU, on the same seeded numpy inputs at N = 2 x 256
rows, C = 128, Ch = 512, the parameters and blend vectors fp32 as JAX
passes them. Tolerances, in bf16 steps of the tensor's largest entry (one
step = 2**-7 of it):

- K1 within 2 steps. XLA's CPU backend keeps fp32 between bf16 ops
  (``xla_allow_excess_precision``), so the interpret-mode kernel skips
  some of the roundings that the Pallas kernel asks for and the port
  makes: about half of the entries land on a neighbouring bf16 value
  (read: 0.03125 at a largest entry of 3.4-4.5). With that option off, in
  a process of its own, at most 0.5 % of the entries differ, by at most one
  step (read: 0.05-0.12 %, 0.0078-0.0156): the port rounds where the TPU's
  kernel rounds, and sums in another order.
- K2 within one step for dr and dd (fp32 inside, one rounding out; read:
  at most 0.04 % of the entries differ) and 1e-5 of the largest entry for
  the fp32 parameter gradients (read: 6.4e-7).
- The blend route's backward, autograd of the plain blend and tail in bf16
  against ``jax.vjp`` of ``fused_bn_blend_tail`` in bf16 (JAX's ``_bwd_bn``):
  the two frameworks round the cotangents at other points, so each
  gradient is held within 3e-2 of its largest entry with a cosine of at
  least 0.9995 (read: 1.3e-2 and 0.99988 at worst).

AdamW with ``opt_mu_dtype='bfloat16'`` against ``optax.adamw(mu_dtype=
bfloat16)`` over six steps at changing learning rates: the stored first
moment bit-equal and bf16, the parameters within 1e-6 (read: 2.4e-7); a
checkpoint round trip keeps the bf16 state and the next step.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from r3d_tpu.ops import fuser_kernel as jax_fk
from r3d_tpu.ops import fuser_kernel_bwd as jax_fkb
from r3d_tpu_torch.ops import fuser_kernel as fk
from r3d_tpu_torch.ops import fuser_kernel_bwd as fkb

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N, C, CH = 2 * 256, 128, 512
STEP = 2.0 ** -7
ROUTES = [("no-blend", False), ("no-blend", True), ("blend", False), ("blend", True)]


def _inputs(seed=0):
    """Streams r, d, g [N, C] and the fp32 tail parameters (JAX's [in, out]
    layout) and blend vectors, as numpy."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    r, d, g = f(N, C), f(N, C), f(N, C)
    params = dict(
        norm1_scale=1 + f(C, sc=0.1), norm1_bias=f(C, sc=0.1), wvp=f(C, C, sc=C ** -0.5),
        proj_bias=f(C, sc=0.1), norm2_scale=1 + f(C, sc=0.1), norm2_bias=f(C, sc=0.1),
        mlp1_kernel=f(C, CH, sc=C ** -0.5), mlp1_bias=f(CH, sc=0.1),
        mlp2_kernel=f(CH, C, sc=CH ** -0.5), mlp2_bias=f(C, sc=0.1),
        norm_out_scale=1 + f(C, sc=0.1), norm_out_bias=f(C, sc=0.1))
    blend = dict(
        scale_r=1 + f(C, sc=0.2), shift_r=f(C, sc=0.2), scale_d=1 + f(C, sc=0.2),
        shift_d=f(C, sc=0.2), mask_r=(rng.rand(C) < 0.1).astype(np.float32),
        mask_d=(rng.rand(C) < 0.1).astype(np.float32), alpha=rng.rand(C).astype(np.float32))
    return r, d, g, params, blend


def _jax_args(params, blend):
    return (jax_fk.FuserTailParams(**{k: jnp.asarray(v) for k, v in params.items()}),
            jax_fk.BlendParams(**{k: jnp.asarray(v) for k, v in blend.items()}))


def _port_args(params, blend):
    """The port's FuserTailParams ([out, in] matrices) and BlendParams."""
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    for k in ("wvp", "mlp1_kernel", "mlp2_kernel"):
        t[k] = t[k].T.contiguous()
    return (fk.FuserTailParams(*(t[k] for k in jax_fk.FuserTailParams._fields)),
            fk.BlendParams(**{k: torch.from_numpy(v) for k, v in blend.items()}))


def _bf(x):
    return torch.from_numpy(x).bfloat16()


def _port_forward(route, outer, r, d, params, blend):
    if route == "blend":
        return fk.fused_bn_blend_tail(_bf(r), _bf(d), blend, params, outer)
    return fk.fused_safuser_tail(_bf(r), _bf(d), params, outer)


def pallas_outputs(route, outer, seed=0):
    """JAX's bf16 K1 in interpret mode on ``_inputs(seed)``, as fp32 numpy."""
    r, d, _, params, blend = _inputs(seed)
    jp, jb = _jax_args(params, blend)
    out = jax.jit(lambda r_, d_: jax_fk._pallas_forward(
        r_, d_, jp, outer, blend=jb if route == "blend" else None))(
        jnp.asarray(r, jnp.bfloat16), jnp.asarray(d, jnp.bfloat16))
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


def _steps_off(got, want):
    """(largest difference in bf16 steps of want's largest entry, share of
    entries that differ)."""
    diff = np.abs(got - want)
    return diff.max() / (STEP * np.abs(want).max()), float((diff > 0).mean())


@pytest.mark.parametrize("route,outer", ROUTES)
def test_plain_tail_bf16_matches_pallas(route, outer):
    r, d, _, params, blend = _inputs()
    pp, pb = _port_args(params, blend)
    got = _port_forward(route, outer, r, d, pp, pb)
    assert got.dtype == torch.bfloat16 and got.shape == (N, C)
    steps, _ = _steps_off(got.float().numpy(), pallas_outputs(route, outer))
    assert steps <= 2.0, steps


ROUNDING_ROUTES = [("blend", False), ("no-blend", True)]   # serving's; grad's training


def test_plain_tail_bf16_rounds_where_the_pallas_kernel_does(tmp_path):
    """With XLA's excess precision off, JAX's interpret-mode K1 rounds after
    every bf16 op as the TPU does: the port's plain version then differs
    in at most 0.5 % of the entries, by at most one step (the blend route
    without the outer residual and the no-blend route with it)."""
    script = ("import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
              "import test_torch_fuser_bf16 as t\n"
              "for i, (route, outer) in enumerate(t.ROUNDING_ROUTES):\n"
              "    np.save(f'{sys.argv[2]}/{i}.npy', t.pallas_outputs(route, outer))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"))
    subprocess.run([sys.executable, "-c", script, os.path.dirname(__file__), str(tmp_path)],
                   env=env, check=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    r, d, _, params, blend = _inputs()
    pp, pb = _port_args(params, blend)
    for i, (route, outer) in enumerate(ROUNDING_ROUTES):
        got = _port_forward(route, outer, r, d, pp, pb).float().numpy()
        steps, share = _steps_off(got, np.load(tmp_path / f"{i}.npy"))
        assert steps <= 1.0 and share <= 0.005, (route, outer, steps, share)


@pytest.mark.parametrize("outer", [False, True])
def test_plain_tail_bwd_bf16_matches_pallas(outer):
    r, d, g, params, blend = _inputs(1)
    jp, _ = _jax_args(params, blend)
    pp, _ = _port_args(params, blend)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    jdr, jdd, jgrads = jax.jit(lambda *a: jax_fkb.pallas_tail_bwd(*a, jp, outer))(
        bf(r), bf(d), bf(g))
    dr, dd, grads = fkb.fused_tail_bwd(_bf(r), _bf(d), _bf(g), pp, outer)
    for got, want in ((dr, jdr), (dd, jdd)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        steps, share = _steps_off(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        assert steps <= 1.0 and share <= 0.001, (steps, share)
    for name, got, want in zip(jax_fk.FuserTailParams._fields, grads, jgrads):
        want = np.asarray(want)
        want = want.T if want.ndim == 2 else want
        assert got.dtype == torch.float32, name
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max(), name


def test_blend_route_backward_bf16_matches_jax_vjp():
    """``fused_bn_blend_tail``'s backward in bf16: every input's and
    parameter's gradient (bf16 streams, fp32 parameters and blend vectors)
    against ``jax.vjp`` of JAX's ``fused_bn_blend_tail``."""
    r, d, g, params, blend = _inputs(2)
    jp, jb = _jax_args(params, blend)
    pp, pb = _port_args(params, blend)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    f = lambda r_, d_, b_, p_: jax_fk.fused_bn_blend_tail(r_, d_, b_, p_, False)
    jr, jd, jblend, jparams = jax.jit(lambda *a: jax.vjp(f, *a[:4])[1](a[4]))(
        bf(r), bf(d), jb, jp, bf(g))
    leaves = [_bf(r).requires_grad_(), _bf(d).requires_grad_()]
    leaves += [t.clone().requires_grad_() for t in (*pb, *pp)]
    out = fk.fused_bn_blend_tail(leaves[0], leaves[1], fk.BlendParams(*leaves[2:9]),
                                 fk.FuserTailParams(*leaves[9:]), False)
    assert out.dtype == torch.bfloat16
    out.backward(_bf(g))
    for i, (leaf, want) in enumerate(zip(leaves, (jr, jd, *jblend, *jparams))):
        assert leaf.grad.dtype == leaf.dtype
        a = leaf.grad.float().numpy()
        b = np.asarray(want, np.float32)
        b = b.T if i >= 9 and b.ndim == 2 else b   # JAX's [in, out] matrices
        cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert np.abs(a - b).max() <= 3e-2 * np.abs(b).max() and cos >= 0.9995, cos


# ---- AdamW's bf16 first moment ----

LRS = (1e-3, 2e-3, 3e-3, 1e-3, 5e-4, 1e-3)


def _opt_problem():
    rng = np.random.RandomState(3)
    shapes = [(64, 32), (32,), (7, 5, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 10 ** rng.uniform(-3, 0)).astype(np.float32) for s in shapes]
             for _ in LRS]
    return params, grads


def _port_adamw(params):
    from r3d_tpu_torch.config import TrainConfig
    from r3d_tpu_torch.train.optim import AdamWLowMu, make_optimizer

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, _ = make_optimizer(TrainConfig(opt_mu_dtype="bfloat16", weight_decay=1e-2), tp, 1)
    assert isinstance(opt, AdamWLowMu)
    return tp, opt


def _port_steps(tp, opt, grads, lrs):
    for g, lr in zip(grads, lrs):
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.param_groups[0]["lr"] = lr
        opt.step()


def test_adamw_bf16_mu_matches_optax():
    params, grads = _opt_problem()
    tx = optax.adamw(learning_rate=lambda c: jnp.asarray(LRS)[c], b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=1e-2, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp, opt = _port_adamw(params)
    for i, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        _port_steps(tp, opt, [g], [LRS[i]])
        for p, q, mu in zip(tp, jp, state[0].mu):
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
            np.testing.assert_array_equal(st["exp_avg"].float().numpy(), np.asarray(mu, np.float32))
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=1e-6, rtol=0)


def test_adamw_bf16_mu_checkpoint_round_trip(tmp_path):
    """``Checkpointer`` saves the bf16 first moment and restores it as bf16
    (torch would cast a loaded state to the parameter's dtype); the restored
    optimizer's next steps equal the uninterrupted run's bit for bit."""
    from r3d_tpu_torch.train.checkpoint import Checkpointer
    from r3d_tpu_torch.train.optim import AdamWLowMu
    from r3d_tpu_torch.train.state import TrainState

    params, grads = _opt_problem()
    states = []
    for _ in range(2):
        model = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy()))
                                        for p in params])
        states.append(TrainState(model, AdamWLowMu(model.parameters(), weight_decay=1e-2),
                                 lambda step: 1e-3))
    run, resumed = states
    _port_steps(list(run.model), run.optimizer, grads[:3], LRS[:3])
    ck = Checkpointer(str(tmp_path))
    ck.save(run, "mid")
    ck.restore("mid", resumed)
    for p, q in zip(run.model, resumed.model):
        a, b = run.optimizer.state[p], resumed.optimizer.state[q]
        assert b["exp_avg"].dtype == torch.bfloat16
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    _port_steps(list(run.model), run.optimizer, grads[3:], LRS[3:])
    _port_steps(list(resumed.model), resumed.optimizer, grads[3:], LRS[3:])
    for p, q in zip(run.model, resumed.model):
        assert torch.equal(p, q)
        assert torch.equal(run.optimizer.state[p]["exp_avg"], resumed.optimizer.state[q]["exp_avg"])


def test_make_optimizer_keeps_torch_adamw_for_fp32():
    from r3d_tpu_torch.config import TrainConfig
    from r3d_tpu_torch.train.optim import make_optimizer

    p = [torch.nn.Parameter(torch.zeros(3))]
    for mu in (None, "float32"):
        assert type(make_optimizer(TrainConfig(opt_mu_dtype=mu), p, 1)[0]) is torch.optim.AdamW
    with pytest.raises(ValueError, match="opt_mu_dtype"):
        make_optimizer(TrainConfig(opt_mu_dtype="float16"), p, 1)
