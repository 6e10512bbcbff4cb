"""The 1F1B schedule (``r3d_tpu_torch/parallel/pipeline_1f1b.py``) and the
trainer's 1F1B step on spawned gloo ranks (``tests/torch_parallel_ranks.py``:
a group of 4 and one of 2), against one process and the JAX package's pp
mesh.

- The closed-form schedule (``tests/test_pipeline_1f1b.py:130-185``): every
  op once, no two on a stage in one tick, dependencies kept, at most pp
  microbatches in flight on a stage, and an arriving activation's ring slot
  (m mod pp) free.
- JAX's toy problem through ``pipelined_value_and_grad`` on pp 4 (M = 4 and
  8) and dp 2 x pp 2 (M = 3): the loss, the correct count and every
  gradient (stage, last, injected input, side input) against autograd of
  the sequential composition (JAX's bounds: loss rtol 1e-5, gradients rtol
  2e-5 and atol 2e-6).
- The 1F1B step of ``futr`` with 4 decoder layers (pp 4 with M = 4; dp 2 x
  pp 2 with M = 4, and M = 1, which dp does not divide) and of the fusion
  model (dp 2 x pp 2, M = 4, epoch 0 and the sticky epoch; dp 1 x pp 2, M
  = 2) against ``make_accum_step`` over the same M microbatches in one
  process: the metrics (1e-6), every gradient (1e-6 of its tensor's
  largest entry) and the BN running statistics (1e-6); dp 2 x pp 2 against
  JAX's 1F1B step there (loss rtol 1e-5, parameters 5e-4, BN statistics
  1e-6). Each rank's stage layers run 2M times (the forward tick and its
  recomputation) before the last stage, M times on it.
- With dropout 0.1 (dp 1 x pp 2, M = 2): the gradients against autograd
  in one process through the same masks (each layer under the generators
  of the base seed, its global index and the microbatch).
- Every configuration JAX's 1F1B refuses raises ``ValueError`` with JAX's
  words.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3d_tpu.parallel.mesh import set_active_mesh
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu.train.optim import make_optimizer
from r3d_tpu.train.state import TrainState
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.parallel.pipeline_1f1b import bwd_tick, fwd_tick, schedule
from torch_parallel_ranks import (
    TOY_CASES,
    UNSUPPORTED_1F1B,
    accum_arm,
    finish,
    loader_for,
    one_f_one_b2_group,
    one_f_one_b_group,
    one_f_one_b_reference,
    pp_config,
    setup_config,
    source_for,
    start,
    toy_last,
    toy_problem,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

GRAD_TOL = 1e-6


def _jax_variables(name):
    """(JAX config, class count, first batch, init variables) of ``name``:
    the flax init, jitted; the fusion model's BN scales spread as
    ``torch_parallel_ranks._gammas`` spreads them."""
    jcfg = setup_config(name, config=jax_config)
    jsrc = source_for(name, JaxSource)
    batch = jax.tree.map(np.asarray, next(iter(loader_for(name, jsrc, False, batch_size=8,
                                                          Loader=JaxLoader))))
    trainer = JaxTrainer(jcfg, jsrc.n_class)
    variables = jax.device_get(jax.jit(lambda r, *a: trainer.model.init(
        {"params": r, "dropout": jax.random.fold_in(r, 1)}, *a, train=False))(
        jax.random.PRNGKey(0), *trainer._model_inputs(batch, with_mask=False)))
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    if "fuser" in variables["params"]:
        rng = np.random.RandomState(7)
        for bn in ("bn_rgb", "bn_depth"):
            variables["params"]["fuser"][bn]["scale"] = rng.permutation(
                0.2 + 0.1 * np.arange(32)).astype(np.float32)
    return jcfg, jsrc.n_class, batch, variables


def _jax_1f1b(jcfg, n_class, batch, variables):
    """JAX's 1F1B step on ``make_mesh(dp=2, pp=2)``, M = 4: its metrics and
    the state after."""
    jcfg = jcfg.replace(mesh=dataclasses.replace(jcfg.mesh, dp=2, pp=2, pp_microbatches=4,
                                                 pp_schedule="1f1b"))
    mesh = jax_make_mesh(dp=2, pp=2, devices=jax.devices()[:4])
    set_active_mesh(mesh)
    try:
        trainer = JaxTrainer(jcfg, n_class, mesh=mesh)
        trainer.sched_steps_per_epoch = 5
        trainer.tx = make_optimizer(jcfg.train, 5)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=trainer.tx.init(variables["params"]))
        state, m = trainer.make_train_step()(state, jax.tree.map(jnp.asarray, batch),
                                             jax.random.PRNGKey(9), 0)
        after = state_dict_from_flax(jax.device_get({"params": state.params,
                                                     "batch_stats": state.batch_stats}))
    finally:
        set_active_mesh(None)
    return jax.device_get(m), after


def _jax_refusals():
    """JAX's ``ValueError`` words for each ``UNSUPPORTED_1F1B`` case."""
    out = {}
    for key, (name, model_kw, train_kw) in UNSUPPORTED_1F1B.items():
        cfg = pp_config(name, 4, "1f1b")   # the port's, rebuilt in JAX's classes
        jcfg = setup_config(name, config=jax_config)
        jcfg = jcfg.replace(
            model=dataclasses.replace(jcfg.model, **model_kw),
            train=dataclasses.replace(jcfg.train, **train_kw),
            mesh=dataclasses.replace(jcfg.mesh, pp_microbatches=4, pp_schedule="1f1b",
                                     fsdp=key == "fsdp"))
        assert cfg.mesh.pp_schedule == "1f1b"
        sizes = dict(dp=1, tp=2, pp=2) if key == "tp" else dict(dp=2, pp=2)
        mesh = jax_make_mesh(**sizes, devices=jax.devices()[:4])
        set_active_mesh(mesh)
        try:
            JaxTrainer(jcfg, 7, mesh=mesh).make_train_step()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
        finally:
            set_active_mesh(None)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_1f1b")
    jax_vars = {n: _jax_variables(n) for n in ("pp_futr", "pp_fusion")}
    init = {n: state_dict_from_flax(v[3]) for n, v in jax_vars.items()}
    started4 = start(one_f_one_b_group, 4, tmp / "g4", init, timeout=400)
    started2 = start(one_f_one_b2_group, 2, tmp / "g2", init, timeout=400)
    # while the ranks run: the one-process oracles, then JAX
    one = {(n, M, e): accum_arm(n, init[n], M, e)
           for n, M, e in (("pp_futr", 4, 0), ("pp_futr", 1, 0), ("pp_fusion", 4, 0),
                           ("pp_fusion", 4, 1), ("pp_fusion", 2, 0))}
    one["dropout"] = one_f_one_b_reference("pp_futr", init["pp_futr"], 2, 2)
    jax_steps = {n: _jax_1f1b(*v) for n, v in jax_vars.items()}
    refusals = _jax_refusals()
    return finish(started4), finish(started2), one, jax_steps, refusals


def test_schedule_closed_form():
    """tests/test_pipeline_1f1b.py:130-185 on the port's schedule, and the
    ring slot of an arriving activation free."""
    for pp, M in [(2, 3), (3, 4), (4, 4), (4, 9), (8, 8), (2, 1)]:
        ops = schedule(pp, M)
        T = 2 * (M + pp - 1)
        assert len(ops) == M * (2 * pp - 1) and all(t < T for t, _ in ops)
        for m in range(M):
            for d in range(pp - 1):
                assert ops[(fwd_tick(m, d, pp), d)] == ("F", m)
                if d + 1 <= pp - 2:
                    assert fwd_tick(m, d + 1, pp) > fwd_tick(m, d, pp)
                assert bwd_tick(m, d, pp) > bwd_tick(m, d + 1, pp)
            assert bwd_tick(m, pp - 1, pp) > (fwd_tick(m, pp - 2, pp) if pp >= 2 else -1)
        for d in range(pp):
            arrive = {m: (fwd_tick(m, d - 1, pp) + 1 if d > 0 else fwd_tick(m, d, pp))
                      for m in range(M)}
            for t in range(T):
                live = [m for m in range(M) if arrive[m] <= t <= bwd_tick(m, d, pp)]
                assert len(live) <= pp, (pp, M, d, t)
                # the slots m mod pp of the live microbatches are distinct
                assert len({m % pp for m in live}) == len(live), (pp, M, d, t, live)


def _toy_sequential(M, Bm):
    w, b, head, inject, side, tgt = toy_problem(M, Bm)
    inject.requires_grad_()
    side.requires_grad_()
    loss = correct = 0.0
    for m in range(M):
        x = inject[m]
        for l in range(w.shape[0]):
            x = torch.tanh(x @ w[l] + b[l] + side[m])
        lm, met = toy_last(x, head, tgt[m])
        loss = loss + lm
        correct = correct + met["correct"]
    loss.backward()
    return dict(loss=loss.detach(), correct=correct, w=w.grad, b=b.grad, head=head.grad,
                inject=inject.grad, side=side.grad)


@pytest.mark.parametrize("pp,case", [(pp, c) for pp, cs in TOY_CASES.items()
                                     for c in range(len(cs))])
def test_toy_1f1b_matches_sequential_autograd(runs, pp, case):
    M, Bm = TOY_CASES[pp][case]
    want = _toy_sequential(M, Bm)
    for r in runs[0]:
        got = r[f"toy{pp}"][case]
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        assert float(got["correct"]) == float(want["correct"])
        for k in ("w", "b", "head", "inject", "side"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-5, atol=2e-6,
                                       err_msg=k)


def _step_matches(got, want):
    for k, v in want["metrics"][0].items():
        if k.endswith(("_correct", "_total")):
            assert abs(got["metrics"][0][k] - v) <= 1e-6 * max(1.0, abs(v)), k
        else:
            assert abs(got["metrics"][0][k] - v) <= 1e-6 * max(1.0, abs(v)), (k, v)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        err = float((got["grads"][k] - w).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(w.abs().max())), (k, err)
    for k, w in want["state"].items():
        if "running" in k:
            assert float((got["state"][k] - w).abs().max()) <= 1e-6, k


ARMS = {"futr_pp4": ("pp_futr", 4, 0), "futr": ("pp_futr", 4, 0), "futr_m1": ("pp_futr", 1, 0),
        "fusion": ("pp_fusion", 4, 0), "fusion_frozen": ("pp_fusion", 4, 1)}


@pytest.mark.parametrize("arm", list(ARMS) + ["fusion_pp2"])
def test_1f1b_step_matches_grad_accum(runs, arm):
    four, two, one = runs[:3]
    if arm == "fusion_pp2":
        ranks, want, pp, M = two, one[("pp_fusion", 2, 0)], 2, 2
        got_of = lambda r: r["fusion"]
    else:
        ranks, want = four, one[ARMS[arm]]
        pp, M = (4 if arm == "futr_pp4" else 2), ARMS[arm][1]
        got_of = lambda r: r[arm]
    for i, r in enumerate(ranks):
        got = got_of(r)
        _step_matches(got, want)
        for k, v in got_of(ranks[0])["own"].items():
            assert torch.equal(v, got["own"][k]), k
        d = i % pp
        own = range(d * 4 // pp, (d + 1) * 4 // pp)
        # the microbatches this dp rank pipelines: M / dp where dp divides M
        mine = M // 2 if pp == 2 and len(ranks) == 4 and M % 2 == 0 else M
        per = mine if d == pp - 1 else 2 * mine
        assert got["calls"] == {li: per for li in own}, (i, got["calls"])


@pytest.mark.parametrize("name,arm", [("pp_futr", "futr"), ("pp_fusion", "fusion")])
def test_1f1b_step_matches_jax_1f1b(runs, name, arm):
    four, jax_steps = runs[0], runs[3]
    metrics, after = jax_steps[name]
    got = four[0][arm]
    np.testing.assert_allclose(got["metrics"][0]["loss"], float(metrics["loss"]), rtol=1e-5)
    assert sorted(after) == sorted(got["state"])
    for k, w in after.items():
        err = float((got["state"][k] - w).abs().max())
        assert err <= (1e-6 if "running" in k else 5e-4), (k, err)


def test_1f1b_dropout_gradient_is_autograd_through_the_same_masks(runs):
    two, one = runs[1], runs[2]
    want = one["dropout"]
    for r in two:
        got = r["dropout"]["grads"]
        assert set(want) <= set(got)
        for k, w in want.items():
            err = float((got[k] - w).abs().max())
            assert err <= 1e-5 * max(1.0, float(w.abs().max())), (k, err)
    a, b = two[0]["dropout"]["own"], two[1]["dropout"]["own"]
    assert all(torch.equal(v, b[k]) for k, v in a.items())


def test_unsupported_configs_raise_with_jax_words(runs):
    four, refusals = runs[0], runs[4]
    got = dict(four[0]["refused"], **four[0]["refused_tp"])
    assert sorted(got) == sorted(refusals)
    for k, want in refusals.items():
        assert want is not None and got[k] == want, (k, got[k], want)
