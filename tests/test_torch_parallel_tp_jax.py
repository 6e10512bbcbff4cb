"""Tensor and expert parallelism against the JAX package's mesh step: tp 2
(``futr_fusion_bn`` in the 256 bucket, 4 heads), ep 2 (``futr`` with 4
experts) and dp 2 (that MoE at a capacity factor of 0.5, which drops
assignments) on 2 gloo ranks (``tests/torch_parallel_ranks.py``), each
against JAX's ``_grad_core`` on ``make_mesh(dp=1, tp=2)``,
``make_mesh(dp=1, ep=2)`` and ``make_mesh(dp=2)`` over 2 of the tests'
CPU devices, the parameters placed by JAX's ``param_shardings``, from the
JAX init and the same first batch of 4 rows, dropout off.

The tolerances are ``tests/test_torch_parallel_steps.py``'s against JAX
(those of the one-process ports against JAX, ``tests/test_torch_train.py``
and ``tests/test_torch_moe.py``): the loss 1e-5, every gradient 1e-5 of its
tensor's largest entry, the BatchNorm running statistics 1e-6, the counts
equal.
"""

import numpy as np
import pytest
import torch

import jax

from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3d_tpu.parallel.mesh import param_shardings, set_active_mesh, shard_batch
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.parallel.mesh import make_mesh
from torch_parallel_ranks import TP_NAME, finish, loader_for, setup_config, source_for, start, step_arm

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

# set-up -> its mesh on the 2 ranks
ARMS = {TP_NAME: dict(dp=1, tp=2), "futr_moe": dict(dp=1, ep=2), "futr_moe_drop": dict(dp=2)}


def _jax_variables(name):
    """(JAX config, source, the first batch, init variables) of ``name``:
    the flax init ``Trainer.init_state`` makes, jitted, the fusion model's
    BN scales spread as ``tests/torch_parallel_ranks._gammas`` spreads them."""
    jcfg = setup_config(name, config=jax_config)
    jsrc = source_for(name, JaxSource)
    batch = jax.tree.map(np.asarray, next(iter(loader_for(name, jsrc, False, Loader=JaxLoader))))
    trainer = JaxTrainer(jcfg, jsrc.n_class)
    variables = jax.device_get(jax.jit(lambda r, *a: trainer.model.init(
        {"params": r, "dropout": jax.random.fold_in(r, 1)}, *a, train=False))(
        jax.random.PRNGKey(0), *trainer._model_inputs(batch, with_mask=False)))
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    if name == TP_NAME:
        rng = np.random.RandomState(7)
        for bn in ("bn_rgb", "bn_depth"):
            variables["params"]["fuser"][bn]["scale"] = rng.permutation(
                0.2 + 0.1 * np.arange(32)).astype(np.float32)
    return jcfg, jsrc, batch, variables


def _jax_mesh_step(jcfg, jsrc, batch, variables, sizes):
    """JAX's gradients, metrics and batch statistics of ``batch`` on
    ``make_mesh(**sizes)``, the parameters placed by its TP rules."""
    mesh = jax_make_mesh(**sizes, devices=jax.devices()[:2])
    try:
        trainer = JaxTrainer(jcfg, jsrc.n_class, mesh=mesh)
        params = jax.device_put(variables["params"], param_shardings(mesh, variables["params"]))
        grads, metrics, stats = jax.jit(lambda p, bs, b: trainer._grad_core(
            p, bs, b, jax.random.PRNGKey(0), 0))(params, variables["batch_stats"],
                                                  shard_batch(batch, mesh))
    finally:
        set_active_mesh(None)
    return (state_dict_from_flax({"params": jax.device_get(grads)}), jax.device_get(metrics),
            state_dict_from_flax({"batch_stats": jax.device_get(stats)}))


def _arms(mesh, init):
    return {n: step_arm(make_mesh(**sizes), n, init[n]) for n, sizes in ARMS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states = {n: _jax_variables(n) for n in ARMS}
    init = {n: state_dict_from_flax(states[n][3]) for n in ARMS}
    started = start(_arms, 2, tmp_path_factory.mktemp("tp_jax"), init)
    jax_steps = {n: _jax_mesh_step(*states[n], sizes) for n, sizes in ARMS.items()}
    return finish(started)[0], jax_steps


@pytest.mark.parametrize("name", list(ARMS))
def test_step_matches_jax_mesh_step(runs, name):
    ranks, jax_steps = runs
    got = ranks[name]
    grads, metrics, stats = jax_steps[name]
    assert abs(got["metrics"]["loss"] - float(metrics["loss"])) < 1e-5
    if "moe_aux" in metrics:
        assert abs(got["metrics"]["moe_aux"] - float(metrics["moe_aux"])) < 1e-5
    for k in ("cls_correct", "cls_total", "seg_correct", "seg_total"):
        if k in got["metrics"]:
            assert got["metrics"][k] == int(metrics[k]), k
    assert sorted(grads) == sorted(got["grads"])
    for k, w in grads.items():
        err = float((got["grads"][k] - w).abs().max())
        assert err <= 1e-5 * max(1.0, float(w.abs().max())), (k, err)
    assert sorted(stats) == sorted(got["stats"])
    for k, w in stats.items():
        np.testing.assert_allclose(got["stats"][k].numpy(), w.numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
