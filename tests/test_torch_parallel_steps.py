"""A ``futr_fusion_bn``, ``futr`` and ``futr_proposed`` step on W = 2 and 4
gloo ranks against the one-process step and against the JAX package's step
on ``make_mesh(dp=W)`` over W of the tests' CPU devices, from the JAX init
(the fusion model's BN scales spread 0.1 apart, as in
``tests/test_torch_train.py``) and the same first batch of 4 rows
(``tests/torch_parallel_ranks.py``).

Against JAX the tolerances are ``tests/test_torch_train.py``'s one-step
ones: the loss 1e-5, every gradient 1e-5 of its tensor's largest entry,
the BatchNorm running statistics 1e-6, the counts equal. Against the
one-process step those of ``tests/test_torch_parallel.py``. The bottom-k
masks of the updated BN scales equal the one-process step's.
"""

import numpy as np
import pytest
import torch

import jax

from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.data.pipeline import pad_batch as jax_pad_batch
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3d_tpu.parallel.mesh import set_active_mesh, shard_batch
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch.convert import state_dict_from_flax
from test_torch_parallel import assert_step_matches
from torch_parallel_ranks import (
    NQ,
    QUERY_CLASSES,
    finish,
    loader_for,
    setup_config,
    source_for,
    start,
    step_arm,
    step_arms,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

FAMILIES = ("futr_fusion_bn", "futr", "futr_proposed")
WORLDS = (2, 4)


def _jax_variables(name):
    """(JAX config, source, init variables) of ``name``: the flax init that
    ``Trainer.init_state`` makes, jitted (the optimizer is not needed), the
    fusion model's BN scales spread as ``_jax_init`` spreads them."""
    jcfg = setup_config(name, config=jax_config)
    jsrc = source_for(name, JaxSource)
    trainer = JaxTrainer(jcfg, jsrc.n_class)
    nq = 20 if name == "futr" else NQ
    fn, _ = jsrc.make_example_fn((0.2, 0.3, 0.5), 1, nq)
    kw = dict(with_query=True, query_pad_idx=QUERY_CLASSES) if name == "futr_proposed" else {}
    example = jax_pad_batch([fn(i) for i in range(4)], jsrc.pad_idx, (64, 128), nq,
                            with_depth=name == "futr_fusion_bn", **kw)
    variables = jax.device_get(jax.jit(lambda r, *a: trainer.model.init(
        {"params": r, "dropout": jax.random.fold_in(r, 1)}, *a, train=False))(
        jax.random.PRNGKey(0), *trainer._model_inputs(example, with_mask=False)))
    variables.setdefault("batch_stats", {})
    if name == "futr_fusion_bn":
        rng = np.random.RandomState(7)
        for bn in ("bn_rgb", "bn_depth"):
            variables["params"]["fuser"][bn]["scale"] = rng.permutation(
                0.2 + 0.1 * np.arange(32)).astype(np.float32)
    return jcfg, jsrc, variables


def _jax_mesh_step(jcfg, jsrc, variables, name, W):
    """JAX's gradients, metrics and batch statistics of the first batch on
    ``make_mesh(dp=W)``."""
    batch = jax.tree.map(np.asarray, next(iter(loader_for(name, jsrc, False, Loader=JaxLoader))))
    mesh = jax_make_mesh(dp=W, devices=jax.devices()[:W])
    try:
        trainer = JaxTrainer(jcfg, jsrc.n_class, mesh=mesh)
        grads, metrics, stats = jax.jit(lambda p, bs, b: trainer._grad_core(
            p, bs, b, jax.random.PRNGKey(0), 0))(variables["params"], variables["batch_stats"],
                                                  shard_batch(batch, mesh))
    finally:
        set_active_mesh(None)
    return (state_dict_from_flax({"params": jax.device_get(grads)}), jax.device_get(metrics),
            state_dict_from_flax({"batch_stats": jax.device_get(stats)}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states = {n: _jax_variables(n) for n in FAMILIES}
    init = {n: state_dict_from_flax(states[n][2]) for n in FAMILIES}
    started = {W: start(step_arms, W, tmp_path_factory.mktemp(f"dp{W}"), FAMILIES, init)
               for W in WORLDS}
    # while the ranks run: the one-process steps and JAX's mesh steps
    one = {n: step_arm(None, n, init[n]) for n in FAMILIES}
    jax_steps = {(n, W): _jax_mesh_step(*states[n], n, W) for n in FAMILIES for W in WORLDS}
    return {W: finish(g)[0] for W, g in started.items()}, one, jax_steps


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_dp_step_matches_one_process_and_jax_mesh(runs, name, W):
    ranks, one, jax_steps = runs
    got = ranks[W][name]
    assert_step_matches(got, one[name])
    grads, metrics, stats = jax_steps[name, W]
    assert abs(got["metrics"]["loss"] - float(metrics["loss"])) < 1e-5
    for k in ("cls_correct", "cls_total", "seg_correct", "seg_total"):
        if k in got["metrics"]:
            assert got["metrics"][k] == int(metrics[k]), k
    for k, w in grads.items():
        err = float((got["grads"][k] - w).abs().max())
        assert err <= 1e-5 * max(1.0, float(w.abs().max())), (k, err)
    for k, w in stats.items():
        np.testing.assert_allclose(got["stats"][k].numpy(), w.numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
    assert sorted(stats) == sorted(got["stats"])
