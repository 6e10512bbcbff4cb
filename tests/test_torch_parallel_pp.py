"""Pipeline parallelism, GPipe (``r3d_tpu_torch/parallel/pipeline.py``, the
decoder's pipelined path), on spawned gloo ranks
(``tests/torch_parallel_ranks.py``: one group of 4, one of 2), against the
one-process port and the JAX package's pp mesh.

- The pipelined decoder (JAX's ``_decoder_setup`` shapes, 4 layers) on (dp,
  pp, M) = (1, 4, auto), (2, 2, auto), (2, 2, 2) and (2, 2, 8) (a
  microbatch of 1 row, which JAX replicates over dp: gathered here), and
  (1, 2, auto), (1, 2, 8) on 2 ranks: its output within 1e-5 and every
  gradient (parameters and inputs, the loss the sum of its squares) within
  5e-4 of one process's (``tests/test_pipeline_pp.py``'s bounds); each
  rank's stage layers called M times, the others never (no bubble work).
  Once with the hops on the all-gather that gloo takes for CUDA tensors.
- Dropout: the same generators give the same output, others another; the
  output equals one process's sequential stack run per microbatch under
  the generators of (the base seed, the global layer, the microbatch).
- Steps of ``futr`` with 4 decoder layers over a batch of 8 (JAX's
  ``_deep_futr_setup`` depth): on dp 2 x pp 2 (M = 2) and dp 1 x pp 2 the
  loss and every gradient against one process (the loss 1e-6, a gradient
  1e-6 of its tensor's largest entry) and against JAX's ``_grad_core`` on
  ``make_mesh(dp, pp)`` (1e-5), two steps against JAX's train step there
  (loss rtol 2e-4, parameters 5e-4); under FSDP, on tp 2 x pp 2, and on sp
  2 x pp 2 and with MoE (both decline with JAX's warning) against one
  process; the fusion model with dropout 0.1 on dp 2 x pp 2, two steps:
  the ranks' replicated tensors equal.
- No process: ``pipeline_plan``'s declines and their words, the MoE
  decline, ``make_mesh`` no longer refusing pp.
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3d_tpu.parallel.mesh import set_active_mesh, shard_batch, shard_state
from r3d_tpu.parallel.pipeline import pipeline_plan as jax_plan
from r3d_tpu.parallel.pipeline import set_pipeline_microbatches as jax_set_microbatches
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu.train.optim import make_optimizer
from r3d_tpu.train.state import TrainState
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models.layers import set_generators
from r3d_tpu_torch.models.transformer import TransformerDecoder
from r3d_tpu_torch.parallel import mesh as pm
from r3d_tpu_torch.parallel import pipeline as pl
from r3d_tpu_torch.parallel.tensor import Axis
from torch_parallel_ranks import (
    PP2_DECODER_CASES,
    PP_DECODER_CASES,
    decoder_pass,
    decoder_setup,
    finish,
    gpipe2_group,
    gpipe_group,
    init_state_dict,
    inputs,
    loader_for,
    pp_step_arm,
    setup_config,
    source_for,
    start,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

GRAD_TOL = 1e-6    # tests/test_torch_parallel.py's step bounds against one process
JAX_TOL = 1e-5     # tests/test_torch_parallel_steps.py's against JAX
PP_NAMES = ("pp_futr", "pp_moe", "pp_fusion")


def _jax_variables(name):
    """(JAX config, source, init variables) of ``name``: the flax init,
    jitted."""
    jcfg = setup_config(name, config=jax_config)
    jsrc = source_for(name, JaxSource)
    batch = jax.tree.map(np.asarray, next(iter(loader_for(name, jsrc, False, batch_size=8,
                                                          Loader=JaxLoader))))
    trainer = JaxTrainer(jcfg, jsrc.n_class)
    variables = jax.device_get(jax.jit(lambda r, *a: trainer.model.init(
        {"params": r, "dropout": jax.random.fold_in(r, 1)}, *a, train=False))(
        jax.random.PRNGKey(0), *trainer._model_inputs(batch, with_mask=False)))
    return jcfg, jsrc, batch, {"params": variables["params"], "batch_stats": {}}


def _jax_pp_runs(jcfg, jsrc, batch, variables, dp, steps):
    """On JAX's ``make_mesh(dp=dp, pp=2)`` (M = 2): the batch's gradients and
    metrics (``_grad_core``), then ``steps`` train steps: their losses and
    the state after."""
    mesh = jax_make_mesh(dp=dp, pp=2, devices=jax.devices()[:2 * dp])
    jax_set_microbatches(2)
    try:
        trainer = JaxTrainer(jcfg, jsrc.n_class, mesh=mesh)
        grads, metrics, _ = jax.jit(lambda p, bs, b: trainer._grad_core(
            p, bs, b, jax.random.PRNGKey(0), 0))(variables["params"], {},
                                                  shard_batch(batch, mesh))
        trainer.sched_steps_per_epoch = 5
        trainer.tx = make_optimizer(jcfg.train, 5)
        state = shard_state(TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                       batch_stats={},
                                       opt_state=trainer.tx.init(variables["params"])), mesh)
        step = trainer.make_train_step()
        losses = []
        for _ in range(steps):
            state, m = step(state, shard_batch(batch, mesh), jax.random.PRNGKey(7), 0)
            losses.append(float(m["loss"]))
        after = state_dict_from_flax(jax.device_get({"params": state.params}))
    finally:
        set_active_mesh(None)
        jax_set_microbatches(0)
    return dict(grads=state_dict_from_flax({"params": jax.device_get(grads)}),
                metrics=jax.device_get(metrics), losses=losses, state=after)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    jax_futr = _jax_variables("pp_futr")
    init = {"pp_futr": state_dict_from_flax(jax_futr[3]),
            "pp_moe": init_state_dict("pp_moe"), "pp_fusion": init_state_dict("pp_fusion")}
    started4 = start(gpipe_group, 4, tmp / "g4", init, timeout=400)
    started2 = start(gpipe2_group, 2, tmp / "g2", init, timeout=400)
    # while the ranks run: one process, then JAX's pp meshes
    dec, args, mask = decoder_setup()
    one = dict(decoder=decoder_pass(dec, args, mask),
               futr=pp_step_arm(None, "pp_futr", init["pp_futr"], steps=2),
               moe=pp_step_arm(None, "pp_moe", init["pp_moe"]),
               fusion_dropout=pp_step_arm(None, "pp_fusion", init["pp_fusion"], dropout=0.1))
    jax_runs = {dp: _jax_pp_runs(*jax_futr, dp, 2 if dp == 2 else 0) for dp in (1, 2)}
    return finish(started4), finish(started2), one, jax_runs


def _close(got, want, tol, scaled=True):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float((got[k].float() - w.float()).abs().max())
        assert err <= tol * (max(1.0, float(w.abs().max())) if scaled else 1.0), (k, err)


def _metrics_close(got, want):
    for k, v in want.items():
        if k.endswith(("_correct", "_total")):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-6 * max(1.0, abs(v)), (k, got[k], v)


@pytest.mark.parametrize("case", PP_DECODER_CASES + PP2_DECODER_CASES + ("gather_hops",),
                         ids=str)
def test_pipelined_decoder_matches_sequential(runs, case):
    four, two, one, _ = runs
    out, grads, arg_grads = one["decoder"]
    ranks = four if case in PP_DECODER_CASES + ("gather_hops",) else two
    dp, pp, M = (2, 2, 0) if case == "gather_hops" else case
    for r, res in enumerate(ranks):
        got = res["gather_hops"] if case == "gather_hops" else res["decoder"][case]
        want = out if got["rows"] is None else out[got["rows"]]
        np.testing.assert_allclose(got["out"].numpy(), want.numpy(), atol=1e-5)
        assert max(float((got["grads"][k] - g).abs().max()) for k, g in grads.items()) < 5e-4
        for a, b in zip(got["arg_grads"], arg_grads):
            assert float((a - b).abs().max()) < 5e-4
        # no bubble work: this stage's layers once a microbatch, no other layer
        d = r % pp
        n = M or pp
        assert got["calls"] == {li: n for li in range(d * 4 // pp, (d + 1) * 4 // pp)}, got["calls"]


def test_pipelined_dropout_is_seeded_per_layer_and_microbatch(runs):
    four = runs[0]
    a, b, c = four[0]["dropout"]
    assert torch.equal(a, b) and float((a - c).abs().max()) > 0
    assert torch.isfinite(a).all()
    for r in four[1:]:
        assert all(torch.equal(x, y) for x, y in zip(r["dropout"], four[0]["dropout"]))
    # one process, microbatch by microbatch under each (layer, microbatch)'s generators
    dec, args, mask = decoder_setup(dropout=0.3)
    dec.train()
    set_generators(dec, torch.Generator().manual_seed(5), torch.Generator().manual_seed(5))
    base = pl.draw_base_seed(dec.layers)
    outs = []
    with torch.no_grad():
        for m, chunk in enumerate(zip(*(t.chunk(4) for t in args + [mask]))):
            x, memory, pos, query, mk = chunk
            for li, layer in enumerate(dec.layers):
                with pl.stage_generators(layer, base, li, m):
                    x = layer(x, memory, pos, query, mk)
            outs.append(dec.norm(x))
    np.testing.assert_allclose(a.numpy(), torch.cat(outs).numpy(), atol=1e-5)


@pytest.mark.parametrize("ranks_of,arm", [(0, "dppp"), (1, "step")])
def test_futr_step_matches_one_process_and_jax_pp_mesh(runs, ranks_of, arm):
    ranks, one, jax_runs = runs[ranks_of], runs[2], runs[3]
    want = one["futr"]
    for r in ranks:
        got = r[arm]
        assert got["warnings"] == []
        _metrics_close(got["metrics"][0], want["metrics"][0])
        _close(got["grads"], want["grads"], GRAD_TOL)
        # the pp ranks' replicated states stay equal bit for bit
        for k, v in ranks[0][arm]["own"].items():
            assert torch.equal(v, got["own"][k]), k
    got = ranks[0][arm]
    j = jax_runs[2 if arm == "dppp" else 1]
    assert abs(got["metrics"][0]["loss"] - float(j["metrics"]["loss"])) < JAX_TOL
    _close(got["grads"], {k: v for k, v in j["grads"].items()}, JAX_TOL)
    if arm == "dppp":   # tests/test_pipeline_pp.py's bounds on two steps
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]], j["losses"], rtol=2e-4)
        _close(got["state"], j["state"], 5e-4, scaled=False)


@pytest.mark.parametrize("arm", ["fsdp", "tppp", "sppp", "moe"])
def test_composed_and_declined_meshes_match_one_process(runs, arm):
    four, one = runs[0], runs[2]
    want = one["moe" if arm == "moe" else "futr"]
    for r in four:
        got = r[arm]
        _metrics_close(got["metrics"][0], want["metrics"][0])
        _close(got["grads"], want["grads"], GRAD_TOL)
        if arm == "sppp":
            assert got["warnings"] and all("sp > 1" in w for w in got["warnings"])
        elif arm == "moe":
            assert got["warnings"] and all("MoE" in w for w in got["warnings"])
        else:
            assert got["warnings"] == []
        pipelined = arm in ("fsdp", "tppp")
        assert len(got["calls"]) == (2 if pipelined else 4 if arm == "sppp" else 2)


def test_fusion_dropout_steps_keep_the_pp_ranks_equal(runs):
    four, one = runs[0], runs[2]
    for dp in range(2):
        a, b = four[2 * dp]["fusion_dropout"], four[2 * dp + 1]["fusion_dropout"]
        assert a["own"].keys() == b["own"].keys()
        for k, v in a["own"].items():
            assert torch.equal(v, b["own"][k]), k
    got = four[0]["fusion_dropout"]
    assert all(np.isfinite(m["loss"]) for m in got["metrics"])
    assert any("running_mean" in k for k in got["own"])
    # the first loss is the batch's whatever the masks (dropout changes it little)
    assert abs(got["metrics"][0]["loss"] - one["fusion_dropout"]["metrics"][0]["loss"]) < 0.5


# ------------------------------------------------------------------ no process

def _axis(n):
    return Axis(None, n, 0)


def test_plan_declines_loudly_with_jax_words():
    """Every decline on a pp mesh warns with JAX's reason
    (tests/test_pipeline_pp.py:86-108); no pp axis is silent."""
    pp4 = _axis(4)
    assert pl.pipeline_plan(pp4, 1, 4, 8) == (pp4, 4)
    cases = [((3, 8), {}, "equal stages"), ((2, 8), {}, "equal stages"),
             ((4, 8), dict(sow_attn=True), "sowing"), ((4, 6), {}, "microbatches")]
    for (layers, batch), kw, words in cases:
        with pytest.warns(pl.PipelineFallbackWarning, match=words):
            assert pl.pipeline_plan(pp4, 1, layers, batch, **kw) is None
    pl.set_pipeline_microbatches(2)
    try:
        assert pl.pipeline_plan(pp4, 1, 4, 6) == (pp4, 2)
    finally:
        pl.set_pipeline_microbatches(0)
    with pytest.warns(pl.PipelineFallbackWarning, match="sp > 1"):
        assert pl.pipeline_plan(_axis(2), 2, 4, 8) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pl.pipeline_plan(None, 1, 4, 8) is None


def test_plan_declines_where_jax_declines():
    """The port's plan and JAX's decline on the same meshes with the same
    reason."""
    from r3d_tpu.parallel.pipeline import PipelineFallbackWarning as JaxWarning

    for layers, batch, M, sp in [(4, 8, 0, 1), (3, 8, 0, 1), (4, 6, 0, 1), (4, 6, 2, 1),
                                 (4, 8, 0, 2), (2, 8, 8, 1)]:
        set_active_mesh(jax_make_mesh(dp=8 // (2 * sp), sp=sp, pp=2))
        jax_set_microbatches(M)
        pl.set_pipeline_microbatches(M)
        try:
            with warnings.catch_warnings(record=True) as jw:
                warnings.simplefilter("always")
                want = jax_plan(layers, batch)
            with warnings.catch_warnings(record=True) as pw:
                warnings.simplefilter("always")
                got = pl.pipeline_plan(_axis(2), sp, layers, batch)
        finally:
            set_active_mesh(None)
            jax_set_microbatches(0)
            pl.set_pipeline_microbatches(0)
        assert (got is None) == (want is None)
        if want is not None:
            assert got[1] == want[2]
        reason = lambda ws: [str(w.message).split("declined: ")[1].split(" — ")[0] for w in ws
                             if issubclass(w.category, (JaxWarning, pl.PipelineFallbackWarning))]
        assert reason(pw) == reason(jw)


def test_moe_decoder_declines_loudly():
    dec = TransformerDecoder(16, 4, 2, 32, moe=(2, 1, 1.25))
    dec.set_pipeline(_axis(2), 1)
    x = torch.zeros(2, 3, 16)
    mem = torch.randn(2, 5, 16)
    with pytest.warns(pl.PipelineFallbackWarning, match="MoE"):
        dec(x, mem, None, torch.randn(2, 3, 16))


def test_make_mesh_takes_pp():
    """``make_mesh`` needs a group; pp is no longer refused before that."""
    with pytest.raises(RuntimeError, match="initialised"):
        pm.make_mesh(pp=2)
    assert not hasattr(pm, "check_mesh")
