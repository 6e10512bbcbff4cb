"""Sequence parallelism (``r3d_tpu_torch/parallel``, A14's sp axis) on one
spawned group of 4 gloo ranks (``tests/torch_parallel_ranks.py``), against
the one-process port and the JAX package's sp mesh.

- ``futr_fusion_bn`` and ``futr``, each with one encoder layer, in the 128
  bucket (their encoder's self-attention the ring on sp 2), two
  ``train_step``s on dp 2 x sp 2, tp 2 x sp 2 and FSDP dp 2 x sp 2, and on
  tp 2 x sp 2 with dropout and fuser dropout 0.1 (one dp coordinate: the
  masks are drawn whole, so they are one process's; the self-attention
  then gathers): the losses within 1e-5 relative and every tensor of the
  whole state (the parameters used before the gather, the embeds, the
  fuser and the encoder, those after it, the decoder, ``query_embed`` and
  the heads, and the BN running statistics) within 1e-5 of one process's;
  the ranks' states equal bit for bit.
- The first step's gradients on dp 2 x sp 2 within
  ``tests/test_torch_parallel.py``'s step bounds of one process's (loss
  1e-6, every gradient 1e-6 of its tensor's largest entry, the counts
  equal), and within 1e-5 of JAX's ``_grad_core`` on ``make_mesh(dp=2,
  sp=2)`` over 4 of the tests' CPU devices from the JAX init (dropout off);
  the two steps against JAX's ``make_train_step`` there at
  ``tests/test_mesh_matrix.py``'s bounds (loss rtol 2e-4, parameters
  5e-4).
- afft (its pool over the gathered fused stream) and a 65 bucket, which sp
  2 does not divide (it runs whole on the sp ranks), on dp 2 x sp 2.
- A checkpoint of one process restores on dp 2 x sp 2 under FSDP bit for
  bit; a step later its checkpoint restores on tp 2 x sp 2 and in one
  process bit for bit.
- ``fit``, ``fit_cached``, ``fit_hybrid``, ``grad_accum = 2`` and K = 2
  dispatch on dp 2 x sp 2 against the one-process run of the same route
  (``tests/test_torch_parallel_fit.py``'s bounds: the log lines to their
  decimals, the fit bounds on the states; in one process each route is
  held to ``fit`` by ``tests/test_torch_device_cache.py`` and
  ``tests/test_torch_dispatch.py``).
- No process: the sequence cut follows JAX's rule, the device cache
  gathers a rank's frames alone, and a pp mesh is taken. Every other
  family runs on sp:
  ``tests/test_torch_parallel_sp_families.py`` holds them.
"""

import dataclasses
import types

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
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu.train.optim import make_optimizer
from r3d_tpu.train.state import TrainState
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.eval.predict import Predictor
from r3d_tpu_torch.models import build_model
from r3d_tpu_torch.parallel import mesh as pm
from r3d_tpu_torch.train.checkpoint import Checkpointer
from r3d_tpu_torch.train.loop import Trainer
from test_torch_parallel import assert_step_matches
from test_torch_parallel_fit import assert_fit_state_close
from torch_parallel_ranks import (
    NQ,
    OBS,
    SP_FITS,
    SP_NAMES,
    fit_arm,
    finish,
    init_state_dict,
    loader_for,
    one_step_state,
    setup_config,
    source_for,
    sp_batches,
    sp_group,
    sp_steps_arm,
    start,
    step_arm,
    synthetic_videos,
    whole_train_state,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

SP_TOL = 1e-5
ARMS = ("dpsp", "tpsp", "fsdp", "dropout")


def _jax_variables(name):
    """(JAX config, source, init variables) of ``name``: the flax init,
    jitted, the fusion model's BN scales spread as
    ``torch_parallel_ranks._gammas`` spreads them."""
    jcfg = setup_config(name, config=jax_config)
    jsrc = source_for(name, JaxSource)
    batch = jax.tree.map(np.asarray, next(iter(loader_for(name, jsrc, False, Loader=JaxLoader))))
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
    return jcfg, jsrc, variables


def _jax_sp_runs(jcfg, jsrc, variables, name):
    """On JAX's ``make_mesh(dp=2, sp=2)``: the first batch's gradients,
    metrics and batch statistics (``_grad_core``), then two train steps over
    the first two batches: their losses and the state after."""
    it = iter(loader_for(name, jsrc, False, Loader=JaxLoader))
    batches = [jax.tree.map(np.asarray, next(it)) for _ in range(2)]
    mesh = jax_make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    try:
        trainer = JaxTrainer(jcfg, jsrc.n_class, mesh=mesh)
        grads, metrics, stats = jax.jit(lambda p, bs, b: trainer._grad_core(
            p, bs, b, jax.random.PRNGKey(0), 0))(variables["params"], variables["batch_stats"],
                                                  shard_batch(batches[0], mesh))
        # Trainer.init_state without its flax init: the port's schedule of 5 steps an epoch
        trainer.sched_steps_per_epoch = 5
        trainer.tx = make_optimizer(jcfg.train, 5)
        state = shard_state(TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                       batch_stats=variables["batch_stats"],
                                       opt_state=trainer.tx.init(variables["params"])), mesh)
        step = trainer.make_train_step()
        losses = []
        for b in batches:
            state, m = step(state, shard_batch(b, mesh), jax.random.PRNGKey(7), 0)
            losses.append(float(m["loss"]))
        after = state_dict_from_flax(jax.device_get({"params": state.params,
                                                     "batch_stats": state.batch_stats}))
    finally:
        set_active_mesh(None)
    return dict(grads=state_dict_from_flax({"params": jax.device_get(grads)}),
                metrics=jax.device_get(metrics),
                stats=state_dict_from_flax({"batch_stats": jax.device_get(stats)}),
                losses=losses, state=after)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    states = {n: _jax_variables(n) for n in SP_NAMES}
    init = {n: state_dict_from_flax(states[n][2]) for n in SP_NAMES}
    init.update({n: init_state_dict(n) for n in ("sp_afft", "sp_odd")})
    ckpt_in, ckpt_out = str(tmp / "ckpt_in"), str(tmp / "ckpt_out")
    _, state, _ = one_step_state(None, init["sp_fusion"], "sp_fusion")
    Checkpointer(ckpt_in).save_last(state, 1)
    saved = whole_train_state(state)
    started = start(sp_group, 4, tmp / "group", init, ckpt_in, ckpt_out, timeout=400)
    # while the ranks run: one process, then JAX's sp mesh
    one = {n: dict(steps=sp_steps_arm(None, n, init[n]),
                   dropout=sp_steps_arm(None, n, init[n], dropout=0.1),
                   step=step_arm(None, n, init[n])) for n in SP_NAMES}
    one.update({n: sp_steps_arm(None, n, init[n]) for n in ("sp_afft", "sp_odd")})
    one["fits"] = [fit_arm(None, route, name="sp_fusion", **kw) for route, kw in SP_FITS]
    jax_runs = {n: _jax_sp_runs(*states[n], n) for n in SP_NAMES}
    ranks = finish(started)
    return ranks, one, jax_runs, dict(init=init, saved=saved, ckpt_out=ckpt_out)


def _states_close(got, want, tol=SP_TOL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float((got[k].float() - w.float()).abs().max())
        assert err <= tol, (k, err)


def _losses_close(got, want, rtol=SP_TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a - b) <= rtol * max(1.0, abs(b)), (got, want)


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("name", SP_NAMES)
def test_sp_steps_match_one_process(runs, name, arm):
    ranks, one, _, _ = runs
    want = one[name]["dropout" if arm == "dropout" else "steps"]
    got = [r[name][arm] for r in ranks]
    _losses_close(got[0]["losses"], want["losses"])
    _states_close(got[0]["state"], want["state"])
    state = got[0]["state"]
    pre = [k for k in state if k.startswith(("embed.", "fuser.", "transformer.encoder."))]
    post = [k for k in state if k.startswith(("transformer.decoder.", "query_embed", "heads."))]
    assert pre and post and any("running_" in k for k in state) == (name == "sp_fusion")
    for r in got[1:]:
        for k, v in got[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k
    # the sequence was cut, and the encoder's self-attention took its route
    assert [r["seq"] for r in got] == [slice(0, 64), slice(64, 128)] * 2
    assert got[0]["routes"] == (["gathered"] if arm == "dropout" else ["ring"])
    assert want["routes"] == []


@pytest.mark.parametrize("name", SP_NAMES)
def test_sp_step_matches_one_process_and_jax_sp_mesh(runs, name):
    ranks, one, jax_runs, _ = runs
    got = ranks[0][name]["step"]
    assert_step_matches(got, one[name]["step"])
    assert any(k.startswith("embed.") for k in got["grads"])
    assert any(k.startswith("transformer.decoder.") for k in got["grads"])
    j = jax_runs[name]
    assert abs(got["metrics"]["loss"] - float(j["metrics"]["loss"])) < 1e-5
    for k in ("cls_correct", "cls_total", "seg_correct", "seg_total"):
        if k in got["metrics"]:
            assert got["metrics"][k] == int(j["metrics"][k]), k
    assert sorted(j["grads"]) == sorted(got["grads"])
    for k, w in j["grads"].items():
        err = float((got["grads"][k] - w).abs().max())
        assert err <= 1e-5 * max(1.0, float(w.abs().max())), (k, err)
    for k, w in j["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), w.numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
    # two steps: tests/test_mesh_matrix.py's bounds
    steps = ranks[0][name]["dpsp"]
    np.testing.assert_allclose(steps["losses"], j["losses"], rtol=2e-4)
    _states_close(steps["state"], j["state"], 5e-4)


@pytest.mark.parametrize("name", ["sp_afft", "sp_odd"])
def test_afft_and_an_undivided_bucket_match_one_process(runs, name):
    ranks, one, _, _ = runs
    for r in ranks:
        _losses_close(r[name]["losses"], one[name]["losses"])
        _states_close(r[name]["state"], one[name]["state"])
        # 65 frames do not split over sp 2: the sequence runs whole
        assert (r[name]["seq"] is None) == (name == "sp_odd")
    assert ranks[0]["sp_odd"]["routes"] == []


def test_sp_checkpoint_round_trips(runs):
    ranks, _, _, extra = runs
    saved = extra["saved"]
    for r in ranks:
        restored = r["checkpoint"]["restored"]
        assert restored["step"] == saved["step"]
        for part in ("model", "optimizer"):
            assert sorted(restored[part]) == sorted(saved[part])
            for k, v in saved[part].items():
                assert torch.equal(restored[part][k], v), (part, k)
    after = ranks[0]["checkpoint"]["after"]
    _, state, _ = one_step_state(None, extra["init"]["sp_fusion"], "sp_fusion")
    back = whole_train_state(Checkpointer(extra["ckpt_out"]).restore_last(1, state))
    for got in [back] + [r["restored_tpsp"] for r in ranks]:
        assert got["step"] == after["step"]
        for part in ("model", "optimizer"):
            assert sorted(got[part]) == sorted(after[part])
            for k, v in after[part].items():
                assert torch.equal(got[part][k], v), (part, k)


@pytest.mark.parametrize("arm", range(len(SP_FITS)),
                         ids=[r + "".join(f"_{k}{v}" for k, v in kw.items()) for r, kw in SP_FITS])
def test_sp_fit_routes_match(runs, arm):
    ranks, one, _, _ = runs
    strip = lambda lines: [line.split("(")[0] for line in lines]
    got, want = ranks[0]["fits"][arm], one["fits"][arm]
    assert strip(got["log"]) == strip(want["log"]) and ranks[1]["fits"][arm]["log"] == []
    assert got["step"] == want["step"]
    assert_fit_state_close(got["state"], want["state"])


# ------------------------------------------------------------------ no process

def test_sequence_cut_follows_jax_rule():
    """Every array whose axis 1 (axis 2 stacked) is the features' length is
    cut; the n_query arrays stay whole."""
    B, S = 4, 16
    batch = {"features": torch.zeros(B, S, 3), "depth_features": torch.zeros(B, S, 2, 2),
             "past_label": torch.zeros(B, S), "trans_future_target": torch.zeros(B, NQ),
             "trans_future_dur": torch.zeros(B, NQ)}
    cut = pm.take_seq(batch, slice(8, 16))
    assert {k: tuple(v.shape) for k, v in cut.items()} == {
        "features": (B, 8, 3), "depth_features": (B, 8, 2, 2), "past_label": (B, 8),
        "trans_future_target": (B, NQ), "trans_future_dur": (B, NQ)}
    stacked = {k: v[None].expand(2, *v.shape) for k, v in batch.items()}
    cut = pm.take_seq(stacked, slice(0, 8), axis=2)
    assert cut["features"].shape == (2, B, 8, 3) and cut["trans_future_dur"].shape == (2, B, NQ)
    assert pm.take_seq(batch, None) is batch


def test_device_cache_gathers_a_ranks_frames():
    """``assemble`` and ``assemble_eval`` with an sp rank's frames equal the
    whole batch cut to them, filler rows and padding included."""
    src = source_for("sp_fusion")
    cache = dc.build_cache(synthetic_videos(src), OBS, 1, NQ, src.pad_idx, src.n_class, (128,),
                           device="cpu")
    ids = torch.arange(4)
    whole = dc.assemble(cache.data, ids, 128, 1, cache.pad_idx, None)
    vid, real = torch.tensor([0, 1, 2, 0]), torch.tensor([50, 128, 70, 0])
    whole_eval = dc.assemble_eval(cache.data, vid, real, 128, 1)
    for seq in (slice(0, 64), slice(64, 128)):
        part = dc.assemble(cache.data, ids, 128, 1, cache.pad_idx, None, seq)
        for k, v in whole.items():
            want = v[:, seq] if v.shape[1] == 128 else v
            assert torch.equal(part[k], want), k
        part = dc.assemble_eval(cache.data, vid, real, 128, 1, seq)
        for k, v in whole_eval.items():
            assert torch.equal(part[k], v[:, seq]), k


def _sp_mesh(sp=2, pp=1):
    """The layout of a ``DeviceMesh`` with ``sp`` and ``pp`` ranks (building
    one takes the ranks): enough for a constructor."""
    return types.SimpleNamespace(mesh_dim_names=pm.DIMS, mesh=torch.empty(1, 1, 1, sp, pp))


def test_pp_mesh_is_taken():
    """The trainer and the predictor take a pp mesh (the pipeline runs in
    ``tests/test_torch_parallel_pp*.py``)."""
    cfg = setup_config("sp_fusion")
    mesh = _sp_mesh(sp=1, pp=2)
    assert Trainer(cfg, 6, device="cpu", mesh=mesh).mesh is mesh
    assert Predictor(cfg, build_model(cfg.model, 6, (6, 5)), 6, device="cpu", mesh=mesh).mesh is mesh