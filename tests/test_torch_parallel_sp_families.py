"""Sequence parallelism for every family (``r3d_tpu_torch/parallel``, A14's
sp axis): the query models and their loops, gaze, MoE and the rnn/cnn/tcn
baselines, on one spawned group of 4 gloo ranks
(``tests/torch_parallel_ranks.py``), against the one-process port and the
JAX package's sp mesh.

- Each family (``SP_FAMILIES``: ``futr_proposed`` in the proposed loop;
  ``futr_unsupervised``, ``temp2``, ``temp3`` and the depth source in the
  unsupervised loop, epoch 2, SupCon over the first 300 frames of the
  global batch; ``futr_gaze`` with its gaze stream cut; ``futr`` with MoE
  and the encoder at a capacity that drops assignments; ``rnn``, ``cnn``,
  ``tcn``) in the 128 bucket, two ``train_step``s on dp 2 x sp 2 against
  one process: the losses within 1e-5 relative, every tensor of the whole
  state within 1e-5 (those used before a gather over sp and those after it
  among them), the ranks' states equal bit for bit; the self-attention
  source on tp 2 x sp 2 and MoE on ep 2 x sp 2 the same; the gt and depth
  sources on tp 2 x sp 2 with dropout 0.1 and the hard-coded dropouts on
  (one dp coordinate draws one process's masks).
- L3 generation (``FUTRTransformer(l3_queries=True)``, which no model
  reaches) with the encoder on dp 2 x sp 2: its outputs and every gradient
  within 1e-5 of one process's.
- ``futr_proposed``, ``futr_unsupervised``, MoE and ``rnn`` from the JAX
  init: the two steps against JAX's ``make_train_step`` on
  ``make_mesh(dp=2, sp=2)`` over 4 of the tests' CPU devices, dropout off,
  at ``tests/test_mesh_matrix.py``'s bounds (loss rtol 2e-4, parameters
  5e-4).
- The traps, each of which a first-order mistake fails: the cluster loss
  with segments across the cut, SupCon's frames in the global batch's
  order, MoE's queue places with per-row offsets at a dropping capacity
  (cut tokens and rows every sp rank holds whole), the self-attention
  source's keys the dp group's rows at the rank's frames, the positions of
  the rank's range.
- ``fit`` and ``fit_cached`` of the unsupervised loop (segment ids derived
  on the card from the gathered query labels), ``grad_accum = 2`` and K = 2
  dispatch of the proposed loop on dp 2 x sp 2 against one process's run
  of the same route (``tests/test_torch_parallel_fit.py``'s bounds), and
  ``fit_cached`` against ``fit`` on the group.
- A checkpoint of one process restores on dp 2 x sp 2 bit for bit, and the
  one written there after a step restores in one process bit for bit, for
  ``futr_proposed`` and ``futr_unsupervised``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import write_darai_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.losses.temporal import segment_ids_from_labels as jax_segment_ids
from r3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3d_tpu.parallel.mesh import set_active_mesh, shard_batch, shard_state
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu.train.optim import make_optimizer
from r3d_tpu.train.state import TrainState
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.train.checkpoint import Checkpointer
from test_torch_parallel_fit import assert_fit_state_close
from torch_parallel_ranks import (
    SP_FAMILIES,
    SP_FAMILY_CKPTS,
    SP_FAMILY_DROPOUT,
    SP_FAMILY_EPOCH,
    SP_FAMILY_FITS,
    SP_FAMILY_MESHES,
    SP_JAX_FAMILIES,
    families_group,
    family_steps,
    finish,
    fit_arm,
    init_state_dict,
    l3_generation_arm,
    loader_for,
    one_step_state,
    setup_config,
    source_for,
    start,
    traps_arm,
    whole_train_state,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

SP_TOL = 1e-5
GAZE_TRAIN = ((80, 90), (100,), (70, 75))
GAZE_VAL = ((85,),)
# the parameters each family uses before its gather over sp (the embeds, the
# encoder, the self-attention source's attention) and after it
PRE = ("embed.", "transformer.encoder.", "l3_attention.", "query_embed", "depth_embed.",
       "pos_embedding", "block0_", "heads.fc_seg", "fc_seg", "gaze_cnn.")
POST = ("transformer.decoder.", "heads.fc.", "heads.fc_len", "fc.", "fc_len", "rnn.", "rnn_fc",
        "block3_", "regression", "query_embed", "fc_l3")


@contextlib.contextmanager
def jax_fixed_dropouts_off():
    """JAX's query models with their hard-coded ``Dropout(0.1)``s at rate 0
    (``r3d_tpu/models/futr_unsupervised.py:133, 184``), as the port's arms
    run theirs: the module's ``nn`` is flax's but for ``Dropout``."""
    import flax.linen as fnn

    from r3d_tpu.models import futr_unsupervised as jfu

    class Flax:
        def __getattr__(self, k):
            return getattr(fnn, k)

        @staticmethod
        def Dropout(rate, *a, **kw):
            return fnn.Dropout(0.0, *a, **kw)

    saved, jfu.nn = jfu.nn, Flax()
    try:
        yield
    finally:
        jfu.nn = saved


def _jax_run(name):
    """(the port's init from JAX's, JAX's two train steps on ``make_mesh(dp=2,
    sp=2)``: their losses and the state after) of ``name``'s first two
    batches, in its epoch."""
    jcfg = setup_config(name, config=jax_config)
    jsrc = source_for(name, JaxSource)
    it = iter(loader_for(name, jsrc, False, Loader=JaxLoader))
    batches = [jax.tree.map(np.asarray, next(it)) for _ in range(2)]
    if jcfg.train.loop == "unsupervised":
        for b in batches:
            b["seg_ids"] = jax_segment_ids(b["query_label"], None, jcfg.train.max_segments)
    epoch = SP_FAMILY_EPOCH[name]
    with jax_fixed_dropouts_off():
        trainer = JaxTrainer(jcfg, jsrc.n_class)
        variables = jax.device_get(jax.jit(lambda r, *a: trainer.model.init(
            {"params": r, "dropout": jax.random.fold_in(r, 1)}, *a, train=False))(
            jax.random.PRNGKey(0), *trainer._model_inputs(batches[0], with_mask=False)))
        mesh = jax_make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
        try:
            trainer = JaxTrainer(jcfg, jsrc.n_class, mesh=mesh)
            trainer.sched_steps_per_epoch = 5
            trainer.tx = make_optimizer(jcfg.train, 5)
            params = variables["params"]
            state = shard_state(TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                           batch_stats=variables.get("batch_stats", {}),
                                           opt_state=trainer.tx.init(params)), mesh)
            step = trainer.make_train_step()
            losses = []
            for b in batches:
                state, m = step(state, shard_batch(b, mesh), jax.random.PRNGKey(7), epoch)
                losses.append(float(m["loss"]))
            after = state_dict_from_flax(jax.device_get({"params": state.params,
                                                         "batch_stats": state.batch_stats}))
        finally:
            set_active_mesh(None)
    return state_dict_from_flax({"params": variables["params"]}), dict(losses=losses, state=after)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_families")
    root = write_darai_dataset(str(tmp / "ds"), GAZE_TRAIN, GAZE_VAL, input_dim=12,
                               gaze_rows=(50, 64))
    jax_runs = {n: _jax_run(n) for n in SP_JAX_FAMILIES}
    init = {n: jax_runs[n][0] if n in jax_runs else init_state_dict(n, root=root)
            for n in SP_FAMILIES}
    ckpts, saved = {}, {}
    for n in SP_FAMILY_CKPTS:
        ckpts[n] = (str(tmp / f"{n}_in"), str(tmp / f"{n}_out"))
        _, state, _ = one_step_state(None, init[n], n)
        Checkpointer(ckpts[n][0]).save_last(state, 1)
        saved[n] = whole_train_state(state)
    started = start(families_group, 4, tmp / "group", init, root, ckpts, timeout=600)
    # while the ranks run: one process
    one = {n: dict(dpsp=family_steps(None, n, init[n], root)) for n in SP_FAMILIES}
    for n in SP_FAMILY_MESHES:
        one[n]["other"] = one[n]["dpsp"]
    for n in SP_FAMILY_DROPOUT:
        one[n]["dropout"] = family_steps(None, n, init[n], root, dropout=0.1)
    one["l3_generation"] = l3_generation_arm(None)
    one["traps"] = traps_arm(None)
    one["fits"] = [fit_arm(None, route, name=n, **kw) for n, route, kw in SP_FAMILY_FITS]
    ranks = finish(started)
    return ranks, one, {n: r[1] for n, r in jax_runs.items()}, dict(init=init, saved=saved,
                                                                    ckpts=ckpts)


def _states_close(got, want, tol=SP_TOL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float((got[k].float() - w.float()).abs().max())
        assert err <= tol, (k, err)


def _losses_close(got, want, rtol=SP_TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a - b) <= rtol * max(1.0, abs(b)), (got, want)


def _held(ranks, want, name, arm):
    got = [r[name][arm] for r in ranks]
    _losses_close(got[0]["losses"], want["losses"])
    _states_close(got[0]["state"], want["state"])
    for r in got[1:]:
        for k, v in got[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k
    return got


@pytest.mark.parametrize("name", SP_FAMILIES)
def test_family_steps_match_one_process(runs, name):
    ranks, one, _, _ = runs
    got = _held(ranks, one[name]["dpsp"], name, "dpsp")
    state = got[0]["state"]
    assert any(k.startswith(PRE) for k in state) and any(k.startswith(POST) for k in state)
    # every family's sequence was cut, as JAX's rule cuts it
    half = 32 if name == "sp_gaze" else 64
    assert [r["seq"] for r in got] == [slice(0, half), slice(half, 2 * half)] * 2
    # the S-query decoders' and the encoder's self-attention took the ring
    ring = name in ("sp_proposed", "sp_depth", "sp_moe")
    assert got[0]["routes"] == (["ring"] if ring else [])


@pytest.mark.parametrize("name", list(SP_FAMILY_MESHES))
def test_family_steps_on_tp_or_ep_sp_match_one_process(runs, name):
    ranks, one, _, _ = runs
    _held(ranks, one[name]["other"], name, "other")


@pytest.mark.parametrize("name", SP_FAMILY_DROPOUT)
def test_family_dropout_steps_match_one_process(runs, name):
    """One dp coordinate draws one process's masks: the configured and the
    hard-coded dropouts draw whole and keep the rank's frames, the decoder's
    attention gathers over sp."""
    ranks, one, _, _ = runs
    got = _held(ranks, one[name]["dropout"], name, "dropout")
    assert got[0]["routes"] == ["gathered"]


def test_l3_generation_matches_one_process(runs):
    ranks, one, _, _ = runs
    want = one["l3_generation"]
    for r in ranks:
        got = r["l3_generation"]
        rows, seq = got["rows"], got["seq"]
        assert seq != slice(None)
        for k, w in (("hs", want["hs"][rows]), ("memory", want["memory"][rows, seq]),
                     ("dx", want["dx"][rows, seq])):
            assert float((got[k] - w).abs().max()) <= SP_TOL, k
        assert sorted(got["grads"]) == sorted(want["grads"])
        for k, w in want["grads"].items():
            err = float((got["grads"][k] - w).abs().max())
            assert err <= SP_TOL * max(1.0, float(w.abs().max())), (k, err)


@pytest.mark.parametrize("name", SP_JAX_FAMILIES)
def test_family_steps_match_jax_sp_mesh(runs, name):
    ranks, _, jax_runs, _ = runs
    got, want = ranks[0][name]["dpsp"], jax_runs[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    _states_close(got["state"], want["state"], 5e-4)


# ------------------------------------------------------------------ the traps

def _trap(runs, key):
    ranks, one, _, _ = runs
    return [r["traps"] for r in ranks], one["traps"], key


def test_cluster_loss_across_the_cut_matches_one_process(runs):
    got, want, _ = _trap(runs, "cluster")
    # the ranks' mean is the global loss, and each rank's block of the
    # gradient of the ranks' summed losses is W times one process's
    assert abs(np.mean([g["cluster"] for g in got]) - want["cluster"]) <= 1e-6
    for g in got:
        assert g["seq"] != slice(None)
        w = want["cluster_grad"][g["rows"], g["seq"]]
        assert float((g["cluster_grad"] / len(got) - w).abs().max()) <= 1e-6


def test_supcon_frames_in_the_global_batch_order(runs):
    got, _, _ = _trap(runs, "supcon_order")
    for g in got:
        assert torch.equal(g["supcon_order"], torch.arange(64, dtype=torch.float32))


def test_moe_queue_places_per_row_match_one_process(runs):
    got, want, _ = _trap(runs, "moe")
    for g in got:
        rows, seq = g["rows"], g["seq"]
        assert float((g["moe_tokens"] - want["moe_tokens"][rows, seq]).abs().max()) <= 1e-6
        assert float((g["moe_rows"] - want["moe_rows"][rows]).abs().max()) <= 1e-6
        for k in ("moe_tokens_aux", "moe_rows_aux"):
            assert abs(g[k] - want[k]) <= 1e-6, k
    # the capacity drops assignments: some tokens come out zero, not all
    for k in ("moe_tokens", "moe_rows"):
        dropped = (want[k].abs().sum(-1) == 0).float().mean()
        assert 0.0 < float(dropped) < 1.0, k


def test_self_attention_keys_are_the_dp_rows_at_the_ranks_frames(runs):
    got, want, _ = _trap(runs, "keys")
    for g in got:
        assert torch.equal(g["keys"], want["keys"][:, g["seq"]])


def test_positions_take_the_ranks_range(runs):
    got, want, _ = _trap(runs, "positions")
    for g in got:
        assert torch.equal(g["positions"], want["positions"][:, :16][:, g["seq"]])


# ------------------------------------------------- the routes and checkpoints

@pytest.mark.parametrize("arm", range(len(SP_FAMILY_FITS)),
                         ids=[f"{n}_{r}" + "".join(f"_{k}{v}" for k, v in kw.items())
                              for n, r, kw in SP_FAMILY_FITS])
def test_family_fit_routes_match_one_process(runs, arm):
    ranks, one, _, _ = runs
    strip = lambda lines: [line.split("(")[0] for line in lines]
    got, want = ranks[0]["fits"][arm], one["fits"][arm]
    assert strip(got["log"]) == strip(want["log"]) and ranks[1]["fits"][arm]["log"] == []
    assert got["step"] == want["step"]
    assert_fit_state_close(got["state"], want["state"])


def test_fit_cached_equals_fit_on_sp(runs):
    """The cached route's segment ids, derived on the card from each row's
    query labels gathered over sp, are the host route's."""
    ranks, _, _, _ = runs
    fit, cached = ranks[0]["fits"][0], ranks[0]["fits"][1]
    strip = lambda lines: [line.split("(")[0] for line in lines]
    assert strip(fit["log"]) == strip(cached["log"])
    assert_fit_state_close(cached["state"], fit["state"])


@pytest.mark.parametrize("name", SP_FAMILY_CKPTS)
def test_family_checkpoints_round_trip(runs, name):
    ranks, _, _, extra = runs
    saved = extra["saved"][name]
    for r in ranks:
        restored = r["checkpoints"][name]["restored"]
        assert restored["step"] == saved["step"]
        for part in ("model", "optimizer"):
            assert sorted(restored[part]) == sorted(saved[part])
            for k, v in saved[part].items():
                assert torch.equal(restored[part][k], v), (part, k)
    after = ranks[0]["checkpoints"][name]["after"]
    _, state, _ = one_step_state(None, extra["init"][name], name)
    back = whole_train_state(Checkpointer(extra["ckpts"][name][1]).restore_last(1, state))
    assert back["step"] == after["step"]
    for part in ("model", "optimizer"):
        for k, v in after[part].items():
            assert torch.equal(back[part][k], v), (part, k)


# ------------------------------------------------------------------ no process

def test_a_gaze_stream_that_would_read_as_cut_raises():
    """A gaze stream padded to S/sp rows of a bucket of S is not cut, but
    would read as the rank's frames: refused on an sp mesh, as is no other
    gaze length."""
    import types

    from r3d_tpu_torch.models.futr_unsupervised import check_gaze_cut
    from r3d_tpu_torch.parallel import mesh as pm

    sp2 = types.SimpleNamespace(mesh_dim_names=pm.DIMS, mesh=torch.empty(1, 1, 1, 2, 1))
    cfg = pt_config.get_config("darai_gaze")
    for n, refused in ((1000, True), (2000, False), (None, False), (300, False)):
        c = cfg.replace(data=dataclasses.replace(cfg.data, gaze_pad_len=n))
        if refused:
            with pytest.raises(ValueError, match="gaze_pad_len"):
                check_gaze_cut(c, sp2)
        else:
            check_gaze_cut(c, sp2)
        check_gaze_cut(c, None)
