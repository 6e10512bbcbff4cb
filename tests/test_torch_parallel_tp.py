"""Tensor and expert parallelism (``r3d_tpu_torch/parallel``) on the CPU:
the rule table against the JAX package's, and one spawned group of 2 gloo
ranks (``tests/torch_parallel_ranks.py``) that runs every 2-rank arm
against the one-process run from the same weights and batch.

- The rule table, no process: for every model of the registry (and MoE
  with the encoder, the depth source), the port's spec of each parameter,
  taken through the converter's flax path, equals JAX's
  ``param_shardings`` spec on ``make_mesh(dp=4, tp=2)``, ``make_mesh(dp=2,
  ep=4)`` (6 experts: 'ep' does not divide and drops) and ``make_mesh(tp=8)``
  (hidden 36: the attention rules drop, the FFN's hold), with and without
  FSDP; the ``mlp1``/``mlp2`` rules match nothing; a layer runs split
  exactly where its rules hold, but attention whose 4 heads tp 8 does not
  divide, which stays whole as JAX's kernel does.
- tp 2 (``futr_fusion_bn`` in the 256 bucket, 4 heads), ep 2 (``futr``
  with 4 experts), and dp 2 for MoE at a capacity that drops assignments,
  ``darai`` (SupCon on, epoch 2: the cluster and SupCon terms weigh in; its
  heads lean to one label each, so that the ranks' correctness rates
  differ) and the self-attention source: the
  tolerances of ``tests/test_torch_parallel.py`` (the loss 1e-6, every
  gradient 1e-6 of its tensor's largest entry, the BatchNorm statistics
  1e-6, the parameters after one update 2 lr, the counts and masks equal).
  The ranks end with equal parameters, bit for bit.
- tp 2 with dropout on (two steps): the one-process steps within the same
  bounds (each rank draws the whole masks and keeps its slice), and every
  replicated tensor bit-equal across the tp ranks.
- The checkpoint: one process's checkpoint restores into tp 2 bit for bit,
  and tp 2's checkpoint restores into one process bit for bit.
"""

import types

import numpy as np
import pytest
import torch

import jax

from chip_smoke import write_darai_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.parallel.mesh import _fsdp_spec as jax_fsdp_spec
from r3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r3d_tpu.parallel.mesh import param_shardings
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import _param, flax_path
from r3d_tpu_torch.models import build_model
from r3d_tpu_torch.models.layers import MultiheadAttention
from r3d_tpu_torch.parallel import mesh as pm
from r3d_tpu_torch.train.checkpoint import Checkpointer
from test_torch_parallel import assert_step_matches
from torch_parallel_ranks import (
    TP_NAME,
    dropout_steps_arm,
    finish,
    init_state_dict,
    inputs,
    one_step_state,
    start,
    step_arm,
    tp_group,
    whole_train_state,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 17
DARAI_TRAIN = ((80, 90), (100,), (70, 75))
DARAI_VAL = ((85,),)
DARAI_L3, DARAI_ACTION = 29, 3   # labels of the first batch's frames (_leaning)

# ------------------------------------------------------------ the rule table

REGISTRY = ("futr_fusion_bn", "futr_fusion_grad", "futr_fusion_vary", "futr_fusion_nox", "afft",
            "futr", "futr_baseline", "futr_proposed", "futr_unsupervised",
            "futr_unsupervised_temp2", "futr_unsupervised_temp3", "futr_unsupervised_depth",
            "futr_gaze", "rnn", "cnn", "tcn")
# the cases: a registry model, or (name, model, overrides)
RULE_CASES = [(m, m, {}) for m in REGISTRY] + [
    ("futr_moe_encoder", "futr", dict(moe_experts=4, moe_top_k=2, use_encoder=True,
                                      n_encoder_layers=1)),
    ("futr_moe_6", "futr", dict(moe_experts=6, moe_top_k=2)),
    ("futr_fusion_bn_36", "futr_fusion_bn", dict(hidden_dim=36)),
]
MESHES = (dict(dp=4, tp=2), dict(dp=2, ep=4), dict(dp=1, tp=8))   # tp 8: 4 heads stay whole


def _init_args(model, S=16):
    rng = np.random.RandomState(0)
    x = rng.randn(2, S, 12).astype(np.float32)
    mask = np.zeros((2, S), bool)
    if model in ("futr_fusion_bn", "futr_fusion_grad", "futr_fusion_vary", "futr_fusion_nox",
                 "afft"):
        return (x, rng.rand(2, S, 8, 8).astype(np.float32), None)
    if model == "futr_gaze":
        return (x, rng.rand(2, 40, 2).astype(np.float32), mask, np.array([40, 17], np.int32))
    if model in ("rnn", "cnn", "tcn"):
        return (x, mask)
    if model == "futr_proposed":
        return (x, np.ones((2, S), np.int32), None)
    if model == "futr_unsupervised_depth":
        return (x, np.ones((2, S), np.float32), None)
    return (x, None)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def jax_meshes():
    return [jax_make_mesh(**kw, devices=jax.devices()[:8]) for kw in MESHES]


@pytest.mark.parametrize("case", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_table_matches_jax(case, jax_meshes):
    name, model, kw = case
    kw = dict(dict(model=model, hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                   max_pos_len=16, dropout=0.0, n_decoder_layers=1, query_num=10), **kw)
    shapes = jax.eval_shape(
        lambda key: jax_build_model(jax_config.ModelConfig(**kw), N_CLASS).init(
            key, *_init_args(model), train=False), jax.random.PRNGKey(1))["params"]
    port = build_model(pt_config.ModelConfig(**kw), N_CLASS, (8, 8))
    params = dict(port.named_parameters())
    leaves = {"/".join(p): s for p, s in _leaves(shapes)}
    # the converter's naming both ways: every leaf lands on a parameter that
    # names it back (an LSTM's cells make stacked weights, which the rules
    # never shard)
    for path, s in _leaves(shapes):
        if any(p.startswith("OptimizedLSTMCell") for p in path):
            continue
        torch_name, _ = _param(path, np.zeros(s.shape, np.float32))
        assert torch_name in params, (path, torch_name)
        assert flax_path(port, torch_name)[0] == "/".join(path)
    matched, split_any = set(), False
    for mesh, sizes in zip(jax_meshes, MESHES):
        sizes = dict(dict(dp=1, ep=1, tp=1, sp=1, pp=1), **sizes)
        for fsdp in (False, True):
            want = {"/".join(str(k.key) for k in p): s.spec for p, s in
                    jax.tree_util.tree_flatten_with_path(param_shardings(mesh, shapes,
                                                                         fsdp=fsdp))[0]}
            for n, t in params.items():
                path, perm = flax_path(port, n)
                got = pm.param_spec(port, n, sizes)
                if fsdp:
                    flax_shape = [t.shape[perm.index(a)] for a in range(t.dim())]
                    spec = [None] * t.dim()
                    for i, a in enumerate(got):
                        spec[perm[i]] = a
                    flax_spec = pm._fsdp_spec(tuple(spec) if got else (), flax_shape,
                                              sizes["dp"], pm.FSDP_MIN_ELEMS)
                    assert flax_spec == tuple(jax_fsdp_spec(jax.sharding.PartitionSpec(
                        *(tuple(spec) if got else ())), flax_shape, sizes["dp"],
                        pm.FSDP_MIN_ELEMS))
                    if path in want:
                        pad = lambda x: tuple(x) + (None,) * (t.dim() - len(x))
                        assert pad(flax_spec) == pad(want[path]), (n, flax_spec, want[path])
                    continue
                if path not in want:   # an LSTM's stacked gates: no rule names them
                    assert got == () and "OptimizedLSTMCell" not in path, n
                    continue
                w = tuple(want[path]) + (None,) * (t.dim() - len(want[path]))
                assert got == (tuple(w[a] for a in perm) if any(w) else ()), (n, got, w)
                if got:
                    matched.add(path)
            # the layers that run split: exactly where their rules hold, but
            # attention whose heads do not divide (JAX runs it whole)
            fake = types.SimpleNamespace(mesh_dim_names=pm.DIMS,
                                         mesh=torch.empty(*(sizes[d] for d in pm.DIMS)))
            plan = pm._plan(port, fake)
            for n in params:
                spec = tuple((d, a) for d, a in enumerate(pm.param_spec(port, n, sizes))
                             if a is not None and sizes[a] > 1)
                owner = port.get_submodule(n.rsplit(".", 2)[0]) if n.count(".") > 1 else port
                if isinstance(owner, MultiheadAttention) and owner.n_head % sizes["tp"]:
                    assert n not in plan, n
                else:
                    assert plan.get(n, ()) == spec, (n, plan.get(n), spec)
                    split_any |= bool(spec)
    assert not any(("mlp1" in p or "mlp2" in p) for p in matched), matched
    if "moe_experts" in kw:
        assert any("experts" in p for p in matched)
    assert split_any == (model not in ("rnn", "cnn", "tcn"))


def test_mlp_rules_match_no_parameter():
    """JAX's fuser weights are flat (``mlp1_kernel``): the ``mlp1/kernel``
    rules name no leaf of any model, so the fuser stays replicated."""
    port = build_model(pt_config.ModelConfig(model="futr_fusion_bn", hidden_dim=32, n_head=4,
                                             n_query=8, input_dim=12, max_pos_len=16),
                       N_CLASS, (8, 8))
    sizes = dict(dp=1, ep=1, tp=2, sp=1, pp=1)
    mlp = [n for n in dict(port.named_parameters()) if ".mlp" in n]
    assert mlp and all(pm.param_spec(port, n, sizes) == () for n in mlp)
    assert [flax_path(port, n)[0].rsplit("/", 1)[1] for n in mlp if n.endswith("weight")][:2] \
        == ["mlp1_kernel", "mlp2_kernel"]


# -------------------------------------------------------- one group of two

ARMS = ("futr_moe", "futr_moe_drop", "self_attention")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = write_darai_dataset(tmp_path_factory.mktemp("darai_tp"), DARAI_TRAIN, DARAI_VAL,
                               input_dim=12, seed=6)
    init = {n: init_state_dict(n) for n in (TP_NAME,) + ARMS}
    init["darai"] = _leaning(init_state_dict("darai", root=root))
    # one process's checkpoint after a step, for tp 2 to restore
    ckpt_in, ckpt_out = tmp_path_factory.mktemp("ckpt_in"), tmp_path_factory.mktemp("ckpt_out")
    _, state, _ = one_step_state(None, init[TP_NAME])
    Checkpointer(str(ckpt_in)).save_last(state, 1)
    saved = whole_train_state(state)
    started = start(tp_group, 2, tmp_path_factory.mktemp("tp2"), init, root, str(ckpt_in),
                    str(ckpt_out))
    one = {n: step_arm(None, n, init[n]) for n in (TP_NAME,) + ARMS}
    one["darai"] = step_arm(None, "darai", init["darai"], root=root, epoch=2)
    one["tp_dropout"] = dropout_steps_arm(None, init[TP_NAME])
    return finish(started), one, dict(saved=saved, ckpt_out=str(ckpt_out), root=root,
                                      init=init)


def _leaning(sd):
    """``darai``'s init with its L3 and seg heads leaning to L3 label 29 and
    action 3 (+10 on their biases): at the seeded init no frame is right,
    and the correctness gate's mean would be 5 on every rank alike; so some
    frames are, and the two ranks' rows give different rates."""
    sd = dict(sd)
    for k, label in (("fc_l3.bias", DARAI_L3), ("heads.fc_seg.bias", DARAI_ACTION)):
        sd[k] = sd[k].clone()
        sd[k][label] += 10.0
    return sd


def _same_params(ranks, key):
    for k, v in ranks[0][key]["params"].items():
        assert torch.equal(v, ranks[1][key]["params"][k]), k


@pytest.mark.parametrize("arm,name", [("tp", TP_NAME), ("ep", "futr_moe"),
                                      ("moe_dp", "futr_moe_drop"), ("darai", "darai"),
                                      ("self_attention", "self_attention")])
def test_step_matches_one_process(group, arm, name):
    ranks, one, _ = group
    assert_step_matches(ranks[0][arm], one[name])
    _same_params(ranks, arm)


def test_tp_splits_the_layers(group):
    """Each rank held its slices: tp 2 cut the attention and FFN weights and
    the depth projection; the fuser and the biases added after a sum stayed
    whole."""
    ranks, _, _ = group
    sliced = ranks[0]["tp_dropout"]["sliced"]
    assert any("depth_projection.weight" in k for k in sliced)
    assert any("self_attn.q_proj" in k for k in sliced)
    assert any("ffn.linear2.weight" in k for k in sliced)
    assert not any("fuser" in k or "out_proj.bias" in k or "linear2.bias" in k
                   or "depth_projection.bias" in k for k in sliced)
    full = ranks[0]["tp_dropout"]["state"]
    for k, v in sliced.items():
        assert 2 * v.numel() == full[k].numel(), k
        if k.endswith("weight"):
            assert not torch.equal(v, ranks[1]["tp_dropout"]["sliced"][k]), k


def test_moe_dp_drops_assignments(group):
    """At capacity factor 0.5 the global queues drop assignments: a per-rank
    routing would differ (its capacity and order are the rank's)."""
    _, _, extra = group
    from r3d_tpu_torch.models.moe import MoEFeedForward
    from r3d_tpu_torch.train.loop import Trainer

    cfg, n_class, batch = inputs("futr_moe_drop")
    trainer = Trainer(cfg, n_class, device="cpu")
    state = trainer.init_state(5, extra["init"]["futr_moe_drop"])
    kept = []

    def spy(mod, args, out):
        x = args[0]
        T = x.shape[0] * x.shape[1]
        cap = min(int(np.ceil(mod.top_k * T / mod.n_experts * mod.capacity_factor)), T)
        kept.append(cap * mod.n_experts < mod.top_k * T)

    hooks = [m.register_forward_hook(spy) for m in state.model.modules()
             if isinstance(m, MoEFeedForward)]
    state.model.train()
    with torch.no_grad():
        state.model(*trainer._model_inputs(trainer.to_device(batch), with_mask=True))
    for h in hooks:
        h.remove()
    assert kept and all(kept)


def test_darai_ranks_correctness_rates_differ(group):
    """The correctness gate's mean is global: the two ranks' rows alone give
    different rates of frames whose L3 and seg predictions are both right,
    so a per-rank mean would not hold the darai step above."""
    from r3d_tpu_torch.models import futr_unsupervised
    from r3d_tpu_torch.train.loop import Trainer

    _, _, extra = group
    cfg, n_class, batch = inputs("darai", extra["root"])
    trainer = Trainer(cfg, n_class, device="cpu")
    saved = futr_unsupervised.SRC_DROPOUT
    futr_unsupervised.SRC_DROPOUT = 0.0
    try:
        state = trainer.init_state(5, extra["init"]["darai"])
    finally:
        futr_unsupervised.SRC_DROPOUT = saved
    state.model.train()
    with torch.no_grad():
        out = state.model(*trainer._model_inputs(trainer.to_device(batch), with_mask=True))
    q, tr = batch["query_label"].long(), cfg.train
    both = (out["l3"].argmax(-1) == q) & (out["seg"].argmax(-1) == batch["past_label"].long())
    both &= (q != tr.l3_pad_idx) & (q != tr.l3_exclude_idx)
    rates = [float(both[rows].float().mean()) for rows in (slice(0, 2), slice(2, 4))]
    assert rates[0] != rates[1], rates


def test_tp_dropout_steps_match_one_process(group):
    """Two steps with dropout on: one process's losses, gradients and state
    (each rank drew the whole masks and kept its slice), and every
    replicated tensor equal on both ranks, bit for bit."""
    ranks, one, _ = group
    want = one["tp_dropout"]
    for r in ranks:
        got = r["tp_dropout"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6, atol=0)
        for k, w in want["grads"].items():
            err = float((got["grads"][k] - w).abs().max())
            assert err <= 1e-6 * max(1.0, float(w.abs().max())), (k, err)
        for k, w in want["state"].items():
            assert float((got["state"][k].float() - w.float()).abs().max()) <= 2 * 2e-3, k
    rep = [r["tp_dropout"]["replicated"] for r in ranks]
    assert rep[0] and sorted(rep[0]) == sorted(rep[1])
    for k, v in rep[0].items():
        assert torch.equal(v, rep[1][k]), k


def test_checkpoint_round_trips_between_tp_and_one_process(group):
    ranks, _, extra = group
    saved = extra["saved"]
    for r in ranks:
        restored = r["checkpoint"]["restored"]
        assert restored["step"] == saved["step"]
        for part in ("model", "optimizer"):
            assert sorted(restored[part]) == sorted(saved[part])
            for k, v in saved[part].items():
                assert restored[part][k].dtype == v.dtype and torch.equal(restored[part][k], v), k
    # tp 2's checkpoint into one process
    _, state, _ = one_step_state(None, extra["init"][TP_NAME])
    state = Checkpointer(extra["ckpt_out"]).restore_last(1, state)
    back = whole_train_state(state)
    after = ranks[0]["checkpoint"]["after"]
    for part in ("model", "optimizer"):
        for k, v in after[part].items():
            assert torch.equal(back[part][k], v), k
    assert back["step"] == after["step"]
