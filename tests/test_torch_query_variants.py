"""The gt-label embed, the depth query source and L3 query generation of the
port against the JAX package's, on the CPU.

Each flax module or model is initialised from a seed, carried across with
``convert.state_dict_from_flax`` (strict ``load_state_dict``) and run on the
same numpy inputs, fp32: outputs within 2e-5 absolute, gradients within
1e-5 of the model's largest gradient entry (summation order only); bf16
outputs within 2e-2 (one bf16 rounding of O(1) values).

- ``input_type="gt"``: ``InputEmbed`` over [B, S] label ids in
  ``[0, n_class + 2)``, then ``futr`` at the breakfast config's shape (cut
  to hidden 32) forward, and one train step of the ``futr`` loop against
  JAX's ``_grad_core`` (no JAX loader builds a label-id stream, so the
  batch is written here).
- ``query_source="depth"``: the module on raw depth [B, S, H, W], as JAX's
  tests feed it, and the trainer's route, the [B, S] L3 ids of
  ``query_label`` (``r3d_tpu/train/loop.py:136-149``), where JAX's init
  makes the projection (1, hidden): the model ``build_model`` gives, and
  one ``unsupervised`` train step from JAX's init, with the two hard-coded
  dropouts at rate 0 on both sides (the frameworks draw different streams;
  ``tests/test_torch_sticky_dropout.py`` holds them at their real rates).
- ``FUTRTransformer(query_pos=None)``: the L3 attention, the encoding and
  the pool to ``n_query`` rows, under a pad mask.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.models import futr as jax_futr
from r3d_tpu.models import transformer as jax_transformer
from r3d_tpu.models.futr_unsupervised import FUTRUnsupervised as JaxFUTRUnsupervised
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models import build_model, futr, futr_unsupervised, transformer
from r3d_tpu_torch.models.futr_unsupervised import FUTRUnsupervised
from r3d_tpu_torch.train.loop import Trainer
from test_torch_darai_fit import _NoDropout
from test_torch_models import _grads_close, _np, _port, _t

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 9
QUERY_NUM = 10


def _sq_loss(out):
    return sum((out[k].astype(jnp.float32) ** 2).mean() for k in sorted(out))


def _sq_loss_t(out):
    return sum((out[k].float() ** 2).mean() for k in sorted(out))


def _apply_and_grads(m, variables, port, args):
    """Outputs of both, then the gradients of the outputs' mean squares."""
    want = m.apply(variables, *args, train=False)
    targs = tuple(None if a is None else _t(a) for a in args)
    got = port(*targs)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(), _np(want[k]), atol=2e-5,
                                   rtol=0, err_msg=k)
    grads = jax.jit(jax.grad(lambda p: _sq_loss(m.apply(dict(variables, params=p), *args,
                                                        train=False))))(variables["params"])
    _sq_loss_t(port(*targs)).backward()
    _grads_close(port, grads, rel=1e-5, model_wide=True)


# ---- input_type="gt" ----

def _gt_cfgs(dtype="float32"):
    out = []
    for m in (jax_config, pt_config):
        base = m.get_config("breakfast")
        out.append(base.replace(
            model=dataclasses.replace(base.model, hidden_dim=32, n_head=4, max_pos_len=64,
                                      dropout=0.0, input_type="gt", compute_dtype=dtype),
            train=dataclasses.replace(base.train, batch_size=3, warmup_epochs=0)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gt_input_embed_matches_jax(dtype):
    """``nn.Embedding(n_class + 2, C)`` of the ids, ReLU, in the compute
    dtype; every id of the table, pad ids included."""
    jcfg, pcfg = _gt_cfgs(dtype)
    ids = np.arange(N_CLASS + 2, dtype=np.int32)[None].repeat(2, 0)
    m = jax_futr.InputEmbed(jcfg.model, N_CLASS)
    v = jax.device_get(m.init(jax.random.PRNGKey(0), ids))
    port = _port(futr.InputEmbed(pcfg.model, N_CLASS), v)
    got = port(_t(ids))
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_array_equal(got.float().detach().numpy(), _np(m.apply(v, ids)))


def _gt_batch(rng, B=3, S=48, Q=8):
    feats = rng.randint(0, N_CLASS + 2, (B, S)).astype(np.int32)
    past = rng.randint(0, N_CLASS - 1, (B, S)).astype(np.int32)   # no NONE in the past
    past[1, 30:] = N_CLASS + 1
    past[2, 12:] = N_CLASS + 1
    feats[past == N_CLASS + 1] = N_CLASS + 1
    target = rng.randint(0, N_CLASS, (B, Q)).astype(np.int32)
    target[0, 5:] = N_CLASS + 1
    dur = rng.rand(B, Q).astype(np.float32)
    return {"features": feats, "past_label": past, "trans_future_target": target,
            "trans_future_dur": dur}


def test_gt_futr_forward_and_train_step_match_jax():
    """``futr`` with the gt embed: the eval forward under the pad mask
    (2e-5), then one ``futr``-loop train step from JAX's init (loss 1e-5,
    gradients 1e-5 of each tensor's largest entry, the counts equal)."""
    jcfg, pcfg = _gt_cfgs()
    batch = _gt_batch(np.random.RandomState(1))
    mask = batch["past_label"] == N_CLASS + 1
    jtrainer = JaxTrainer(jcfg, N_CLASS)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), batch, steps_per_epoch=1)
    variables = jax.device_get({"params": jstate.params})
    assert variables["params"]["embed"]["gt_emb"]["embedding"].shape == (N_CLASS + 2, 32)
    want = jax_build_model(jcfg.model, N_CLASS).apply(variables, batch["features"], mask)
    got = _port(build_model(pcfg.model, N_CLASS), variables)(_t(batch["features"]), _t(mask))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=2e-5, rtol=0,
                                   err_msg=k)

    grads_j, metrics_j, _ = jax.jit(lambda p, b: jtrainer._grad_core(
        p, {}, b, jax.random.PRNGKey(0), 0))(jstate.params, batch)
    trainer = Trainer(pcfg, N_CLASS, device="cpu")
    state = trainer.init_state(1, state_dict_from_flax(variables))
    state.model.train()
    metrics_p = trainer._grad_core(state.model, trainer.to_device(
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(float(metrics_p["loss"]) - float(metrics_j["loss"])) <= 1e-5
    for k in ("cls_correct", "cls_total", "seg_correct", "seg_total"):
        assert int(metrics_p[k]) == int(metrics_j[k]), k
    _grads_close(state.model, grads_j, rel=1e-5)


# ---- query_source="depth" ----

def _depth_cfgs(**kw):
    kw = dict(dict(model="futr_unsupervised_depth", hidden_dim=32, n_head=4, n_query=8,
                   input_dim=12, n_decoder_layers=2, max_pos_len=64, query_num=QUERY_NUM,
                   dropout=0.0), **kw)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


def test_depth_source_on_raw_depth_matches_jax():
    """The module as JAX's tests feed it (``tests/test_model_variants.py``):
    raw depth [B, S, H, W], the projection H * W wide, eval mode."""
    jcfg, pcfg = _depth_cfgs()
    rng = np.random.RandomState(2)
    x = rng.randn(2, 40, 12).astype(np.float32)
    depth = rng.rand(2, 40, 6, 5).astype(np.float32)
    mask = np.arange(40)[None, :] >= np.array([40, 26])[:, None]
    m = JaxFUTRUnsupervised(jcfg, N_CLASS, query_source="depth")
    v = jax.device_get(m.init(jax.random.PRNGKey(1), x, depth, mask, None, train=False))
    assert v["params"]["depth_embed"]["depth_projection"]["kernel"].shape == (30, 32)
    port = _port(FUTRUnsupervised(pcfg, N_CLASS, "depth", depth_dim=30), v)
    _apply_and_grads(m, v, port, (x, depth, mask, None))


def test_depth_source_trainer_route_matches_jax(monkeypatch):
    """The trainer's route: JAX's ``init_state`` through ``_model_inputs``
    puts the [B, S] L3 ids in the query slot, so the projection is
    (1, hidden), as ``build_model`` makes it; one ``unsupervised`` train
    step from that init (epoch 0; at rate 0 the sticky step computes the
    same), the hard-coded dropouts at rate 0 on both sides."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(futr_unsupervised, "SRC_DROPOUT", 0.0)
    monkeypatch.setattr(futr_unsupervised, "DEPTH_QUERY_DROPOUT", 0.0)
    cfgs = []
    for mod, mcfg in zip((jax_config, pt_config), _depth_cfgs(query_num=48)):
        base = mod.get_config("darai")
        cfgs.append(base.replace(model=mcfg, train=dataclasses.replace(
            base.train, batch_size=3, warmup_epochs=0, warmup_loss_epochs=(1, 3))))
    jcfg, pcfg = cfgs
    rng = np.random.RandomState(3)
    batch = _gt_batch(rng)
    batch["features"] = rng.randn(3, 48, 12).astype(np.float32)
    q = rng.randint(0, 47, (3, 48)).astype(np.int32)
    q[batch["past_label"] == N_CLASS + 1] = 47   # the l3 pad
    batch["query_label"] = q
    jtrainer = JaxTrainer(jcfg, N_CLASS)
    jstate = jtrainer.init_state(jax.random.PRNGKey(4), batch, steps_per_epoch=1)
    variables = jax.device_get({"params": jstate.params})
    assert variables["params"]["depth_embed"]["depth_projection"]["kernel"].shape == (1, 32)
    assert build_model(pcfg.model, N_CLASS, (224, 224)).depth_embed.depth_projection.in_features == 1
    trainer = Trainer(pcfg, N_CLASS, device="cpu")
    pbatch = trainer._with_seg_ids({k: torch.from_numpy(v) for k, v in batch.items()})
    jbatch = dict(batch, seg_ids=pbatch["seg_ids"].numpy())
    grads_j, metrics_j, _ = jax.jit(lambda p, b: jtrainer._grad_core(
        p, {}, b, jax.random.PRNGKey(0), 0))(jstate.params, jbatch)
    state = trainer.init_state(1, state_dict_from_flax(variables))
    trainer._train_mode(state.model, 0)
    metrics_p = trainer._grad_core(state.model, trainer.to_device(pbatch), 0)
    for k in ("loss", "loss_l3", "loss_supcon", "loss_cls", "loss_seg"):
        assert abs(float(metrics_p[k]) - float(metrics_j[k])) <= 1e-5, k
    _grads_close(state.model, grads_j, rel=1e-5, model_wide=True)


# ---- L3 query generation ----

def test_l3_query_generation_matches_jax():
    """``query_pos=None``: ``l3_attention(memory, src, src)`` plus the
    encoding, pooled to ``n_query`` rows, are the decoder's queries."""
    rng = np.random.RandomState(5)
    src = rng.randn(2, 50, 32).astype(np.float32)
    pos = rng.randn(2, 50, 32).astype(np.float32)
    mask = np.arange(50)[None, :] >= np.array([50, 31])[:, None]
    m = jax_transformer.FUTRTransformer(32, 4, 2, 1, 128, dropout=0.0, n_query=6,
                                        max_pos_len=64)
    v = jax.device_get(m.init(jax.random.PRNGKey(2), src, pos, None, mask))
    assert "l3_attention" in v["params"]
    port = _port(transformer.FUTRTransformer(32, 4, 1, 128, l3_queries=True, n_query=6,
                                             max_pos_len=64), v)
    mem_w, hs_w = m.apply(v, src, pos, None, mask)
    mem_g, hs_g = port(_t(src), _t(pos), None, _t(mask))
    assert hs_g.shape == (2, 6, 32)
    np.testing.assert_allclose(hs_g.detach().numpy(), _np(hs_w), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(mem_g.detach().numpy(), _np(mem_w))

    grads = jax.jit(jax.grad(lambda p: (m.apply(dict(v, params=p), src, pos, None, mask)[1]
                                        ** 2).mean()))(v["params"])
    (port(_t(src), _t(pos), None, _t(mask))[1] ** 2).mean().backward()
    _grads_close(port, grads, rel=1e-5, model_wide=True)
    with pytest.raises(ValueError, match="l3_queries"):
        transformer.FUTRTransformer(32, 4, 1, 128)(_t(src), None, None)
