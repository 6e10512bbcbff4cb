"""MoE feed-forwards (``moe_experts > 0``) of the port against the JAX
package's, on the CPU.

- The layer (``MoEFeedForward``) from a flax init carried across with
  ``convert.state_dict_from_flax`` (the stacked expert kernels [E, in, out]
  by their own rule): top-1 and top-2, ample capacity and capacity that
  drops assignments, pad tokens excluded, a zero router whose tied
  probabilities go to the lower expert, fp32 (outputs 1e-5, the balance
  term 1e-6, gradients 1e-5 of the largest entry) and bf16 (outputs 2e-2,
  one bf16 rounding of O(1) values).
- The model: ``futr_proposed`` with the encoder on (its FFNs route under
  the source mask, the decoder's under the query mask), forward and
  gradients in fp32.
- The balance term in the metrics and the loss of every training route
  (the 2-epoch fit with MoE against JAX's is the CLI's,
  ``tests/test_torch_variants_cli_moe.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.models.moe import MoEFeedForward as JaxMoE
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data.pipeline import BucketedLoader
from r3d_tpu_torch.models import build_model, init_weights
from r3d_tpu_torch.models.moe import MoEFeedForward, moe_aux
from r3d_tpu_torch.train.loop import Trainer
from test_torch_models import _grads_close, _np, _port, _t

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

B, L, C, H, E = 3, 16, 16, 32, 4


def _layer(top_k, cf, seed, zero_router=False, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, C).astype(np.float32)
    pad = np.arange(L)[None, :] >= np.array([16, 11, 5])[:, None]
    m = JaxMoE(C, H, n_experts=E, top_k=top_k, capacity_factor=cf, dtype=dtype)
    v = jax.device_get(m.init(jax.random.PRNGKey(seed), x, True, pad))
    v = {"params": jax.tree.map(np.array, v["params"])}   # not the init's sown terms
    if zero_router:
        v["params"]["router"]["kernel"][:] = 0.0
    return m, v, x, pad


CASES = {   # top_k, capacity_factor, masked, zero router
    "top2": (2, 1.25, True, False),
    "top2_drops": (2, 0.5, True, False),
    "top1_unmasked": (1, 1.25, False, False),
    "top1_ties_drop": (1, 1.0, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    top_k, cf, masked, zero = CASES[case]
    m, v, x, pad = _layer(top_k, cf, 1, zero)
    pad = pad if masked else None
    (want, aux_j) = m.apply(v, x, True, pad, mutable=["losses"])
    aux_j = float(jax.tree.leaves(aux_j)[0])
    sd = state_dict_from_flax(v)
    assert sd["experts.linear1.weight"].shape == (E, H, C)
    np.testing.assert_array_equal(sd["experts.linear2.weight"].numpy(),
                                  v["params"]["experts"]["linear2"]["kernel"].transpose(0, 2, 1))
    port = MoEFeedForward(C, H, E, top_k, cf)
    port.load_state_dict(sd)
    got = port(_t(x), None if pad is None else _t(pad))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-5, rtol=0)
    assert abs(float(port.aux.detach()) - aux_j) <= 1e-6
    if pad is not None:
        assert float(got[_t(pad)].abs().max()) == 0.0   # pad rows are zero
    if case == "top2_drops":   # some assignments drop: a token loses an expert
        dense = MoEFeedForward(C, H, E, top_k, 8.0)
        dense.load_state_dict(sd)
        assert float((dense(_t(x), _t(pad)) - got).abs().max()) > 1e-3

    def loss(p):
        y, aux = m.apply(dict(v, params=p), x, True, pad, mutable=["losses"])
        return (y ** 2).mean() + jax.tree.leaves(aux)[0]

    grads = jax.grad(loss)(v["params"])
    ((got ** 2).mean() + port.aux).backward()
    _grads_close(port, grads, rel=1e-5, model_wide=True)
    with torch.no_grad():   # serving and validation: no balance term, as JAX sows none there
        port(_t(x), None if pad is None else _t(pad))
    assert port.aux is None


def test_layer_bf16_matches_jax():
    m, v, x, pad = _layer(2, 1.25, 2, dtype=jnp.bfloat16)
    want, _ = m.apply(v, x, True, pad, mutable=["losses"])
    port = MoEFeedForward(C, H, E, 2, 1.25, dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_flax(v))
    got = port(_t(x), _t(pad))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), atol=2e-2, rtol=0)


def _cfgs(model, **kw):
    kw = dict(dict(model=model, hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                   max_pos_len=64, dropout=0.0, n_decoder_layers=1, n_encoder_layers=1,
                   query_num=10, moe_experts=E, moe_top_k=2), **kw)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


def test_model_matches_jax():
    """``futr_proposed`` with the encoder: the encoder's FFNs route under
    the source mask, the decoder's under the query mask; outputs 2e-5, the
    balance terms' sum 1e-6, gradients 1e-5 of the largest entry."""
    jcfg, pcfg = _cfgs("futr_proposed", use_encoder=True)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 40, 12).astype(np.float32)
    mask = np.arange(40)[None, :] >= np.array([40, 27])[:, None]
    q = rng.randint(0, 10, (2, 40)).astype(np.int32)
    args = (x, q, mask, None)
    m = jax_build_model(jcfg, 6)
    v = jax.device_get(m.init(jax.random.PRNGKey(3), *args, train=False))
    v = {"params": v["params"]}   # not the init's sown terms
    port = _port(build_model(pcfg, 6), v)
    want, losses = m.apply(v, *args, train=False, mutable=["losses"])
    got = port(*(None if a is None else _t(a) for a in args))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=2e-5, rtol=0,
                                   err_msg=k)
    aux_j = sum(float(a) for a in jax.tree.leaves(losses))
    assert len(jax.tree.leaves(losses)) == 2   # the encoder's layer and the decoder's
    assert abs(float(moe_aux(port)) - aux_j) <= 1e-6

    def loss(p):
        out, aux = m.apply(dict(v, params=p), *args, train=False, mutable=["losses"])
        return sum((out[k] ** 2).mean() for k in sorted(out)) + sum(jax.tree.leaves(aux))

    grads = jax.jit(jax.grad(loss))(v["params"])
    out = port(*(None if a is None else _t(a) for a in args))
    (sum((out[k] ** 2).mean() for k in sorted(out)) + moe_aux(port)).backward()
    _grads_close(port, grads, rel=1e-5, model_wide=True)


@torch.no_grad()
def test_init_weights_draws_the_flax_distributions():
    _, pcfg = _cfgs("futr", hidden_dim=64)
    m = init_weights(build_model(pcfg, 6), torch.Generator().manual_seed(0))
    ffn = m.transformer.decoder.layers[0].ffn
    std = np.sqrt(1 / 64) / 0.87962566103423978
    w = ffn.router.weight
    assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) / std - 0.88) < 0.1
    bound = np.sqrt(6 / (64 + 256))
    for e in ffn.experts.linear1.weight:
        assert float(e.abs().max()) <= bound and float(e.abs().max()) > 0.9 * bound
    assert not torch.equal(ffn.experts.linear1.weight[0], ffn.experts.linear1.weight[1])
    assert ffn.experts.linear2.bias.eq(0).all()


def test_every_training_route_carries_the_balance_term():
    """``make_multi_step`` and ``make_accum_step`` go through the same
    ``_grad_core`` as ``fit``, ``fit_cached`` and ``fit_hybrid``: their
    metrics hold ``moe_aux``, and the loss is the task loss plus
    ``moe_aux_weight`` times it (the ``futr`` loop, 2 decoder layers of 4
    experts, top 1, synthetic batches of the 50salads layout)."""
    from r3d_tpu_torch.data.synthetic import SyntheticSource

    pcfg = pt_config.get_config("50salads")
    pcfg = pcfg.replace(
        model=pt_config.ModelConfig(model="futr", hidden_dim=32, n_head=4, n_query=20,
                                    input_dim=12, n_decoder_layers=2, max_pos_len=64,
                                    seg_excludes_none=True, dropout=0.0, moe_experts=E,
                                    moe_top_k=1),
        train=pt_config.TrainConfig(loop="futr", batch_size=4, min_train_batch=0))
    src = SyntheticSource(n_videos=6, n_actions=19, vid_len_range=(60, 120), input_dim=12,
                          seed=1)
    fn, n = src.make_example_fn((0.2, 0.3, 0.5), 1, 20)
    loader = BucketedLoader(num_examples=n, make_example_fn=fn, batch_size=4,
                            pad_idx=src.pad_idx, buckets=(64,), n_query=20, with_depth=False,
                            shuffle=False)
    same = list(loader)[:2]
    stacked = {k: torch.stack([b[k] for b in same]) for k in same[0]}
    trainer = Trainer(pcfg, src.n_class, device="cpu")
    for make in (trainer.make_multi_step, trainer.make_accum_step):
        state = trainer.init_state(len(loader))
        metrics = make()(state, stacked, 0)
        assert float(metrics["moe_aux"]) > 0.0
    state = trainer.init_state(len(loader))
    state.model.train()
    m = trainer._grad_core(state.model, trainer.to_device(same[0]))
    task = float(m["loss_cls"] + m["loss_dur"] + m["loss_seg"])
    assert abs(float(m["loss"]) - (task + pcfg.model.moe_aux_weight * float(m["moe_aux"]))) < 1e-5
