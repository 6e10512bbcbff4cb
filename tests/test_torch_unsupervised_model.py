"""The self-attention and gaze query FUTR (``futr_unsupervised`` with its
``temp2`` and ``temp3`` variants, ``futr_gaze``) of the port against the
JAX package's, on the CPU.

Each flax model is initialised from a seed, carried across with
``convert.state_dict_from_flax`` (strict ``load_state_dict``) and run on the
same numpy inputs in eval mode, fp32: outputs within 2e-5 absolute,
gradients within 1e-5 of the model's largest gradient entry (summation
order only), as ``tests/test_torch_proposed.py`` holds ``futr_proposed``.
The source's hard-coded dropout has no counterpart stream in JAX, so it is
held by its own invariants: the keep rate, the same mask in the forward and
the backward, and that ``cfg.dropout = 0`` leaves it on.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models import build_model, init_weights, model_needs_query
from r3d_tpu_torch.models.futr_unsupervised import SRC_DROPOUT, FUTRUnsupervised, GazeCNN
from test_torch_models import _grads_close, _np, _port, _t

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 6
QUERY_NUM = 10
MODELS = ("futr_unsupervised", "futr_unsupervised_temp2", "futr_unsupervised_temp3",
          "futr_gaze")


def _cfgs(model, **kw):
    kw = dict(dict(model=model, hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                   n_decoder_layers=2, max_pos_len=64, query_num=QUERY_NUM, dropout=0.0,
                   seg_excludes_none=model == "futr_gaze"), **kw)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


def _inputs(model, rng, B=3, S=40, N=50, lengths=(40, 23, 31), gaze_lengths=(50, 17, 1)):
    """features, query, pad mask and query_len: gaze rows in [0, 1] with
    exact ones (truncation keeps them), ragged and zero-padded."""
    x = rng.randn(B, S, 12).astype(np.float32)
    mask = np.arange(S)[None, :] >= np.array(lengths)[:, None]
    if model != "futr_gaze":
        return x, rng.randint(0, QUERY_NUM, (B, S)).astype(np.int32), mask, None
    g = rng.rand(B, N, 2).astype(np.float32)
    g[rng.rand(B, N, 2) < 0.4] = 1.0
    qlen = np.array(gaze_lengths, np.int32)
    g[np.arange(N)[None, :] >= qlen[:, None]] = 0.0
    return x, g, mask, qlen


def _jax_and_port(model, seed=0, **kw):
    jcfg, pcfg = _cfgs(model, **kw)
    rng = np.random.RandomState(seed)
    x, q, mask, qlen = _inputs(model, rng)
    m = jax_build_model(jcfg, N_CLASS)
    variables = jax.device_get(m.init(jax.random.PRNGKey(seed), x, q, mask, qlen, train=False))
    return m, variables, _port(build_model(pcfg, N_CLASS), variables), (x, q, mask, qlen)


@pytest.mark.parametrize("model", MODELS)
def test_forward_and_gradients_match_jax(model):
    m, variables, port, (x, q, mask, qlen) = _jax_and_port(model)
    targs = (_t(x), _t(q), _t(mask), None if qlen is None else _t(qlen))
    want = m.apply(variables, x, q, mask, qlen, train=False)
    got = port(*targs)
    assert sorted(got) == sorted(want)
    assert ("l3" in got) == (model != "futr_gaze")
    assert ("supcon" in got) == (model in ("futr_unsupervised", "futr_gaze"))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=2e-5, rtol=0,
                                   err_msg=k)

    def loss(out):
        return sum((out[k].astype(jnp.float32) ** 2).mean() for k in sorted(out))

    grads = jax.jit(jax.grad(lambda p: loss(m.apply(dict(variables, params=p), x, q, mask,
                                                    qlen, train=False))))(variables["params"])
    out = port(*targs)
    sum((out[k].float() ** 2).mean() for k in sorted(out)).backward()
    _grads_close(port, grads, rel=1e-5, model_wide=True)


def test_attention_runs_across_the_batch():
    """COMPAT #17: a row's outputs depend on the other rows of its batch
    (self-attention source), not for the gaze source."""
    for model in ("futr_unsupervised", "futr_gaze"):
        _, _, port, (x, q, mask, qlen) = _jax_and_port(model, seed=1)
        targs = (_t(x), _t(q), None, None if qlen is None else _t(qlen))
        full = port(*targs)["action"][0]
        alone = port(*(None if a is None else a[:1] for a in targs))["action"][0]
        differs = float((full - alone).abs().max().detach()) > 1e-4
        assert differs == (model == "futr_unsupervised"), model


def test_padded_gaze_batch_equals_the_unpadded_forward():
    """The gaze rows zero-padded to a common length with ``query_len``
    give each video's own forward at its true length, as in JAX."""
    m, variables, port, (x, g, _, qlen) = _jax_and_port("futr_gaze", seed=2)
    full = port(_t(x), _t(g), None, _t(qlen))
    for i, n in enumerate(qlen):
        alone = port(_t(x[i:i + 1]), _t(g[i:i + 1, :n]), None)
        want = m.apply(variables, x[i:i + 1], g[i:i + 1, :n], None, None, train=False)
        for k in ("action", "duration", "seg", "supcon"):
            np.testing.assert_allclose(full[k][i].detach().numpy(),
                                       alone[k][0].detach().numpy(), atol=2e-5, rtol=0)
            np.testing.assert_allclose(alone[k][0].detach().numpy(), _np(want[k])[0],
                                       atol=2e-5, rtol=0)


def test_conv_rule_of_the_converter():
    """flax ``nn.Conv``'s HWIO kernel becomes Conv2d's OIHW weight; on a
    width-1 map with padding 1 both frameworks see only the middle column."""
    rng = np.random.RandomState(3)
    g = rng.rand(2, 9, 2).astype(np.float32)
    from r3d_tpu.models.futr_unsupervised import GazeCNN as JaxGazeCNN

    jm = JaxGazeCNN(16)
    variables = jm.init(jax.random.PRNGKey(0), g)
    port = GazeCNN(16)
    port.load_state_dict(state_dict_from_flax(jax.device_get(variables)))
    assert port.conv1.weight.shape == (32, 2, 3, 3)
    np.testing.assert_allclose(port(_t(g)).detach().numpy(), _np(jm.apply(variables, g)),
                               atol=1e-6, rtol=0)


def test_source_dropout_invariants():
    """The self-attention source's ``Dropout(0.1)``: on in train mode even
    at ``cfg.dropout = 0``, off in eval mode; about 90 % of entries kept and
    scaled by 1/0.9; the backward passes the gradient through the same mask."""
    _, pcfg = _cfgs("futr_unsupervised")
    model = init_weights(build_model(pcfg, N_CLASS), torch.Generator().manual_seed(0))
    drop = model.src_drop
    assert drop.rate == SRC_DROPOUT and pcfg.dropout == 0.0
    x = torch.randn(4, 256, 32, requires_grad=True)
    model.train()
    drop.generator = torch.Generator().manual_seed(5)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - SRC_DROPOUT)) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / (1 - SRC_DROPOUT), rtol=0, atol=0)
    y.backward(torch.ones_like(y))
    torch.testing.assert_close(x.grad, kept.float() / (1 - SRC_DROPOUT), rtol=0, atol=0)
    model.eval()
    assert torch.equal(drop(x), x)
    feats = torch.randn(2, 30, 12)
    with torch.no_grad():
        model.train()
        a = model(feats)["action"]
        model.eval()
        b = model(feats)["action"]
    assert not torch.allclose(a, b)


@torch.no_grad()
def test_registry_and_init():
    """Every model of the family builds, the depth source with the 1-wide
    projection of the trainer's L3-id route; the convs draw flax's truncated lecun normal with zero
    bias, temp2's raw ``query_embed`` flax's xavier uniform."""
    for name in MODELS:
        _, pcfg = _cfgs(name)
        assert model_needs_query(name) and isinstance(build_model(pcfg, N_CLASS),
                                                      FUTRUnsupervised)
    _, pcfg = _cfgs("futr_unsupervised_depth")
    assert build_model(pcfg, N_CLASS).depth_embed.depth_projection.in_features == 1
    _, pcfg = _cfgs("futr_gaze")
    m = init_weights(build_model(pcfg, N_CLASS), torch.Generator().manual_seed(0))
    for conv, fan_in in ((m.gaze_cnn.conv1, 18), (m.gaze_cnn.conv2, 288)):
        w = conv.weight
        std = np.sqrt(1 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) / std - 0.88) < 0.1
        assert conv.bias.eq(0).all()
    assert not hasattr(m, "fc_l3")
    _, pcfg = _cfgs("futr_unsupervised_temp2")
    m = init_weights(build_model(pcfg, N_CLASS), torch.Generator().manual_seed(0))
    bound = np.sqrt(6 / (8 + 32))
    assert 0.5 * bound < float(m.query_embed.abs().max()) <= bound
    jcfg, _ = _cfgs("futr_unsupervised_temp2")
    params = jax_build_model(jcfg, N_CLASS).init(
        jax.random.PRNGKey(0), np.zeros((1, 16, 12), np.float32), None, None,
        train=False)["params"]
    assert sorted(state_dict_from_flax({"params": params})) == sorted(m.state_dict())
