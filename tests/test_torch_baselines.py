"""The ablation baselines (``rnn``, ``cnn``, ``tcn``) of the port against
the JAX package's, on the CPU.

Each flax model is initialised from a seed, carried across with
``convert.state_dict_from_flax`` (strict ``load_state_dict``) and run on the
same numpy inputs in eval mode, fp32, with and without a pad mask: outputs
within 2e-5 absolute, gradients within 1e-5 of the model's largest gradient
entry (summation order only). flax's forward LSTM leaves values in the pad
rows that the packed ``nn.LSTM`` zeroes; only ``supcon`` carries them, so it
is compared on real rows only, and the gradient's loss reads only those.
The converter's explicit rules (the LSTM cells, the WN conv's ``v``, a 1-D
conv's kernel) are held by a round trip each, ``init_weights`` by the
distributions it draws, and the duration-less decode against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.eval.decode import decode_frames_from_slots as jax_decode_slots
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.models.baselines import LSTMStack as JaxLSTMStack
from r3d_tpu.models.baselines import WNCausalConv as JaxWNCausalConv
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.eval.decode import decode_frames_from_slots
from r3d_tpu_torch.models import build_model, init_weights
from r3d_tpu_torch.models.baselines import LSTMStack, WNCausalConv
from test_torch_models import _grads_close, _np, _port, _t

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 7
B, S = 3, 40
LENGTHS = (40, 23, 9)


def _cfgs(model, **kw):
    kw = dict(dict(model=model, hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                   max_pos_len=64, dropout=0.0), **kw)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


def _inputs(seed, masked):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, 12).astype(np.float32)
    mask = np.arange(S)[None, :] >= np.array(LENGTHS)[:, None]
    return x, (mask if masked else None)


def _loss(out, real):
    """Every output's mean square, ``supcon`` over the real rows only."""
    total = 0.0
    for k in sorted(out):
        v = out[k].astype(jnp.float32) if hasattr(out[k], "astype") else out[k].float()
        if k == "supcon" and real is not None:
            v = v * real[..., None]
        total = total + (v ** 2).mean()
    return total


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("model", ["rnn", "cnn", "tcn"])
def test_forward_and_gradients_match_jax(model, masked):
    jcfg, pcfg = _cfgs(model)
    x, mask = _inputs(3, masked)
    m = jax_build_model(jcfg, N_CLASS)
    variables = jax.device_get(m.init(jax.random.PRNGKey(1), x, mask, train=False))
    port = _port(build_model(pcfg, N_CLASS), variables)
    want = m.apply(variables, x, mask, train=False)
    targs = (_t(x), None if mask is None else _t(mask))
    got = port(*targs)
    assert sorted(got) == sorted(want)
    assert sorted(got) == (["action"] if model == "tcn"
                           else ["action", "duration", "seg", "supcon"])
    real = None if mask is None else ~mask
    for k in want:
        w, g = _np(want[k]), got[k].detach().float().numpy()
        if k == "supcon" and real is not None:
            w, g = w[real], g[real]
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=k)

    jreal = None if real is None else jnp.asarray(real, jnp.float32)
    grads = jax.jit(jax.grad(lambda p: _loss(m.apply(dict(variables, params=p), x, mask,
                                                     train=False), jreal)))(variables["params"])
    _loss(port(*targs), None if real is None else _t(real).float()).backward()
    _grads_close(port, grads, rel=1e-5, model_wide=True)


def test_lstm_cell_rule_round_trip():
    """The four flax cells become ``nn.LSTM``'s stacked gates in the order
    the stack creates them; at hidden width = input width all four cells
    have one shape, so the order is read off the init (layer, direction),
    and the stack's output pins it: each cell's leaves perturbed alone move
    the output of its own layer and direction only."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 11, 16).astype(np.float32)
    lengths = np.array([11, 6], np.int32)
    m = JaxLSTMStack(16)
    v = jax.device_get(m.init(jax.random.PRNGKey(0), x, lengths))
    assert sorted(v["params"]) == [f"OptimizedLSTMCell_{i}" for i in range(4)]
    sd = state_dict_from_flax(v)
    assert sorted(sd) == sorted(LSTMStack(16, 16).state_dict())
    assert all(sd[k].abs().max() == 0 for k in sd if k.startswith("bias_ih"))
    port = LSTMStack(16, 16)
    port.load_state_dict(sd)
    mask = np.arange(11)[None, :] < lengths[:, None]
    want = _np(m.apply(v, x, lengths))
    got = port(_t(x), _t(lengths)).detach().numpy()
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-5, rtol=0)
    # cell i is layer i // 2, direction i % 2: nudging layer 1's backward
    # cell leaves the forward half of the output as it was
    v3 = jax.tree.map(np.array, v)
    v3["params"]["OptimizedLSTMCell_3"]["hi"]["bias"] += 1.0
    port.load_state_dict(state_dict_from_flax(v3))
    moved = port(_t(x), _t(lengths)).detach().numpy()
    np.testing.assert_allclose(moved[mask][:, :8], got[mask][:, :8], atol=0, rtol=0)
    assert np.abs(moved[mask][:, 8:] - got[mask][:, 8:]).max() > 1e-3
    np.testing.assert_allclose(moved[mask], _np(m.apply(v3, x, lengths))[mask], atol=1e-5,
                               rtol=0)


def test_wn_conv_rule_round_trip():
    """JAX's ``v`` [k, in, out] becomes [out, in, k]; the normalised kernel,
    the left pad and the dilation give JAX's conv."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 13, 5).astype(np.float32)
    m = JaxWNCausalConv(7, 3, 4)
    v = jax.device_get(m.init(jax.random.PRNGKey(3), x))
    v = jax.tree.map(np.array, v)
    v["params"]["g"] = v["params"]["g"] * rng.rand(7).astype(np.float32)   # g != ||v||
    sd = state_dict_from_flax(v)
    assert sd["v"].shape == (7, 5, 3)
    np.testing.assert_array_equal(sd["v"].numpy(), v["params"]["v"].transpose(2, 1, 0))
    port = WNCausalConv(5, 7, 3, 4)
    port.load_state_dict(sd)
    got = port(_t(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    np.testing.assert_allclose(got, _np(m.apply(v, x)), atol=1e-5, rtol=0)


@torch.no_grad()
def test_init_weights_draws_the_flax_distributions():
    _, pcfg = _cfgs("tcn")
    m = init_weights(build_model(pcfg, N_CLASS), torch.Generator().manual_seed(0))
    c = m.block1_conv1
    assert abs(float(c.v.std()) - 0.01) < 1e-3
    torch.testing.assert_close(c.g, c.v.flatten(1).norm(dim=1))
    assert c.bias.eq(0).all() and m.block0_down.bias.eq(0).all()
    assert abs(float(m.block0_down.weight.std()) - 0.01) < 1e-3
    std = np.sqrt(1 / 256) / 0.87962566103423978
    w = m.regression.weight
    assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) / std - 0.88) < 0.05
    _, pcfg = _cfgs("rnn")
    m = init_weights(build_model(pcfg, N_CLASS), torch.Generator().manual_seed(0))
    hh = m.rnn.weight_hh_l1_reverse.view(4, 16, 16)
    for gate in hh:
        torch.testing.assert_close(gate @ gate.T, torch.eye(16), atol=1e-5, rtol=0)
    std = np.sqrt(1 / 32) / 0.87962566103423978
    assert float(m.rnn.weight_ih_l0.abs().max()) <= 2 * std
    assert all(p.eq(0).all() for n, p in m.rnn.named_parameters() if "bias" in n)
    assert not any(p.requires_grad for n, p in m.rnn.named_parameters() if "bias_ih" in n)


def test_decode_frames_from_slots_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(10):
        logits = rng.randn(8, N_CLASS).astype(np.float32)
        for horizon in (0, 1, 5, 8, 37):
            np.testing.assert_array_equal(decode_frames_from_slots(logits, horizon),
                                          jax_decode_slots(logits, horizon))


def test_registry_builds_every_jax_model():
    """Every model of the JAX registry builds; another name raises JAX's
    ``ValueError``."""
    import r3d_tpu.models as jm

    names = (["futr", "futr_baseline", "rnn", "cnn", "tcn"] + sorted(jm._FUSION_MODELS)
             + list(jm.QUERY_MODELS))
    for name in names:
        _, pcfg = _cfgs(name)
        build_model(pcfg, N_CLASS, (6, 5))
    _, pcfg = _cfgs("lstm")
    with pytest.raises(ValueError, match="unknown model"):
        build_model(pcfg, N_CLASS)
    with pytest.raises(ValueError, match="unknown model"):
        jax_build_model(_cfgs("lstm")[0], N_CLASS)
