"""Every module of the port's serving slice against its flax counterpart.

Each flax module is initialised from a seed, its variables are carried
across with ``r3d_tpu_torch.convert.state_dict_from_flax`` into the port's
module (``load_state_dict`` is strict, so the names must match one to one),
and both run on the same numpy inputs. fp32 tolerances are 1e-5 absolute
(summation order only); the bf16 embeds are held to 2e-2, one bf16 rounding
of an O(1) output, because XLA and PyTorch may round a bf16 product's fp32
sum differently.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.eval.decode import decode_anticipation as jax_decode
from r3d_tpu.data.pipeline import bucket_length as jax_bucket_length
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.models import fuser as jax_fuser
from r3d_tpu.models import futr as jax_futr
from r3d_tpu.models import futr_fusion as jax_futr_fusion
from r3d_tpu.models import layers as jax_layers
from r3d_tpu.models import transformer as jax_transformer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data.pipeline import bucket_length
from r3d_tpu_torch.eval.decode import decode_anticipation
from r3d_tpu_torch.models import build_model, init_weights
from r3d_tpu_torch.models import fuser, futr, futr_fusion, layers, transformer

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(jax.device_get(variables)))
    return module.eval()


def _randomize_bn(variables, rng, C, at=()):
    """Non-trivial BN gammas and running statistics of the CMFuserBN at
    path ``at``, so the folded affine and the bottom-k choice both matter."""
    v = jax.device_get(variables)
    params, stats = v["params"], v["batch_stats"]
    for key in at:
        params, stats = params[key], stats[key]
    for name in ("bn_rgb", "bn_depth"):
        params[name]["scale"] = rng.randn(C).astype(np.float32)
        params[name]["bias"] = rng.randn(C).astype(np.float32) * 0.3
        stats[name] = {"mean": rng.randn(C).astype(np.float32) * 0.3,
                       "var": rng.rand(C).astype(np.float32) + 0.5}
    return v


def _model_cfgs(embed_dtype=None):
    kw = dict(model="futr_fusion_bn", hidden_dim=32, n_head=4, n_query=8,
              input_dim=12, max_pos_len=512, embed_dtype=embed_dtype)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


def test_config_fields_and_defaults_match_jax():
    for name in ("DataConfig", "ModelConfig", "TrainConfig", "EvalConfig",
                 "MeshConfig", "Config"):
        want = getattr(jax_config, name)()
        got = getattr(pt_config, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


@pytest.mark.parametrize("name", ["utkinects", "synthetic"])
def test_named_configs_match_jax(name):
    assert (dataclasses.asdict(pt_config.get_config(name))
            == dataclasses.asdict(jax_config.get_config(name)))


def test_bucket_length_and_decode_match_jax():
    buckets = (128, 256, 512, 1024, 2000)
    for n in (1, 128, 129, 700, 2000, 2500):
        assert bucket_length(n, buckets) == jax_bucket_length(n, buckets)
    rng = np.random.RandomState(0)
    for trial in range(20):
        logits = rng.randn(8, 17).astype(np.float32)
        if trial % 3 == 0:
            logits[rng.randint(8), 16] = 9.0  # a NONE query masks the tail
        durs = rng.randn(8).astype(np.float32)
        for horizon in (0, 1, 37):
            for a, b in zip(decode_anticipation(logits, durs, horizon, 16),
                            jax_decode(logits, durs, horizon, 16)):
                np.testing.assert_array_equal(a, b)


def test_attention_bias_from_padding_matches_jax():
    pad = np.random.RandomState(1).rand(3, 20) < 0.4
    want = jax_layers.attention_bias_from_padding(jnp.asarray(pad), jnp.float32)
    got = layers.attention_bias_from_padding(_t(pad))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert layers.attention_bias_from_padding(None) is None


@pytest.mark.parametrize("Lq,Lk", [(8, 8), (8, 40)])
def test_multihead_attention_matches_flax(Lq, Lk):
    rng = np.random.RandomState(Lk)
    q = rng.randn(2, Lq, 32).astype(np.float32)
    kv = rng.randn(2, Lk, 32).astype(np.float32)
    pad = np.zeros((2, Lk), bool)
    pad[1, Lk // 2:] = True
    m = jax_layers.MultiheadAttention(32, 4)
    variables = m.init(jax.random.PRNGKey(0), q, kv, kv, pad)
    want = m.apply(variables, q, kv, kv, pad)
    got = _port(layers.MultiheadAttention(32, 4), variables)(_t(q), _t(kv), _t(kv), _t(pad))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=ATOL, rtol=0)


def test_feed_forward_matches_flax():
    x = np.random.RandomState(2).randn(2, 8, 32).astype(np.float32)
    m = jax_layers.FeedForward(32, 128)
    variables = m.init(jax.random.PRNGKey(1), x)
    got = _port(layers.FeedForward(32, 128), variables)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(m.apply(variables, x)),
                               atol=ATOL, rtol=0)


def _decoder_inputs(rng, B=2, Q=8, S=40, C=32):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[0, 30:] = True
    return f(B, Q, C), f(B, S, C), f(B, S, C), f(B, Q, C), pad


def test_decoder_layer_matches_flax():
    tgt, mem, pos, qpos, pad = _decoder_inputs(np.random.RandomState(3))
    m = jax_layers.DecoderLayer(32, 4, 128, dropout=0.0)
    variables = m.init(jax.random.PRNGKey(2), tgt, mem, pos, qpos, pad)
    want = m.apply(variables, tgt, mem, pos, qpos, pad)
    got = _port(layers.DecoderLayer(32, 4, 128), variables)(
        _t(tgt), _t(mem), _t(pos), _t(qpos), _t(pad))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_futr_transformer_matches_flax(n_layers):
    _, src, pos, qpos, pad = _decoder_inputs(np.random.RandomState(4))
    m = jax_transformer.FUTRTransformer(32, 4, 2, n_layers, 128, dropout=0.0,
                                        use_encoder=False)
    variables = m.init(jax.random.PRNGKey(3), src, pos, qpos, pad)
    mem_w, hs_w = m.apply(variables, src, pos, qpos, pad)
    mem_g, hs_g = _port(transformer.FUTRTransformer(32, 4, n_layers, 128), variables)(
        _t(src), _t(pos), _t(qpos), _t(pad))
    np.testing.assert_array_equal(mem_g.numpy(), _np(mem_w))
    np.testing.assert_allclose(hs_g.detach().numpy(), _np(hs_w), atol=ATOL, rtol=0)


def test_torch_batchnorm_eval_matches_flax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 10, 32).astype(np.float32)
    m = jax_fuser.TorchBatchNorm(32)
    variables = jax.device_get(m.init(jax.random.PRNGKey(0), x, train=False))
    variables["params"]["scale"] = rng.randn(32).astype(np.float32)
    variables["batch_stats"] = {"mean": rng.randn(32).astype(np.float32),
                                "var": rng.rand(32).astype(np.float32) + 0.5}
    want, _ = m.apply(variables, x, train=False)
    got = _port(fuser.TorchBatchNorm(32), variables)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("jax_path", ["composed", "pallas-interpret"])
@pytest.mark.parametrize("C", [32, 128], ids=["narrow", "utkinects-width"])
def test_cmfuser_bn_matches_flax(jax_path, C, monkeypatch):
    rng = np.random.RandomState(C)
    rgb = rng.randn(3, 20, C).astype(np.float32)
    depth = rng.randn(3, 20, C).astype(np.float32)
    m = jax_fuser.CMFuserBN(C, n_head=8, drop_rate=0.0,
                            use_pallas=jax_path == "pallas-interpret")
    variables = _randomize_bn(m.init(jax.random.PRNGKey(4), rgb, depth), rng, C)
    if jax_path == "pallas-interpret":
        monkeypatch.setenv("R3D_FORCE_PALLAS", "1")
    want = m.apply(variables, rgb, depth, train=False)
    got = _port(fuser.CMFuserBN(C), variables)(_t(rgb), _t(depth))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("embed_dtype,atol", [(None, ATOL), ("bfloat16", 2e-2)])
def test_input_and_depth_embed_match_flax(embed_dtype, atol):
    jcfg, pcfg = _model_cfgs(embed_dtype)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 30, 12).astype(np.float32)
    d = rng.rand(2, 30, 6, 5).astype(np.float32)
    m = jax_futr.InputEmbed(jcfg, 17)
    variables = m.init(jax.random.PRNGKey(5), x)
    got = _port(futr.InputEmbed(pcfg), variables)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(m.apply(variables, x)),
                               atol=atol, rtol=0)
    m = jax_futr_fusion.DepthEmbed(jcfg)
    variables = m.init(jax.random.PRNGKey(6), d)
    got = _port(futr_fusion.DepthEmbed(pcfg, 30), variables)(_t(d))
    np.testing.assert_allclose(got.detach().numpy(), _np(m.apply(variables, d)),
                               atol=atol, rtol=0)


def test_heads_match_flax():
    jcfg, pcfg = _model_cfgs()
    rng = np.random.RandomState(7)
    hs = rng.randn(2, 8, 32).astype(np.float32)
    mem = rng.randn(2, 40, 32).astype(np.float32)
    m = jax_futr.Heads(jcfg, 17)
    variables = m.init(jax.random.PRNGKey(7), hs, mem)
    want = m.apply(variables, hs, mem)
    got = _port(futr.Heads(pcfg, 17), variables)(_t(hs), _t(mem))
    assert sorted(got) == sorted(want) == ["action", "duration", "seg"]
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("S", [64, 256])
def test_futr_fusion_matches_flax(S):
    jcfg, pcfg = _model_cfgs()
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, 12).astype(np.float32)
    d = rng.rand(2, S, 6, 5).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, S // 3:] = True
    m = jax_build_model(jcfg, 17)
    variables = _randomize_bn(
        m.init(jax.random.PRNGKey(8), x, d, pad, train=False), rng, 32, at=("fuser",))
    want = m.apply(variables, x, d, pad, train=False)
    got = _port(build_model(pcfg, 17, (6, 5)), variables)(_t(x), _t(d), _t(pad))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]),
                                   atol=2e-5, rtol=0, err_msg=k)


def test_build_model_refuses_what_is_not_ported():
    _, pcfg = _model_cfgs()
    for kw in ({"model": "futr"}, {"model": "futr_fusion_grad"},
               {"compute_dtype": "bfloat16"}, {"use_encoder": True}):
        with pytest.raises(NotImplementedError):
            build_model(dataclasses.replace(pcfg, **kw), 17, (6, 5))


@torch.no_grad()
def test_init_weights_draws_the_flax_distributions():
    _, pcfg = _model_cfgs()
    m = init_weights(build_model(pcfg, 17, (6, 5)), torch.Generator().manual_seed(0))
    w = m.depth_embed.depth_projection.weight
    assert w.abs().max() <= np.sqrt(6 / (30 + 32)) and w.abs().max() > 0.5 * np.sqrt(6 / 62)
    assert m.fuser.bn_rgb.weight.eq(1).all() and m.fuser.bn_rgb.running_var.eq(1).all()
    assert 0 <= m.fuser.alpha.min() and m.fuser.alpha.max() <= 1
    assert m.pos_embedding.abs().max() <= np.sqrt(6 / (512 + 32))
    assert abs(float(m.query_embed.std()) - 1.0) < 0.3
    assert all(b.eq(0).all() for n, b in m.named_parameters() if n.endswith("proj.bias"))
    again = init_weights(build_model(pcfg, 17, (6, 5)), torch.Generator().manual_seed(0))
    for a, b in zip(m.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
