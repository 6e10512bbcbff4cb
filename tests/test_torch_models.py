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

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

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


@pytest.mark.parametrize("name", ["utkinects", "synthetic", "50salads", "breakfast",
                                  "50salads_proposed", "breakfast_proposed"])
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
    """float16 compute is not ported and raises; the fusion models build in
    bf16 (with fp32 parameters, as flax keeps them)."""
    _, pcfg = _model_cfgs()
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(pcfg, model="futr", compute_dtype="float16"), 17, (6, 5))
    m = build_model(dataclasses.replace(pcfg, compute_dtype="bfloat16"), 17, (6, 5))
    assert isinstance(m, futr_fusion.FUTRFusion) and isinstance(m.fuser, fuser.CMFuserBN)
    assert all(p.dtype == torch.float32 for p in m.parameters())


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


# ---- train mode: batch-statistics BN, gradients (dropout 0) ----

def _grads_close(model, jax_grads, rel=1e-5, model_wide=False):
    """Each parameter's .grad against the JAX gradient pytree carried across
    with ``state_dict_from_flax``, to ``rel`` of the tensor's largest entry,
    or with ``model_wide`` of the largest gradient entry in the model."""
    want = state_dict_from_flax({"params": jax.device_get(jax_grads)})
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in got.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.abs(g - w).max()
        assert err <= rel * max(1.0, top if model_wide else np.abs(w).max()), (name, err)


def _stats_close(model, batch_stats, atol=1e-6):
    want = state_dict_from_flax({"batch_stats": jax.device_get(batch_stats)})
    got = model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def test_torch_batchnorm_train_matches_flax():
    """Batch statistics over (B, T) normalize (biased variance); the running
    statistics update by momentum 0.1 with the unbiased variance."""
    rng = np.random.RandomState(8)
    x = (rng.randn(3, 10, 32) * 2 + 0.5).astype(np.float32)
    m = jax_fuser.TorchBatchNorm(32)
    variables = jax.device_get(m.init(jax.random.PRNGKey(0), x, train=False))
    variables["params"]["scale"] = rng.randn(32).astype(np.float32)
    variables["batch_stats"] = {"mean": rng.randn(32).astype(np.float32),
                                "var": rng.rand(32).astype(np.float32) + 0.5}
    (want, _), mutated = m.apply(variables, x, train=True, mutable=["batch_stats"])
    port = _port(fuser.TorchBatchNorm(32), variables).train()
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=ATOL, rtol=0)
    _stats_close(port, mutated["batch_stats"])


@pytest.mark.parametrize("jax_path", ["composed", "pallas-interpret"])
@pytest.mark.parametrize("frozen", [False, True], ids=["batch-stats", "frozen"])
def test_cmfuser_bn_train_matches_flax(jax_path, frozen, monkeypatch):
    """CMFuserBN with train=True and dropout 0: output, the gradients of
    every parameter and input, and the BN statistics. ``frozen`` is the
    sticky-eval twin (running statistics, no update)."""
    C = 32
    rng = np.random.RandomState(9)
    rgb = rng.randn(3, 20, C).astype(np.float32)
    depth = rng.randn(3, 20, C).astype(np.float32)
    w = rng.randn(3, 20, C).astype(np.float32)
    m = jax_fuser.CMFuserBN(C, n_head=8, drop_rate=0.0, frozen=frozen,
                            use_pallas=jax_path == "pallas-interpret")
    variables = _randomize_bn(m.init(jax.random.PRNGKey(4), rgb, depth), rng, C)
    if jax_path == "pallas-interpret":
        monkeypatch.setenv("R3D_FORCE_PALLAS", "1")

    def loss(params, r, d):
        out, mut = m.apply({"params": params, "batch_stats": variables["batch_stats"]}, r, d,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut)

    (_, (want, mutated)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], rgb, depth)
    port = _port(fuser.CMFuserBN(C, drop_rate=0.0, frozen=frozen), variables).train()
    r, d = _t(rgb).requires_grad_(), _t(depth).requires_grad_()
    got = port(r, d)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=2e-5, rtol=0)
    _grads_close(port, grads[0])
    for a, b in ((r, grads[1]), (d, grads[2])):
        np.testing.assert_allclose(a.grad.numpy(), _np(b), atol=2e-5, rtol=0)
    _stats_close(port, mutated["batch_stats"])


def test_futr_fusion_train_matches_flax():
    """The whole model with train=True and dropout 0 at S = 256: outputs,
    the gradients of a loss over every output, and the BN statistics."""
    jcfg, pcfg = _model_cfgs()
    jcfg = dataclasses.replace(jcfg, dropout=0.0, fuser_dropout=0.0)
    pcfg = dataclasses.replace(pcfg, dropout=0.0, fuser_dropout=0.0)
    S = 256
    rng = np.random.RandomState(S + 1)
    x = rng.randn(2, S, 12).astype(np.float32)
    d = rng.rand(2, S, 6, 5).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, S // 3:] = True
    m = jax_build_model(jcfg, 17)
    variables = _randomize_bn(m.init(jax.random.PRNGKey(8), x, d, pad, train=False), rng, 32,
                              at=("fuser",))
    weights = {k: rng.randn(*shape).astype(np.float32) for k, shape in
               (("action", (2, 8, 17)), ("duration", (2, 8)), ("seg", (2, S, 17)),
                ("fused", (2, S, 32)))}

    def loss(params):
        out, mut = m.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           x, d, pad, train=True, mutable=["batch_stats"])
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), (out, mut)

    (_, (want, mutated)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    port = _port(build_model(pcfg, 17, (6, 5)), variables).train()
    got = port(_t(x), _t(d), _t(pad))
    sum((got[k] * _t(weights[k])).sum() for k in weights).backward()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=2e-5, rtol=0,
                                   err_msg=k)
    # model-wide scale: the depth LayerNorm's scale gradient sums terms that
    # cancel (xhat is zero-mean per row) to ~1e-1 while others reach ~1e2
    _grads_close(port, grads, model_wide=True)
    _stats_close(port, mutated["batch_stats"])


# ---- FUTR (the 50salads and breakfast model), fp32 and bf16 ----

def _futr_cfgs(dtype):
    kw = dict(model="futr", hidden_dim=64, n_head=4, n_query=20, input_dim=24,
              n_decoder_layers=2, max_pos_len=800, seg_excludes_none=True, dropout=0.0,
              compute_dtype=dtype)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


def _route_on_cpu(monkeypatch, route):
    """Send the port's decoder cross-attention down ``route`` on the CPU,
    where the wrappers run their plain versions, and JAX's to the Pallas
    kernels in interpret mode (``R3D_FORCE_PALLAS``); "composed" leaves both
    on the plain path."""
    from r3d_tpu_torch.ops import attention as pt_attention
    from r3d_tpu_torch.ops import cross_attention as pt_cross

    monkeypatch.delenv("R3D_CROSS_NATIVE", raising=False)
    monkeypatch.delenv("R3D_FORCE_PALLAS", raising=False)
    if route == "composed":
        return
    monkeypatch.setenv("R3D_FORCE_PALLAS", "1")
    card = torch.device("cuda")
    monkeypatch.setattr(layers, "attention_kernel_eligible",
                        lambda Lq, Lk, D, device: pt_attention.attention_kernel_eligible(
                            Lq, Lk, D, card))
    monkeypatch.setattr(layers, "cross_attention_native_eligible",
                        lambda Lq, Lk, C, H, rate, device:
                        pt_cross.cross_attention_native_eligible(Lq, Lk, C, H, rate, card))


@pytest.mark.parametrize("S", [520, 600])
def test_futr_fusion_decoder_on_k6_matches_flax(S, monkeypatch):
    """The futr_fusion_bn decoder at the utkinects widths (C 128, 8 heads of
    16, 8 queries, one decoder layer, FFN 512) against more than 512 keys,
    train mode with dropout 0: JAX's cross-attention on its Pallas K6 and K7
    in interpret mode, the port's on the K6/K7 route (their plain versions
    on the CPU). The output within 2e-5, every parameter's gradient within
    1e-5 of the model's largest, and the gradients of memory and pos within
    2e-5."""
    from r3d_tpu.ops import cross_attention as jax_cross
    from r3d_tpu_torch.ops import cross_attention as pt_cross

    _route_on_cpu(monkeypatch, "K6")
    routed = {"jax": 0, "fwd": 0, "bwd": 0}

    def spy(module, name, key):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            routed[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    spy(jax_cross, "cross_attention_native_sharded", "jax")
    spy(pt_cross, "composed_cross_attention", "fwd")
    spy(pt_cross, "composed_cross_attention_bwd", "bwd")
    B, Q, C = 2, 8, 128
    rng = np.random.RandomState(S)
    src, pos = (rng.randn(B, S, C).astype(np.float32) for _ in range(2))
    qpos = rng.randn(B, Q, C).astype(np.float32)
    w = rng.randn(B, Q, C).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, S // 3:] = True
    m = jax_transformer.FUTRTransformer(C, 8, 2, 1, 4 * C, dropout=0.0, use_encoder=False)
    variables = jax.device_get(m.init(jax.random.PRNGKey(5), src, pos, qpos, pad))

    def loss(params, src, pos):
        _, hs = m.apply({"params": params}, src, pos, qpos, pad, deterministic=False)
        return jnp.sum(hs * w), hs

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], src, pos)
    port = _port(transformer.FUTRTransformer(C, 8, 1, 4 * C), variables).train()
    src_t, pos_t = _t(src).requires_grad_(), _t(pos).requires_grad_()
    _, hs = port(src_t, pos_t, _t(qpos), _t(pad))
    (hs * _t(w)).sum().backward()
    assert routed["jax"] >= 1 and routed["fwd"] == 1 and routed["bwd"] == 1, routed
    np.testing.assert_allclose(hs.detach().numpy(), _np(want), atol=2e-5, rtol=0)
    _grads_close(port, grads[0], model_wide=True)
    for name, got, g in (("memory", src_t, grads[1]), ("pos", pos_t, grads[2])):
        np.testing.assert_allclose(got.grad.numpy(), _np(g), atol=2e-5, rtol=0, err_msg=name)


# bf16 bounds. JAX runs op by op here: under jit, XLA's CPU compiler drops
# bf16 round trips inside its fusions, and the jitted JAX bf16 model sits
# as far from the port's bf16 model as from the port in fp32 (outputs 1.4e-2
# of their largest entry either way). Op by op, the composed route agrees
# bit for bit in the forward; K3 and K6 keep their scores in fp32, and K6's
# plain version and JAX's K6 round e against different running maxima.
# Each bound lies between the reading of the port in bf16 and the reading
# of a control, the port in fp32 against the same JAX bf16 run (composed,
# K3, K6):
#   outputs, over their largest entry: bf16 0, 6.1e-3, 1.10e-2; control
#     1.96e-2, 1.72e-2, 1.51e-2; bound 1.3e-2;
#   gradients, over the model's largest entry: bf16 1.36e-2, 1.39e-2,
#     4.95e-2; control 5.80e-2, 5.98e-2, 9.11e-2; bound 7e-2 (only K6's
#     control fails it);
#   cosine of the whole gradient vectors: bf16 0.999967, 0.999965,
#     0.999831; control 0.998853, 0.998763, 0.999205; bound 0.9995.
# The serving forward (module-eval, bf16 input) agrees bit for bit; its
# control reads 9.7e-3-1.41e-2; bound 2e-3.
FUTR_BF16_TOL = 1.3e-2
FUTR_BF16_GRAD_TOL = 7e-2
FUTR_BF16_COS_MIN = 0.9995
FUTR_BF16_EVAL_TOL = 2e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route,S", [("composed", 128), ("K3", 256), ("K6", 700)])
def test_futr_matches_flax(route, S, dtype, monkeypatch):
    """FUTR with train=True and dropout 0 under converted weights: every
    output and every parameter's gradient of a weighted sum of them, with
    the decoder cross-attention on the composed path, K3 (256 keys) or K6
    (700 keys)."""
    jcfg, pcfg = _futr_cfgs(dtype)
    _route_on_cpu(monkeypatch, route)
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, 24).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, S // 3:] = True
    m = jax_build_model(dataclasses.replace(jcfg, model="futr_baseline"), 20)
    variables = jax.device_get(m.init(jax.random.PRNGKey(9), x, pad, train=False))
    weights = {k: rng.randn(*shape).astype(np.float32) for k, shape in
               (("action", (2, 20, 20)), ("duration", (2, 20)), ("seg", (2, S, 19)),
                ("supcon", (2, 20, 64)))}

    def loss(params):
        out = m.apply({"params": params}, x, pad, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])  # op by op
    port = _port(build_model(dataclasses.replace(pcfg, model="futr_baseline"), 20),
                 variables).train()
    got = port(_t(x), _t(pad))
    sum((got[k] * _t(weights[k])).sum() for k in weights).backward()
    assert sorted(got) == sorted(want)
    tol = 2e-5 if dtype == "float32" else FUTR_BF16_TOL
    for k in want:
        assert got[k].dtype == torch.float32
        err = np.abs(got[k].detach().numpy() - _np(want[k])).max()
        assert err <= tol * max(1.0, np.abs(_np(want[k])).max()), (k, err)
    _grads_close(port, grads, rel=1e-5 if dtype == "float32" else FUTR_BF16_GRAD_TOL,
                 model_wide=True)
    want_g = state_dict_from_flax({"params": jax.device_get(grads)})
    a = torch.cat([p.grad.flatten() for _, p in sorted(port.named_parameters())])
    b = torch.cat([want_g[n].flatten() for n, _ in sorted(port.named_parameters())])
    cos_min = 0.999999 if dtype == "float32" else FUTR_BF16_COS_MIN
    assert float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=0)) > cos_min


def test_futr_eval_forward_without_mask_matches_flax():
    """The serving forward: module-eval, no pad mask, bf16 batch and compute."""
    jcfg, pcfg = _futr_cfgs("bfloat16")
    rng = np.random.RandomState(11)
    x = rng.randn(2, 200, 24).astype(np.float32)
    m = jax_build_model(jcfg, 20)
    variables = m.init(jax.random.PRNGKey(2), x, None, train=False)
    want = m.apply(variables, jnp.asarray(x, jnp.bfloat16), None, train=False)
    got = _port(build_model(pcfg, 20), variables)(_t(x).to(torch.bfloat16))
    for k in want:
        err = np.abs(got[k].detach().numpy() - _np(want[k])).max()
        assert err <= FUTR_BF16_EVAL_TOL * max(1.0, np.abs(_np(want[k])).max()), (k, err)


@torch.no_grad()
def test_init_weights_covers_futr():
    _, pcfg = _futr_cfgs("bfloat16")
    m = init_weights(build_model(pcfg, 20), torch.Generator().manual_seed(0))
    assert m.pos_embedding.abs().max() <= np.sqrt(6 / (800 + 64))
    assert m.pos_embedding.abs().max() > 0 and abs(float(m.query_embed.std()) - 1.0) < 0.3
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert m.transformer.decoder.norm.weight.eq(1).all()
