"""The FUTR encoder (``use_encoder=True``) of the port against the JAX
package's, on the CPU: ``EncoderLayer``, the encoder stack under
``FUTRTransformer``, and the models that pass ``use_encoder``
(``futr_fusion_bn`` in fp32, ``futr`` in fp32 and bf16, ``futr_proposed``).

Weights are a flax init carried across with ``convert.state_dict_from_flax``
(strict, so ``encoder/layer{i}`` must land on ``encoder.layers.{i}``);
dropout is 0. The encoder's self-attention has S queries against S keys:
at S = 256 with heads of 16 both routers send it to the attention kernels
(JAX's Pallas flash attention in interpret mode under ``R3D_FORCE_PALLAS``,
the port's K3 forward and K5 backward, whose plain versions run here).
fp32 tolerances: outputs and input gradients 2e-5, parameter gradients
1e-5 of the model's largest entry. The bf16 ``futr`` is held to the bounds
stated above its test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.models import transformer as jax_transformer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models import build_model, transformer
from r3d_tpu_torch.ops import attention as pt_attention
from test_torch_models import _futr_cfgs, _grads_close, _np, _port, _route_on_cpu, _t

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

ATOL = 2e-5


def _spy_attention(monkeypatch):
    """Count the port's K3 forward and K5 backward routes (their plain
    versions on the CPU) by the query count of each call."""
    calls = {"fwd": [], "bwd": []}

    def spy(name, key):
        fn = getattr(pt_attention, name)

        def counted(q, *args, **kwargs):
            calls[key].append(q.shape[2])
            return fn(q, *args, **kwargs)

        monkeypatch.setattr(pt_attention, name, counted)

    spy("composed_attention", "fwd")
    spy("composed_attention_bwd", "bwd")
    return calls


def test_futr_transformer_with_encoder_matches_flax(monkeypatch):
    """Two encoder layers (each ``EncoderLayer`` post-norm, ``src + pos``
    as queries, keys and values under the key-padding mask) and one decoder
    layer at C = 64, 4 heads of 16, S = 64 on the composed route: memory
    and the decoder output, and the gradients of every parameter, of the
    source and of the positions. The models' tests below take the K3
    route."""
    route, S = "composed", 64
    _route_on_cpu(monkeypatch, route)
    calls = _spy_attention(monkeypatch)
    B, Q, C = 2, 8, 64
    rng = np.random.RandomState(S)
    src, pos = (rng.randn(B, S, C).astype(np.float32) for _ in range(2))
    qpos = rng.randn(B, Q, C).astype(np.float32)
    wm, wh = rng.randn(B, S, C).astype(np.float32), rng.randn(B, Q, C).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, S // 3:] = True
    m = jax_transformer.FUTRTransformer(C, 4, 2, 1, 4 * C, dropout=0.0, use_encoder=True)
    variables = jax.device_get(m.init(jax.random.PRNGKey(1), src, pos, qpos, pad))
    assert sorted(variables["params"]["encoder"]) == ["layer0", "layer1"]

    def loss(params, s, p):
        mem, hs = m.apply({"params": params}, s, p, qpos, pad, deterministic=False)
        return jnp.sum(mem * wm) + jnp.sum(hs * wh), (mem, hs)

    (_, (mem_w, hs_w)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], src, pos)
    port = _port(transformer.FUTRTransformer(C, 4, 1, 4 * C, n_encoder_layers=2),
                 variables).train()
    s, p = _t(src).requires_grad_(), _t(pos).requires_grad_()
    mem, hs = port(s, p, _t(qpos), _t(pad))
    ((mem * _t(wm)).sum() + (hs * _t(wh)).sum()).backward()
    np.testing.assert_allclose(mem.detach().numpy(), _np(mem_w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(hs.detach().numpy(), _np(hs_w), atol=ATOL, rtol=0)
    _grads_close(port, grads[0], model_wide=True)
    for name, got, g in (("src", s, grads[1]), ("pos", p, grads[2])):
        np.testing.assert_allclose(got.grad.numpy(), _np(g), atol=ATOL, rtol=0, err_msg=name)
    assert calls == {"fwd": [], "bwd": []}


def _fusion_case(model, S, seed, **kw):
    base = dict(model=model, hidden_dim=32, n_head=2, n_query=8, input_dim=12,
                max_pos_len=512, dropout=0.0, fuser_dropout=0.0, use_encoder=True,
                n_encoder_layers=2)
    base.update(kw)
    jcfg, pcfg = jax_config.ModelConfig(**base), pt_config.ModelConfig(**base)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, S, 12).astype(np.float32)
    d = rng.rand(2, S, 6, 5).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, S // 3:] = True
    m = jax_build_model(jcfg, 17)
    variables = jax.device_get(m.init(jax.random.PRNGKey(seed), x, d, pad, train=False))
    return pcfg, m, variables, rng, x, d, pad


def test_fusion_model_with_encoder_matches_flax(monkeypatch):
    """``futr_fusion_bn`` with two encoder layers (C = 32, 2 heads of 16) at
    S = 256 on the K3 route, train mode with dropout 0: every output
    (``seg`` reads the encoder's memory) and every gradient of a weighted
    sum of them. The composed route is held at the stack's level above."""
    S = 256
    _route_on_cpu(monkeypatch, "K3")
    calls = _spy_attention(monkeypatch)
    pcfg, m, variables, rng, x, d, pad = _fusion_case("futr_fusion_bn", S, S + 3)
    shapes = {"action": (2, 8, 17), "duration": (2, 8), "seg": (2, S, 17), "fused": (2, S, 32)}
    weights = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def loss(params):
        out, _ = m.apply(dict(variables, params=params), x, d, pad, train=True,
                         mutable=["batch_stats"])
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    port = _port(build_model(pcfg, 17, (6, 5)), variables).train()
    assert len(port.transformer.encoder.layers) == 2
    got = port(_t(x), _t(d), _t(pad))
    sum((got[k] * _t(weights[k])).sum() for k in weights).backward()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)
    _grads_close(port, grads, model_wide=True)
    assert calls["fwd"].count(S) == 2 and calls["bwd"].count(S) == 2, calls


# bf16 ``futr`` with the encoder, JAX op by op against the port (as
# tests/test_torch_models.py runs bf16 FUTR), two encoder layers ahead of the
# two decoder layers. Unlike the decoder-only model, whose composed forward
# agrees bit for bit, an encoder entry can land on the neighbouring bf16
# value, and the decoder carries it on. Read on the CPU (port bf16 against
# JAX bf16; in brackets the control, the port in fp32 against the same JAX
# run), composed route at S = 128 and K3 route at S = 256:
#   outputs over their largest entry (floor 1): 1.24e-2, 9.7e-3 (1.06e-2,
#     1.29e-2): the action and duration heads, one or two bf16 steps of an
#     O(1) logit; seg reads 1.1e-3. No bound separates the two here; 2e-2;
#   gradients over the model's largest entry: 2.45e-2, 2.06e-2 (7.47e-2,
#     6.05e-2); bound 5e-2;
#   cosine of the whole gradient vectors: 0.999914, 0.999865 (0.999241,
#     0.999292); bound 0.9997.
# The test runs the K3 route, where the encoder's S queries meet the kernels.
ENC_BF16_TOL = 2e-2
ENC_BF16_GRAD_TOL = 5e-2
ENC_BF16_COS_MIN = 0.9997


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_futr_with_encoder_matches_flax(dtype, monkeypatch):
    """``futr`` (C = 64, 4 heads of 16, 20 queries, 2 decoder layers) with
    two encoder layers at S = 256 on the K3 route, train mode with dropout
    0: every output and every gradient of a weighted sum of them; fp32 at
    the fp32 tolerances, bf16 at the bounds above. The composed route is
    held at the stack's level above."""
    route, S = "K3", 256
    jcfg, pcfg = (dataclasses.replace(c, use_encoder=True, n_encoder_layers=2)
                  for c in _futr_cfgs(dtype))
    _route_on_cpu(monkeypatch, route)
    calls = _spy_attention(monkeypatch)
    rng = np.random.RandomState(S + 7)
    x = rng.randn(2, S, 24).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, S // 3:] = True
    m = jax_build_model(jcfg, 20)
    variables = jax.device_get(m.init(jax.random.PRNGKey(9), x, pad, train=False))
    weights = {k: rng.randn(*shape).astype(np.float32) for k, shape in
               (("action", (2, 20, 20)), ("duration", (2, 20)), ("seg", (2, S, 19)))}

    def loss(params):
        out = m.apply({"params": params}, x, pad, train=True,
                      rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])  # op by op
    port = _port(build_model(pcfg, 20), variables).train()
    got = port(_t(x), _t(pad))
    sum((got[k] * _t(weights[k])).sum() for k in weights).backward()
    tol = ATOL if dtype == "float32" else ENC_BF16_TOL
    for k in want:
        err = np.abs(got[k].detach().numpy() - _np(want[k])).max()
        assert err <= tol * max(1.0, np.abs(_np(want[k])).max()), (k, err)
    _grads_close(port, grads, rel=1e-5 if dtype == "float32" else ENC_BF16_GRAD_TOL,
                 model_wide=True)
    want_g = state_dict_from_flax({"params": jax.device_get(grads)})
    a = torch.cat([p.grad.flatten() for _, p in sorted(port.named_parameters())])
    b = torch.cat([want_g[n].flatten() for n, _ in sorted(port.named_parameters())])
    cos_min = 0.999999 if dtype == "float32" else ENC_BF16_COS_MIN
    assert float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=0)) > cos_min
    assert calls["fwd"].count(S) == 2 and calls["bwd"].count(S) == 2, calls


def test_futr_proposed_with_encoder_matches_flax():
    """The gt-query FUTR (``FUTRUnsupervised``) with the encoder, fp32,
    composed route, train mode with dropout 0: outputs and gradients."""
    kw = dict(model="futr_proposed", hidden_dim=32, n_head=4, n_query=8, input_dim=12,
              max_pos_len=128, dropout=0.0, query_num=11, use_encoder=True, n_encoder_layers=1)
    jcfg, pcfg = jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)
    S = 64
    rng = np.random.RandomState(5)
    x = rng.randn(2, S, 12).astype(np.float32)
    q = rng.randint(0, 11, (2, S)).astype(np.int32)
    pad = np.zeros((2, S), bool)
    pad[1, 40:] = True
    m = jax_build_model(jcfg, 9)
    variables = jax.device_get(m.init(jax.random.PRNGKey(4), x, q, pad, train=False))
    want0 = m.apply(variables, x, q, pad, train=False)
    weights = {k: rng.randn(*np.shape(v)).astype(np.float32) for k, v in want0.items()}

    def loss(params):
        out = m.apply({"params": params}, x, q, pad, train=True,
                      rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    port = _port(build_model(pcfg, 9), variables).train()
    got = port(_t(x), _t(q).long(), _t(pad))
    sum((got[k].float() * _t(weights[k])).sum() for k in weights).backward()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(), _np(want[k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    _grads_close(port, grads, model_wide=True)
