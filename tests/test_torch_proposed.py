"""The gt-query FUTR (``futr_proposed``) of the port against the JAX
package's, on the CPU, and the helpers it brings: the embedding rule of
the converter, the sinusoidal table, the two adaptive pools and the decoder
self-attention's query padding mask.

Each flax module is initialised from a seed, carried across with
``convert.state_dict_from_flax`` (strict ``load_state_dict``) and run on
the same numpy inputs. fp32 bounds are 2e-5 absolute on outputs and 1e-5
of the model's largest gradient entry (summation order only). bf16 runs
JAX op by op (under jit, XLA's CPU fusions drop bf16 round trips) and holds
the bounds of ``tests/test_torch_models.py``'s FUTR, whose derivation
there applies unchanged: outputs 1.3e-2 of their largest entry, gradients
7e-2 of the model's largest, the whole gradient vectors' cosine 0.9995.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.models import layers as jax_layers
from r3d_tpu.models import model_needs_query as jax_needs_query
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models import build_model, init_weights, model_needs_query
from r3d_tpu_torch.models import layers
from r3d_tpu_torch.models.futr_unsupervised import FUTRUnsupervised
from test_torch_models import (
    FUTR_BF16_COS_MIN,
    FUTR_BF16_GRAD_TOL,
    FUTR_BF16_TOL,
    _grads_close,
    _np,
    _port,
    _route_on_cpu,
    _t,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 6
QUERY_NUM = 20


def _cfgs(dtype="float32", **kw):
    kw = dict(dict(model="futr_proposed", hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                   n_decoder_layers=2, max_pos_len=300, query_num=QUERY_NUM,
                   seg_excludes_none=True, dropout=0.0, compute_dtype=dtype), **kw)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


@pytest.mark.parametrize("kind", ["nn.Embed", "FUTR query_embed parameter"])
def test_embedding_rule_of_the_converter(kind):
    """flax ``nn.Embed``'s ``embedding`` [num, C] becomes ``nn.Embedding``'s
    ``weight`` [num, C], untransposed; FUTR's raw ``query_embed`` parameter
    keeps its name and shape."""
    rng = np.random.RandomState(0)
    if kind == "nn.Embed":
        m = flax_nn.Embed(7, 5)
        ids = rng.randint(0, 7, (3, 4))
        variables = m.init(jax.random.PRNGKey(0), ids)
        port = torch.nn.Embedding(7, 5)
        port.load_state_dict(state_dict_from_flax(jax.device_get(variables)))
        np.testing.assert_array_equal(port(_t(ids).long()).detach().numpy(),
                                      _np(m.apply(variables, ids)))
    else:
        q = rng.randn(8, 5).astype(np.float32)
        sd = state_dict_from_flax({"params": {"query_embed": q}})
        assert list(sd) == ["query_embed"]
        np.testing.assert_array_equal(sd["query_embed"].numpy(), q)


def test_sinusoidal_table_matches_jax():
    """XLA's fp32 exp is not correctly rounded: a few of the table's
    frequencies differ from torch's by one ulp, which positions up to 3,100
    turn into 7.6e-6 of sin/cos (read here); bound 2e-5."""
    want = _np(jax_layers.sinusoidal_positional_encoding(3100, 64))
    got = layers.sinusoidal_positional_encoding(3100, 64).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,out", [(100, 8), (256, 20), (7, 8), (3100, 20)])
def test_adaptive_pools_match_jax(T, out, dtype):
    """The plain pool and the masked pool over ragged lengths (1, a third,
    all rows; fewer rows than bins): bf16 rounds its 1/len weights as JAX
    does, so both dtypes hold to one rounding of the product (2e-2 of the
    largest entry in bf16, 1e-6 in fp32)."""
    rng = np.random.RandomState(T + out)
    x = rng.randn(3, T, 16).astype(np.float32)
    lengths = np.array([T, max(1, T // 3), min(T, 5)], np.int32)
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    jx, px = jnp.asarray(x, jdt), _t(x).to(pdt)
    for want, got in (
            (jax_layers.adaptive_avg_pool1d(jx, out), layers.adaptive_avg_pool1d(px, out)),
            (jax_layers.masked_adaptive_avg_pool1d(jx, out, jnp.asarray(lengths)),
             layers.masked_adaptive_avg_pool1d(px, out, _t(lengths)))):
        assert got.dtype == pdt
        np.testing.assert_allclose(got.float().numpy(), _np(want.astype(jnp.float32)),
                                   atol=tol, rtol=0)


def test_pool_weights_round_like_jax_in_bf16():
    """Each bin's 1/len rounds to bf16 before the product, in both packages:
    a stream of ones pools to exactly the rounded weight times the count."""
    x = np.ones((2, 3100, 4), np.float32)
    lengths = np.array([3100, 1937], np.int32)
    want = jax_layers.masked_adaptive_avg_pool1d(jnp.asarray(x, jnp.bfloat16), 20,
                                                 jnp.asarray(lengths))
    got = layers.masked_adaptive_avg_pool1d(_t(x).to(torch.bfloat16), 20, _t(lengths))
    np.testing.assert_array_equal(got.float().numpy(), _np(want.astype(jnp.float32)))


def test_decoder_layer_query_mask_matches_flax():
    """The decoder self-attention with the S queries' padding mask."""
    rng = np.random.RandomState(3)
    B, S, C = 2, 40, 32
    tgt, mem, pos, qpos = (rng.randn(B, S, C).astype(np.float32) for _ in range(4))
    pad = np.zeros((B, S), bool)
    pad[1, 25:] = True
    m = jax_layers.DecoderLayer(32, 4, 128, dropout=0.0)
    variables = m.init(jax.random.PRNGKey(2), tgt, mem, pos, qpos, pad,
                       tgt_key_padding_mask=pad)
    want = m.apply(variables, tgt, mem, pos, qpos, pad, tgt_key_padding_mask=pad)
    port = _port(layers.DecoderLayer(32, 4, 128), variables)
    got = port(_t(tgt), _t(mem), _t(pos), _t(qpos), _t(pad), _t(pad))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-5, rtol=0)
    unmasked = port(_t(tgt), _t(mem), _t(pos), _t(qpos), _t(pad)).detach().numpy()
    assert np.abs(unmasked[1] - _np(want)[1]).max() > 1e-3   # the mask matters


def _inputs(S, masked, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, S, 12).astype(np.float32)
    query = rng.randint(0, QUERY_NUM, (2, S)).astype(np.int32)
    pad = None
    if masked:
        pad = np.zeros((2, S), bool)
        pad[1, S // 3:] = True
        query[1, S // 3:] = QUERY_NUM - 1     # the query pad id
    return rng, x, query, pad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route,S,masked", [("composed", 100, True), ("composed", 100, False),
                                            ("K3", 256, True)],
                         ids=["composed-masked", "composed-unmasked", "K3-256-masked"])
def test_futr_proposed_matches_flax(route, S, masked, dtype, monkeypatch):
    """futr_proposed with train=True and dropout 0 under converted weights:
    ``action``, ``duration``, ``seg``, ``l3`` and ``supcon``, and every
    parameter's gradient of a weighted sum of them; with the pad mask
    (training) and without (validation, the plain pool over pad rows too).
    On the K3 route every decoder attention (S queries against S keys)
    takes JAX's Pallas K3 and K5 in interpret mode and the port's K3/K5
    wrappers (their plain versions on the CPU), at 2 heads of 16."""
    H = 4 if route == "composed" else 2     # the kernels take head dims 16, 32, 64
    jcfg, pcfg = _cfgs(dtype, n_head=H)
    _route_on_cpu(monkeypatch, route)
    routed = []
    if route == "K3":
        from r3d_tpu_torch.ops import attention as pt_attention

        fn = pt_attention.flash_attention
        monkeypatch.setattr(layers, "flash_attention",
                            lambda *a: routed.append(a[0].shape) or fn(*a))
    rng, x, query, pad = _inputs(S, masked, S + masked)
    m = jax_build_model(jcfg, N_CLASS)
    variables = jax.device_get(m.init(jax.random.PRNGKey(4), x, query, pad, train=False))
    weights = {k: rng.randn(*shape).astype(np.float32) for k, shape in
               (("action", (2, 8, N_CLASS)), ("duration", (2, 8)), ("seg", (2, S, N_CLASS - 1)),
                ("l3", (2, S, QUERY_NUM)), ("supcon", (2, S, 32)))}

    def loss(params):
        out = m.apply({"params": params}, x, query, pad, train=True,
                      rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(jnp.sum(out[k].astype(jnp.float32) * weights[k]) for k in weights), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])  # op by op
    port = _port(build_model(pcfg, N_CLASS), variables).train()
    got = port(_t(x), _t(query), None if pad is None else _t(pad))
    sum((got[k].float() * _t(weights[k])).sum() for k in weights).backward()
    assert sorted(got) == sorted(want) == ["action", "duration", "l3", "seg", "supcon"]
    if route == "K3":
        assert routed == [(2, H, S, 32 // H)] * 4   # self and cross, two layers
    tol = 2e-5 if dtype == "float32" else FUTR_BF16_TOL
    for k in want:
        assert got[k].dtype == (torch.bfloat16 if k == "supcon" and dtype == "bfloat16"
                                else torch.float32), k
        w = _np(want[k].astype(jnp.float32))
        err = np.abs(got[k].detach().float().numpy() - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), (k, err)
    _grads_close(port, grads, rel=1e-5 if dtype == "float32" else FUTR_BF16_GRAD_TOL,
                 model_wide=True)
    want_g = state_dict_from_flax({"params": jax.device_get(grads)})
    names = sorted(n for n, _ in port.named_parameters())
    a = torch.cat([dict(port.named_parameters())[n].grad.flatten() for n in names])
    b = torch.cat([want_g[n].flatten() for n in names])
    cos_min = 0.999999 if dtype == "float32" else FUTR_BF16_COS_MIN
    assert float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=0)) > cos_min


def test_fc_l3_reads_the_queries_and_masked_rows_do_not_leak():
    """A padded query row changes no real row's output, and the masked pool
    of a padded batch equals the pool of the unpadded rows alone."""
    _, pcfg = _cfgs()
    model = init_weights(build_model(pcfg, N_CLASS), torch.Generator().manual_seed(0)).eval()
    rng, x, query, pad = _inputs(60, True, 5)
    L = int((~pad[1]).sum())
    with torch.no_grad():
        full = model(_t(x), _t(query), _t(pad))
        alone = model(_t(x[1:, :L]), _t(query[1:, :L]), _t(pad[1:, :L]))
        query2 = query.copy()
        query2[1, L:] = 3
        other = model(_t(x), _t(query2), _t(pad))
    for k in ("action", "duration"):
        np.testing.assert_allclose(full[k][1].numpy(), alone[k][0].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(full[k].numpy(), other[k].numpy())
    np.testing.assert_allclose(full["l3"][1, :L].numpy(), alone["l3"][0].numpy(), atol=1e-5,
                               rtol=0)


def test_registry_and_init():
    """``futr_proposed`` builds in fp32 and bf16, the query family is the
    JAX package's, the self-attention and gaze sources build too
    (``tests/test_torch_unsupervised_model.py`` holds them to JAX), so does
    the depth source (``tests/test_torch_query_variants.py``), and the
    embedding table is drawn as flax's xavier-uniform ``Embed``."""
    for name in jax_config.get_config("darai").model.model, "futr_proposed", "futr", "afft":
        assert model_needs_query(name) == jax_needs_query(name)
    for dtype in ("float32", "bfloat16"):
        _, pcfg = _cfgs(dtype)
        assert isinstance(build_model(pcfg, N_CLASS), FUTRUnsupervised)
    _, pcfg = _cfgs()
    for kw in ({"model": "futr_unsupervised"}, {"model": "futr_gaze"},
               {"model": "futr_unsupervised_temp2"}):
        assert isinstance(build_model(dataclasses.replace(pcfg, **kw), N_CLASS),
                          FUTRUnsupervised)
    assert FUTRUnsupervised(pcfg, N_CLASS, query_source="depth").query_source == "depth"
    with torch.no_grad():
        m = init_weights(build_model(pcfg, N_CLASS), torch.Generator().manual_seed(0))
    bound = np.sqrt(6 / (QUERY_NUM + 32))
    w = m.query_embed.weight
    assert w.abs().max() <= bound and w.abs().max() > 0.5 * bound
    assert m.pos_embedding.abs().max() <= np.sqrt(6 / (300 + 32))
    assert m.fc_l3.bias.eq(0).all() and all(p.dtype == torch.float32 for p in m.parameters())
