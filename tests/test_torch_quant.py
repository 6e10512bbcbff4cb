"""The port's int8 weight-only quantizer and uint8 depth input against the
JAX package's (``r3d_tpu/ops/quant.py``, ``r3d_tpu/serving.py``).

Leaf by leaf, the port quantizes the set JAX's ``quantize_tree`` does,
mapped through the converter, and its int8 values and fp32 scales are
bit-equal to JAX's: Dense, 2-D and 1-D conv kernels, the fuser's flat
kernels, the MoE's stacked expert kernels (one scale an output channel
across the experts) and the LSTM's gate kernels (eligible gate by gate:
at hidden 96 each direction's input gate kernels, 96 x 48, are over the
element floor and its recurrent ones, 48 x 48, under it, though the four
stacked in ``weight_hh`` would be over). ``quantize_depth`` and the on-device dequantization
of depth are bit-equal to JAX's too.

The int8, uint8 and int8 + uint8 sessions are held to JAX's same sessions
at the float session's tolerances (``tests/test_torch_serving.py``): logits
1e-4 in fp32 and 1e-3 with the bf16 dtypes, durations 1e-4, decoded
results equal. One case routes K3 through its registered operator on the
CPU (eligibility patched, as ``tests/test_torch_models.py`` does).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.ops.quant import QuantizedTensor as JaxQuantizedTensor
from r3d_tpu.ops.quant import dequantize_tree, quantize_tree
from r3d_tpu.ops.quant import quantize_array as jax_quantize_array
from r3d_tpu.serving import InferenceSession as JaxSession
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import flax_kernels, state_dict_from_flax
from r3d_tpu_torch.models import build_model, layers
from r3d_tpu_torch.ops import attention as pt_attention
from r3d_tpu_torch.ops.quant import (
    QUANT_MIN_ELEMS,
    QuantizedTensor,
    dequantize_state_dict,
    quantize_array,
    quantize_state_dict,
    quantized_nbytes,
)
from r3d_tpu_torch.serving import InferenceSession, dequantize_depth

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 17


def _model_cfgs(model, **kw):
    kw = dict(dict(model=model, hidden_dim=64, n_head=4, n_query=8, input_dim=12,
                   max_pos_len=64, dropout=0.0, n_decoder_layers=1), **kw)
    return jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)


def _init_args(model, rng, input_dim, S=32):
    """The flax init's inputs for each model's forward."""
    x = rng.randn(2, S, input_dim).astype(np.float32)
    mask = np.zeros((2, S), bool)
    if model == "futr_fusion_bn":
        return (x, rng.rand(2, S, 8, 8).astype(np.float32), None)
    if model == "futr_gaze":
        return (x, rng.rand(2, 40, 2).astype(np.float32), mask, np.array([40, 17], np.int32))
    if model in ("rnn", "cnn", "tcn"):
        return (x, mask)
    return (x, None)


# model -> config overrides: widths where kernels fall on both sides of the floor
LEAF_CASES = {
    "futr_fusion_bn": {},                        # Dense, depth projection, flat fuser kernels
    "futr_moe": dict(model="futr", moe_experts=2, moe_top_k=2),   # stacked expert kernels
    "rnn": dict(hidden_dim=96),                  # LSTM gates: 96x48 over, 48x48 under
    "tcn": dict(input_dim=96),                   # 1-D convs, WN ``v`` (never a kernel)
    "futr_gaze": dict(query_num=10),             # 2-D convs of the gaze CNN
}


def _init(model, *args):
    """flax variables of ``model`` from a seed (jitted: one compile, not one
    for each op of an eager init)."""
    return jax.device_get(jax.jit(lambda key: model.init(key, *args, train=False))(
        jax.random.PRNGKey(1)))


def _random_like(model, *args):
    """flax variables of ``model``'s shapes filled from a numpy seed (the
    quantizer reads values, not an init's distribution; ``eval_shape``
    compiles nothing)."""
    rng = np.random.RandomState(2)
    shapes = jax.eval_shape(lambda key: model.init(key, *args, train=False),
                            jax.random.PRNGKey(1))
    return jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape) * rng.rand(), s.dtype), shapes)


def _jax_quantized(params):
    """{flax path: QuantizedTensor} of JAX's ``quantize_tree``."""
    out = {}
    q = quantize_tree(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            q, is_leaf=lambda x: isinstance(x, JaxQuantizedTensor))[0]:
        if isinstance(leaf, JaxQuantizedTensor):
            out[tuple(p.key for p in path)] = leaf
    return out


def _through_converter(params, value):
    """``state_dict_from_flax`` of ``params`` with every leaf replaced by
    ``value(path, leaf)``: where a flax leaf lands in the port."""
    def rebuild(tree, prefix=()):
        return {k: rebuild(v, prefix + (k,)) if isinstance(v, dict)
                else np.asarray(value(prefix + (k,), v), np.float32) for k, v in tree.items()}
    return state_dict_from_flax({"params": rebuild(params)})


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_quantized_leaves_equal_jax(case):
    kw = dict(LEAF_CASES[case])
    model = kw.pop("model", case)
    jcfg, pcfg = _model_cfgs(model, **kw)
    args = _init_args(model, np.random.RandomState(0), jcfg.input_dim)
    variables = _random_like(jax_build_model(jcfg, N_CLASS), *args)
    params = variables["params"]
    want = _jax_quantized(params)
    assert want, "no kernel over the floor: the case checks nothing"

    marked = _through_converter(params, lambda p, x: np.full(np.shape(x), float(p in want)))
    want_keys = {k for k, t in marked.items() if bool(t.all())}
    assert all(bool(t.all()) or not bool(t.any()) for t in marked.values())  # no split tensor
    q_want = _through_converter(params, lambda p, x: want[p].q if p in want else np.zeros(np.shape(x)))
    s_want = _through_converter(params, lambda p, x: np.broadcast_to(want[p].scale, want[p].q.shape)
                                if p in want else np.zeros(np.shape(x)))

    port = build_model(pcfg, N_CLASS, (8, 8))
    port.load_state_dict(state_dict_from_flax(variables))
    tensors = dict(port.named_parameters())
    got = quantize_state_dict(tensors, flax_kernels(port))
    got_keys = {k for k, v in got.items() if isinstance(v, QuantizedTensor)}
    assert got_keys == want_keys
    if case == "futr_moe":   # the rule's edge cases are exercised
        assert any("experts" in k for k in got_keys), got_keys
    if case == "rnn":
        hh = [k for k in tensors if "weight_hh" in k]
        assert hh and all(tensors[k].numel() >= QUANT_MIN_ELEMS for k in hh)
        assert {k for k in got_keys if "rnn." in k} == {k for k in tensors if "weight_ih" in k}
    for k in want_keys:
        qt = got[k]
        assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
        np.testing.assert_array_equal(qt.q.numpy(), q_want[k].numpy().astype(np.int8), err_msg=k)
        np.testing.assert_array_equal(qt.scale.expand_as(qt.q).numpy(), s_want[k].numpy(),
                                      err_msg=k)
    for k in set(got) - got_keys:
        assert got[k] is tensors[k]


def test_quantize_array_ties_and_zero_channels_match_jax():
    """Half-way values round to even (``jnp.round``), a zero channel keeps
    scale 1, values clip at +-127; a Dense kernel [in, out] against the
    port's [out, in]."""
    w = np.zeros((8, 3), np.float32)
    w[:, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.0]
    w[:, 2] = np.linspace(-1e-3, 2e-3, 8)
    jq = jax_quantize_array(jnp.asarray(w))
    pq = quantize_array(torch.from_numpy(w.T.copy()), 0)
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q).T)
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale).T)
    assert pq.scale[1, 0] == 1.0 and list(pq.q[0, :4]) == [127, 0, 2, 2]
    deq = dequantize_state_dict({"k": pq})["k"]
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(dequantize_tree({"k": jq})["k"]).T)


def test_eligibility_floor_and_nbytes():
    """JAX's floor: 4,096 elements and two dims; the bytes count int8 values
    and scales."""
    kernels = {"a": (0, 1), "b": (0, 1), "c": (0, 1), "lstm": (0, 4)}
    w = {"a": torch.ones(64, 64), "b": torch.ones(63, 64), "c": torch.ones(4096),
         "lstm": torch.ones(4 * 64, 64), "free": torch.ones(128, 128)}
    q = quantize_state_dict(w, kernels)
    assert [k for k, v in q.items() if isinstance(v, QuantizedTensor)] == ["a", "lstm"]
    assert QUANT_MIN_ELEMS == 4096
    assert quantized_nbytes(q) == (64 * 64 + 64 * 4 + 63 * 64 * 4 + 4096 * 4
                                   + 256 * 64 + 256 * 4 + 128 * 128 * 4)


@pytest.mark.parametrize("kind", ["float", "constant", "uint8", "empty"])
def test_quantize_depth_matches_jax(kind):
    rng = np.random.RandomState(3)
    d = {"float": (rng.rand(30, 8, 8) * 3 - 1).astype(np.float32),
         "constant": np.full((5, 8, 8), 0.25, np.float32),
         "uint8": rng.randint(0, 256, (7, 8, 8)).astype(np.uint8),
         "empty": np.zeros((0, 8, 8), np.float32)}[kind]
    got, want = InferenceSession.quantize_depth(d), JaxSession.quantize_depth(d)
    assert got[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depth_dequantization_matches_jax_bit_for_bit(dtype):
    """``u * scale + lo`` in fp32, then the storage dtype, against JAX's
    jitted ``_maybe_dequant_input``; pad rows (0, 1/255) give 0."""
    rng = np.random.RandomState(4)
    rows = [(rng.rand(20, 8, 8) * 5 - 2).astype(np.float32) for _ in range(3)]
    u = np.zeros((4, 20, 8, 8), np.uint8)
    qp = np.zeros((4, 2), np.float32)
    qp[:, 1] = 1.0 / 255.0
    for j, d in enumerate(rows):
        u[j], lo, scale = InferenceSession.quantize_depth(d)
        qp[j] = (lo, scale)
    jcfg = jax_config.get_config("utkinects").replace(
        data=jax_config.DataConfig(feature_dtype=dtype))
    js = JaxSession.__new__(JaxSession)
    js.config, js.input_dtype = jcfg, "uint8"
    fn = jax.jit(js._maybe_dequant_input(lambda v, f, d, m: d))
    want = np.asarray(fn(None, None, u, qp, None).astype(jnp.float32))
    got = dequantize_depth(torch.from_numpy(u), torch.from_numpy(qp), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[3].any()


# ---- the quantized and uint8 sessions against JAX's ----

def _session_cfgs(bf16: bool):
    model = dict(model="futr_fusion_bn", hidden_dim=64, n_head=4, n_query=8, input_dim=12,
                 max_pos_len=256, embed_dtype="bfloat16" if bf16 else None)
    data = dict(depth_shape=(8, 8), seq_buckets=(128, 256),
                feature_dtype="bfloat16" if bf16 else "float32")
    make = lambda m: m.get_config("utkinects").replace(
        model=m.ModelConfig(**model), data=m.DataConfig(**data))
    return make(jax_config), make(pt_config)


@pytest.fixture(scope="module")
def variables():
    """flax variables of the sessions' model (the same in fp32 and bf16)
    with randomized BN statistics."""
    rng = np.random.RandomState(0)
    v = _init(jax_build_model(_session_cfgs(False)[0].model, N_CLASS),
              np.zeros((1, 128, 12), np.float32), np.zeros((1, 128, 8, 8), np.float32), None)
    for name in ("bn_rgb", "bn_depth"):
        v["params"]["fuser"][name]["scale"] = rng.randn(64).astype(np.float32)
        v["batch_stats"]["fuser"][name] = {"mean": rng.randn(64).astype(np.float32) * 0.3,
                                           "var": rng.rand(64).astype(np.float32) + 0.5}
    return v


def _depth_videos(seed, lengths):
    rng = np.random.RandomState(seed)
    return [{"features": rng.randn(n, 12).astype(np.float32),
             "depth": rng.rand(n, 8, 8).astype(np.float32)} for n in lengths]


SESSION_CASES = {   # id -> (quantize, input_dtype, bf16, through the K3 operator)
    "int8": ("int8", None, False, False),
    "uint8": (None, "uint8", False, False),
    "int8_uint8": ("int8", "uint8", False, False),
    "int8_uint8_bf16": ("int8", "uint8", True, False),
    "int8_uint8_k3_op": ("int8", "uint8", False, True),
}


@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_session_matches_jax(case, variables, monkeypatch):
    quantize, input_dtype, bf16, k3_op = SESSION_CASES[case]
    jcfg, pcfg = _session_cfgs(bf16)
    kw = dict(quantize=quantize, input_dtype=input_dtype, max_batch=4)
    js = JaxSession(jcfg, variables, N_CLASS, **kw)
    port = InferenceSession(pcfg, state_dict_from_flax(variables), N_CLASS, device="cpu", **kw)
    if quantize:
        assert any(isinstance(v, tuple) for v in port.weights.values())
        assert quantized_nbytes(port.weights) < quantized_nbytes(
            dict(InferenceSession(pcfg, state_dict_from_flax(variables), N_CLASS,
                                  device="cpu").weights))
    calls = []
    if k3_op:
        monkeypatch.setattr(layers, "attention_kernel_eligible",
                            lambda Lq, Lk, D, device: pt_attention.attention_kernel_eligible(
                                Lq, Lk, D, torch.device("cuda")))
        real = pt_attention.flash_attention_op

        def spy(*a):
            calls.append(a[0].shape)
            return real(*a)

        monkeypatch.setattr(pt_attention, "flash_attention_op", spy)
    videos = _depth_videos(1, (100, 60, 128, 200))   # a 128 chunk of 4, a 256 chunk of 1
    want = js.anticipate_batch(videos, future_len=40)
    got = port.anticipate_batch(videos, future_len=40)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("transcript", "future_frames", "seg"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"video {i} {key}")
        np.testing.assert_allclose(g["durations"], w["durations"], atol=1e-4, rtol=0)
    if k3_op:
        assert calls and all(s[2] == 8 for s in calls)   # the 256 chunk's cross-attention
    batch = port._collate(videos[:3], 128)
    assert len(batch) == (4 if input_dtype else 3)
    if input_dtype:
        assert batch[1].dtype == torch.uint8 and batch[3].dtype == torch.float32
        np.testing.assert_array_equal(batch[3][3].numpy(), [0.0, np.float32(1 / 255)])
    feats, depth, mask, *qp = batch
    jargs = (feats.float().numpy(), depth.numpy() if input_dtype else depth.float().numpy(),
             mask.numpy(), *(q.numpy() for q in qp))
    out_w = js._run(*jargs)
    out_g = port._run(*batch)
    atol = 1e-3 if bf16 else 1e-4
    for key in ("action", "duration", "seg"):
        np.testing.assert_allclose(out_g[key].numpy(), np.asarray(out_w[key]), atol=atol,
                                   rtol=0, err_msg=key)
