"""The five fusion models in bf16 against the JAX package's, on the CPU.

``futr_fusion_bn``, ``futr_fusion_grad``, ``futr_fusion_vary``,
``futr_fusion_nox`` and ``afft`` at ``compute_dtype="bfloat16"``, hidden
128 (the kernels' width), 8 heads, 8 queries, one decoder layer, S = 64,
from a flax init carried across with ``convert.state_dict_from_flax`` (the
BN gammas spread apart, the bottom-k tie trap), dropout 0. JAX's fuser runs
its Pallas kernels in interpret mode (``R3D_FORCE_PALLAS=1``, the TPU's
route: K1 on the blend route for ``futr_fusion_bn``, the no-blend route and
K2 for the others); the port's wrappers take their plain versions, which
round where those kernels do. A train-mode forward and the gradient of a
weighted sum of every output; for ``futr_fusion_bn`` also the eval-mode
forward (the running statistics, serving's route).

Tolerances (bf16: the two frameworks' sums land on neighbouring bf16
values now and then, and XLA's CPU backend skips some roundings, see
``tests/test_torch_fuser_bf16.py``): each output within 2e-2 of its largest
entry (read: 1.2e-2 at most); the gradients model-wide, a cosine of at
least 0.9995 over every parameter (read: 0.99990 at least) and each
tensor within 5e-2 of the model's largest gradient entry (read: 3.0e-2,
the decoder's first FFN weight). Per-tensor cosines are not held:
some gradients are zero in exact arithmetic and pure rounding noise here
(the key-projection biases; under ``futr_fusion_bn``'s batch statistics the
depth LayerNorm's scale, which the BatchNorm normalises away).
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
from r3d_tpu_torch.models import build_model

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

MODELS = ("futr_fusion_bn", "futr_fusion_grad", "futr_fusion_vary", "futr_fusion_nox", "afft")
S, C = 64, 128
OUT_TOL = 2e-2
GRAD_TOL = 5e-2
COS_MIN = 0.9995


def _case(model):
    kw = dict(model=model, hidden_dim=C, n_head=8, n_query=8, input_dim=12, max_pos_len=128,
              dropout=0.0, fuser_dropout=0.0, compute_dtype="bfloat16")
    jcfg, pcfg = jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)
    rng = np.random.RandomState(3)
    x = rng.randn(2, S, 12).astype(np.float32)
    d = rng.rand(2, S, 6, 5).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, S // 3:] = True
    m = jax_build_model(jcfg, 17)
    variables = jax.device_get(jax.jit(lambda key: m.init(key, x, d, pad, train=False))(
        jax.random.PRNGKey(1)))
    if model == "futr_fusion_bn":
        for name in ("bn_rgb", "bn_depth"):
            variables["params"]["fuser"][name]["scale"] = rng.permutation(
                0.2 + 0.1 * np.arange(C)).astype(np.float32)
    return pcfg, m, variables, rng, (x, d, pad)


def _port(pcfg, variables, train):
    port = build_model(pcfg, 17, (6, 5))
    port.load_state_dict(state_dict_from_flax(variables))
    return port.train(train)


def _outputs_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k].detach().float().numpy(), np.asarray(want[k], np.float32)
        assert np.isfinite(a).all(), k
        assert np.abs(a - b).max() <= OUT_TOL * max(1.0, np.abs(b).max()), k


@pytest.mark.parametrize("model", MODELS)
def test_bf16_model_matches_jax_kernel_route(model, monkeypatch):
    monkeypatch.setenv("R3D_FORCE_PALLAS", "1")
    pcfg, m, variables, rng, inputs = _case(model)
    x, d, pad = inputs
    shapes = jax.eval_shape(lambda: m.apply(variables, *inputs, train=False))
    weights = {k: rng.randn(*o.shape).astype(np.float32) for k, o in shapes.items()}

    def loss(params):
        out, _ = m.apply(dict(variables, params=params), *inputs, train=True,
                         mutable=["batch_stats"])
        return sum(jnp.sum(out[k].astype(jnp.float32) * weights[k]) for k in weights), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    port = _port(pcfg, variables, True)
    got = port(torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(pad))
    _outputs_close(got, want)
    sum((got[k].float() * torch.from_numpy(weights[k])).sum() for k in weights).backward()

    want_g = state_dict_from_flax({"params": jax.device_get(grads)})
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(want_g)
    a = np.concatenate([named[k].grad.numpy().ravel() for k in sorted(named)])
    b = np.concatenate([want_g[k].numpy().ravel() for k in sorted(named)])
    assert (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) >= COS_MIN
    top = np.abs(b).max()
    for k, p in named.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert np.abs(p.grad.numpy() - want_g[k].numpy()).max() <= GRAD_TOL * top, k

    if model == "futr_fusion_bn":   # serving's route: running statistics, eval mode
        want = jax.jit(lambda v: m.apply(v, *inputs, train=False))(variables)
        with torch.no_grad():
            got = _port(pcfg, variables, False)(*(torch.from_numpy(t) for t in inputs))
        _outputs_close(got, want)


@pytest.mark.parametrize("kind", ["bn", "grad"])
def test_bf16_fuser_depth_2_matches_jax(kind):
    """``fuser_depth = 2`` in bf16: JAX's composed stack (no kernel on either
    side; flax's rounding points: LayerNorm rounded to bf16, each product
    rounded, its bias added in bf16) against the port's, train mode, the
    outer residual around both blocks for grad: the output within 2e-2 of
    its largest entry and each input's gradient at a cosine of at least
    0.999 (read: 9.6e-3 and 0.99998 at worst)."""
    from r3d_tpu.models import fuser as jax_fuser
    from r3d_tpu_torch.models import fuser

    jax_cls = {"bn": jax_fuser.CMFuserBN, "grad": jax_fuser.CMFuserGrad}[kind]
    port_cls = {"bn": fuser.CMFuserBN, "grad": fuser.CMFuserGrad}[kind]
    rng = np.random.RandomState(11)
    rgb, dep, w = (rng.randn(2, 24, C).astype(np.float32) for _ in range(3))
    m = jax_cls(C, depth=2, n_head=8, drop_rate=0.0, dtype=jnp.bfloat16)
    variables = jax.device_get(m.init(jax.random.PRNGKey(2), rgb, dep))
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)

    def loss(r, d):
        out, _ = m.apply(variables, r, d, train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        bf(rgb), bf(dep))
    port = port_cls(C, depth=2, drop_rate=0.0)
    port.load_state_dict(state_dict_from_flax(variables))
    r, d = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (rgb, dep))
    got = port.train()(r, d)
    assert got.dtype == torch.bfloat16
    (got.float() * torch.from_numpy(w)).sum().backward()
    b = np.asarray(want, np.float32)
    assert np.abs(got.detach().float().numpy() - b).max() <= OUT_TOL * np.abs(b).max()
    for t, g in zip((r, d), grads):
        a, b = t.grad.float().numpy().ravel(), np.asarray(g, np.float32).ravel()
        assert (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999


def test_bf16_session_matches_jax(monkeypatch):
    """``InferenceSession`` serves ``futr_fusion_bn`` in bf16: against JAX's
    session on the same converted weights and videos (the 64 and 128
    buckets, kernel route), every chunk's outputs within 2e-2 of their
    largest entry (``_run``, recorded on both), the durations within 2e-2.
    A logit a bf16 rounding away from its slot's runner-up decodes to the
    other class, so the transcripts are held to 90 % of the slots (read: 39
    of 40)."""
    from r3d_tpu.serving import InferenceSession as JaxSession
    from r3d_tpu_torch.serving import InferenceSession

    monkeypatch.setenv("R3D_FORCE_PALLAS", "1")
    jcfg, pcfg = (m.get_config("utkinects").replace(
        model=m.ModelConfig(model="futr_fusion_bn", hidden_dim=C, n_head=8, n_query=8,
                            input_dim=12, max_pos_len=128, compute_dtype="bfloat16"),
        data=m.DataConfig(depth_shape=(6, 5), seq_buckets=(64, 128)))
        for m in (jax_config, pt_config))
    variables = jax.device_get(jax.jit(lambda key: jax_build_model(jcfg.model, 17).init(
        key, np.zeros((1, 64, 12), np.float32), np.zeros((1, 64, 6, 5), np.float32), None,
        train=False))(jax.random.PRNGKey(7)))
    rng = np.random.RandomState(8)
    videos = [{"features": rng.randn(n, 12).astype(np.float32),
               "depth": rng.rand(n, 6, 5).astype(np.float32)} for n in (50, 64, 100, 128, 70)]
    sessions = (JaxSession(jcfg, variables, 17, max_batch=4),
                InferenceSession(pcfg, state_dict_from_flax(variables), 17, max_batch=4,
                                 device="cpu"))
    chunks = ([], [])
    for session, seen in zip(sessions, chunks):
        def recorded(*args, run=session._run, seen=seen):
            out = run(*args)
            seen.append({k: v.float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)
                         for k, v in out.items() if k in ("action", "duration")})
            return out
        monkeypatch.setattr(session, "_run", recorded)
    want, got = (s.anticipate_batch(videos, future_len=30) for s in sessions)
    assert len(chunks[0]) == len(chunks[1]) > 0
    for w, g in zip(*chunks):
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= OUT_TOL * max(1.0, np.abs(w[k]).max()), k
    slots = agree = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["durations"], w["durations"], atol=2e-2, rtol=0)
        a, b = np.asarray(g["transcript"]), np.asarray(w["transcript"])
        slots, agree = slots + b.size, agree + int((a == b).sum())
    assert agree >= 0.9 * slots, (agree, slots)
