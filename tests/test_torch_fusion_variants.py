"""The fuser ablations of the port against the JAX package's, on the CPU:
``futr_fusion_grad``, ``futr_fusion_vary``, ``futr_fusion_nox``, ``afft``,
and ``fuser_depth = 2`` for every fuser.

Each flax module is initialised from a seed and carried across with
``convert.state_dict_from_flax`` (``load_state_dict`` is strict, so the
names match one to one); both run on the same numpy inputs with dropout 0.
JAX's fuser runs composed and, at depth 1, on its Pallas kernels in
interpret mode (``R3D_FORCE_PALLAS=1``, the forward kernel and its Pallas
backward), as its own tests run them; the port's wrappers take their plain
versions on the CPU. Tolerances: outputs and input gradients 2e-5, each
parameter's gradient 1e-5 of its largest entry (fp32; summation order
only), as ``tests/test_torch_models.py`` holds ``CMFuserBN``; a train step's
loss 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.models import fuser as jax_fuser
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data.pipeline import BucketedLoader
from r3d_tpu_torch.models import build_model, fuser, init_weights
from r3d_tpu_torch.train.loop import Trainer
from test_torch_models import _grads_close, _np, _port, _randomize_bn, _t
from test_torch_train import _loaders, _sources

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

VARIANTS = ("futr_fusion_grad", "futr_fusion_vary", "futr_fusion_nox", "afft")
JAX_FUSERS = {"bn": jax_fuser.CMFuserBN, "grad": jax_fuser.CMFuserGrad,
              "vary": jax_fuser.CMFuserVary, "nox": jax_fuser.CMFuserNoExchange}
PT_FUSERS = {"bn": fuser.CMFuserBN, "grad": fuser.CMFuserGrad, "vary": fuser.CMFuserVary,
             "nox": fuser.CMFuserNoExchange}
ATOL = 2e-5


def _streams(seed, C, B=3, T=20):
    rng = np.random.RandomState(seed)
    f = lambda: rng.randn(B, T, C).astype(np.float32)
    return rng, f(), f(), f()


def _fuser_case(kind, C, depth, seed, mode):
    """(flax module, variables, port module) of fuser ``kind`` in ``mode``
    ("train" or "eval"), dropout 0, the weights spread off their init."""
    _, rgb, dep, _ = _streams(seed, C)
    m = JAX_FUSERS[kind](C, depth=depth, n_head=8, drop_rate=0.0)
    variables = jax.device_get(m.init(jax.random.PRNGKey(seed), rgb, dep))
    rng = np.random.RandomState(seed + 1)
    if kind == "bn":
        variables = _randomize_bn(variables, rng, C)
    elif kind == "vary":
        variables["params"]["alpha"] = (rng.rand(1, 1, C) + 0.5).astype(np.float32)
    port = PT_FUSERS[kind](C, depth=depth, drop_rate=0.0)
    port.load_state_dict(state_dict_from_flax(variables))
    return m, variables, port.train(mode == "train")


def _fuser_matches(kind, C, depth, seed, mode):
    """Output, every parameter's gradient and both inputs' gradients of a
    weighted sum of the output, and the BN statistics where there are any."""
    _, rgb, dep, w = _streams(seed, C)
    m, variables, port = _fuser_case(kind, C, depth, seed, mode)
    train = mode == "train"

    def loss(params, r, d):
        v = dict(variables, params=params)
        out, mut = m.apply(v, r, d, train=train, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut)

    (_, (want, mutated)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], rgb, dep)
    r, d = _t(rgb).requires_grad_(), _t(dep).requires_grad_()
    got = port(r, d)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=ATOL, rtol=0)
    _grads_close(port, grads[0])
    for a, b in ((r, grads[1]), (d, grads[2])):
        np.testing.assert_allclose(a.grad.numpy(), _np(b), atol=ATOL, rtol=0)
    if "batch_stats" in mutated:
        want_sd = state_dict_from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])})
        got_sd = port.state_dict()
        for name, t in want_sd.items():
            np.testing.assert_allclose(got_sd[name].numpy(), t.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("jax_path", ["composed", "pallas-interpret"])
@pytest.mark.parametrize("kind", ["grad", "vary", "nox"])
def test_fuser_variant_matches_flax(kind, jax_path, mode, monkeypatch):
    """Depth 1: JAX's composed block or its Pallas tail (K1 forward with the
    outer residual for grad, off for vary and nox; the Pallas K2 backward)
    against the port's no-blend route, whose plain version runs here."""
    if jax_path == "pallas-interpret":
        monkeypatch.setenv("R3D_FORCE_PALLAS", "1")
    _fuser_matches(kind, 32, 1, {"grad": 1, "vary": 2, "nox": 3}[kind], mode)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("kind", ["bn", "grad", "vary", "nox"])
def test_fuser_depth_2_matches_flax(kind, mode):
    """``fuser_depth = 2``: JAX's composed stack (``block0``, ``block1``,
    the outer residual around both for grad, then LN and the modality
    mean), no kernel on either side."""
    _fuser_matches(kind, 32, 2, {"bn": 4, "grad": 5, "vary": 6, "nox": 7}[kind], mode)


def _jax_masks(kind, rgb, dep, train):
    """The channels JAX's fuser exchanges, by its own scoring
    (``r3d_tpu/models/fuser.py:367-379, 412-416``)."""
    C = rgb.shape[-1]
    if kind == "grad" and train:
        g_r, g_d = jax.grad(lambda r, d: jnp.mean(r) + jnp.mean(d), argnums=(0, 1))(rgb, dep)
        s_r, s_d = jnp.mean(jnp.abs(g_r), axis=(0, 1)), jnp.mean(jnp.abs(g_d), axis=(0, 1))
    else:
        s_r, s_d = jnp.mean(jnp.abs(rgb), axis=(0, 1)), jnp.mean(jnp.abs(dep), axis=(0, 1))
    return (np.asarray(jax_fuser.bottomk_mask(s_r, C // 4)),
            np.asarray(jax_fuser.bottomk_mask(s_d, C // 4)))


@pytest.mark.parametrize("C", [32, 128])
@pytest.mark.parametrize("kind", ["grad", "vary"])
def test_exchange_masks_match_jax(kind, C):
    """grad: train mode swaps the first quarter, JAX's probe ranking; eval
    mode ranks by mean |activation|, as JAX does, and picks other channels
    on these streams. vary: mean |activation| in both modes."""
    _, rgb, dep, _ = _streams(C, C)
    m = fuser.CMFuserGrad(C) if kind == "grad" else fuser.CMFuserVary(C)
    for train in (True, False):
        got = m.train(train).masks(_t(rgb), _t(dep))
        want = _jax_masks(kind, rgb, dep, train)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
            assert int(g.sum()) == C // 4
        if kind == "grad" and train:
            assert all(g.numpy().tolist() == [i < C // 4 for i in range(C)] for g in got)
        if kind == "grad" and not train:
            assert not got[0][:C // 4].all()


def test_grad_sticky_flag_follows_the_mode():
    """``mark_sticky`` lets an eval-mode ``CMFuserGrad`` rank by the probe;
    ``train()`` and ``eval()`` clear it."""
    C = 32
    _, rgb, dep, _ = _streams(0, C)
    model = build_model(_cfgs("futr_fusion_grad")[1], 17, (6, 5)).eval()
    first = torch.arange(C) < C // 4
    fz = model.fuser
    assert not torch.equal(fz.masks(_t(rgb), _t(dep))[0], first)
    fuser.mark_sticky(model)
    assert torch.equal(fz.masks(_t(rgb), _t(dep))[0], first) and not fz.training
    model.eval()
    assert not fz.sticky
    fuser.mark_sticky(model)
    model.train()
    assert not fz.sticky and fz.training


# ---- the whole models ----

def _cfgs(model, **kw):
    base = dict(model=model, hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                max_pos_len=512, dropout=0.0, fuser_dropout=0.0)
    base.update(kw)
    return jax_config.ModelConfig(**base), pt_config.ModelConfig(**base)


def _model_case(model, S, seed, **kw):
    jcfg, pcfg = _cfgs(model, **kw)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, S, 12).astype(np.float32)
    d = rng.rand(2, S, 6, 5).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, S // 3:] = True
    m = jax_build_model(jcfg, 17)
    variables = jax.device_get(m.init(jax.random.PRNGKey(seed), x, d, pad, train=False))
    if model == "futr_fusion_bn":
        variables = _randomize_bn(variables, rng, 32, at=("fuser",))
    shapes = {"action": (2, 8, 17), "duration": (2, 8), "seg": (2, S, 17),
              "fused": (2, S, 32)}
    return jcfg, pcfg, m, variables, rng, x, d, pad, shapes


@pytest.mark.parametrize("model", VARIANTS)
def test_variant_outputs_match_flax(model):
    """Each variant's eval forward at S = 24: the output keys (``afft``:
    ``action`` and ``duration`` only, no ``seg`` and no ``fused``, so no
    erank term) and values against JAX's. Train-mode outputs and gradients
    are held through the trainer's step below."""
    jcfg, pcfg, m, variables, rng, x, d, pad, _ = _model_case(model, 24, 30)
    want = m.apply(variables, x, d, pad, train=False)
    got = _port(build_model(pcfg, 17, (6, 5)), variables)(_t(x), _t(d), _t(pad))
    keys = ["action", "duration"] if model == "afft" else ["action", "duration", "fused", "seg"]
    assert sorted(got) == sorted(want) == keys
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_fuser_depth_2_model_matches_flax():
    """``fuser_depth = 2`` in the whole ``futr_fusion_bn`` model, train
    mode: outputs and every gradient (``safuser.block1`` carried across;
    the other fusers' depth-2 stacks are held above)."""
    S = 64
    jcfg, pcfg, m, variables, rng, x, d, pad, shapes = _model_case("futr_fusion_bn", S, 20,
                                                                    fuser_depth=2)
    assert "block1" in variables["params"]["fuser"]["safuser"]
    weights = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def loss(params):
        out, _ = m.apply(dict(variables, params=params), x, d, pad, train=True,
                         mutable=["batch_stats"])
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    port = _port(build_model(pcfg, 17, (6, 5)), variables).train()
    got = port(_t(x), _t(d), _t(pad))
    sum((got[k] * _t(weights[k])).sum() for k in weights).backward()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), _np(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)
    _grads_close(port, grads, model_wide=True)


@torch.no_grad()
@pytest.mark.parametrize("model", VARIANTS)
def test_init_weights_draws_the_variants_distributions(model):
    """vary's alpha at ones, the modality token ~ N(0, 1), afft's ``fc`` and
    ``fc_len`` xavier-uniform with zero biases and no transformer; the
    parameter names and shapes are the flax init's."""
    jcfg, pcfg = _cfgs(model)
    port = init_weights(build_model(pcfg, 17, (6, 5)), torch.Generator().manual_seed(0))
    x = np.zeros((1, 64, 12), np.float32)
    flax_sd = state_dict_from_flax(jax.device_get(jax_build_model(jcfg, 17).init(
        jax.random.PRNGKey(0), x, np.zeros((1, 64, 6, 5), np.float32), None, train=False)))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in flax_sd.items()}
    fz = port.fuser
    if model == "futr_fusion_vary":
        assert fz.alpha.eq(1).all()
    if model in ("futr_fusion_nox", "afft"):
        tok = fz.modality_token.flatten()
        assert tok.shape == (32,) and abs(float(tok.std()) - 1.0) < 0.4 and tok.abs().max() > 0
    if model == "afft":
        assert not hasattr(port, "transformer") and not hasattr(port, "query_embed")
        for lin, fan_out in ((port.fc, 17), (port.fc_len, 1)):
            bound = np.sqrt(6 / (32 + fan_out))
            assert 0.5 * bound < lin.weight.abs().max() <= bound and lin.bias.eq(0).all()
    again = init_weights(build_model(pcfg, 17, (6, 5)), torch.Generator().manual_seed(0))
    for a, b in zip(port.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


# ---- one train step of the trainer, epoch 0 and sticky ----

@pytest.mark.parametrize("model", VARIANTS)
def test_train_step_matches_jax(model):
    """The port's ``Trainer`` step against JAX's ``_grad_core`` from the
    same weights and batch, in epoch 0 (train mode) and epoch 1, the sticky
    epoch, against JAX's frozen twin (``train=True``, dropout 0): the loss,
    the counts and every gradient. For grad the sticky step ranks by the
    probe, as the twin does; the module-eval ranking would swap other
    channels and read another loss."""
    base = dict(model=model, hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                max_pos_len=128, dropout=0.0, fuser_dropout=0.0)
    data = dict(dataset="synthetic", gt_format="plain", seq_buckets=(64, 128),
                train_obs_percs=(0.2, 0.3, 0.5), depth_shape=(6, 5))
    train = dict(loop="proposed_depth", batch_size=4, epochs=2, warmup_epochs=1, lr=1e-3,
                 min_train_batch=0, weighted_ce=True, exclude_class_idx=4)
    jcfg, pcfg = (m.get_config("synthetic").replace(
        model=m.ModelConfig(**base), data=m.DataConfig(**data),
        train=m.TrainConfig(**train)) for m in (jax_config, pt_config))
    jsrc, psrc = _sources()
    batch_j = next(iter(_loaders(jsrc, JaxLoader, False)))
    batch_p = next(iter(_loaders(psrc, BucketedLoader, False)))
    jtrainer = JaxTrainer(jcfg, jsrc.n_class)
    S = batch_j["features"].shape[1]
    variables = jax.device_get(jax_build_model(jcfg.model, jsrc.n_class).init(
        jax.random.PRNGKey(3), batch_j["features"], batch_j["depth_features"], None,
        train=False))
    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    losses = {}
    for epoch in (0, 1):
        fz = jtrainer._sticky(epoch)
        grads_j, metrics_j, _ = jax.jit(lambda p, b, e=epoch, fz=fz: jtrainer._grad_core(
            p, variables.get("batch_stats", {}), b, jax.random.PRNGKey(0), e, frozen=fz))(
            variables["params"], jax.tree.map(np.asarray, batch_j))
        state = trainer.init_state(4, state_dict_from_flax(variables))
        trainer._train_mode(state.model, epoch)
        assert state.model.training == (epoch == 0)
        metrics_p = trainer._grad_core(state.model, trainer.to_device(batch_p), epoch)
        losses[epoch] = float(metrics_p["loss"])
        assert abs(losses[epoch] - float(metrics_j["loss"])) < 1e-5, (epoch, S)
        for k in ("cls_correct", "cls_total"):
            assert int(metrics_p[k]) == int(metrics_j[k]), k
        _grads_close(state.model, grads_j)
    if model == "futr_fusion_grad":
        state = trainer.init_state(4, state_dict_from_flax(variables))
        state.model.eval()   # the module-eval ranking, not the twin's
        other = float(trainer._grad_core(state.model, trainer.to_device(batch_p), 1)["loss"])
        assert abs(other - losses[1]) > 1e-4


@pytest.mark.parametrize("model", VARIANTS)
def test_variant_session_matches_jax(model):
    """The ``InferenceSession`` of each variant against JAX's on the same
    converted weights and videos (the 64 and 128 buckets): decoded results
    equal, durations within 1e-4; ``afft`` has no seg head, so every
    request's ``seg`` is None on both sides."""
    from r3d_tpu.serving import InferenceSession as JaxSession
    from r3d_tpu_torch.serving import InferenceSession

    jcfg, pcfg = (m.get_config("utkinects").replace(
        model=m.ModelConfig(model=model, hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                            max_pos_len=128),
        data=m.DataConfig(depth_shape=(6, 5), seq_buckets=(64, 128)))
        for m in (jax_config, pt_config))
    variables = jax.device_get(jax_build_model(jcfg.model, 17).init(
        jax.random.PRNGKey(7), np.zeros((1, 64, 12), np.float32),
        np.zeros((1, 64, 6, 5), np.float32), None, train=False))
    rng = np.random.RandomState(8)
    videos = [{"features": rng.randn(n, 12).astype(np.float32),
               "depth": rng.rand(n, 6, 5).astype(np.float32)} for n in (50, 64, 100, 128, 70)]
    want = JaxSession(jcfg, variables, 17, max_batch=4).anticipate_batch(videos, future_len=30)
    got = InferenceSession(pcfg, state_dict_from_flax(variables), 17, max_batch=4,
                           device="cpu").anticipate_batch(videos, future_len=30)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("transcript", "future_frames"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"video {i} {key}")
        if model == "afft":
            assert g["seg"] is None and w["seg"] is None
        else:
            np.testing.assert_array_equal(g["seg"], w["seg"], err_msg=f"video {i} seg")
        np.testing.assert_allclose(g["durations"], w["durations"], atol=1e-4, rtol=0)
