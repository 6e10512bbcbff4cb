"""The port's losses, effective rank, optimizer, collate and trainer entry
points against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerances: losses
1e-6 relative (fp32, summation order only); effective rank 1e-4 relative
(on random spectra, where eigh's fp32 rounding of the smallest
eigenvalues is magnified by sqrt); AdamW over 30 steps 1e-6 relative to
the parameter scale (optax and torch order the same fp32 operations
differently); the collate array-equal in fp32 and bit-equal in bf16.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import pad_batch as jax_pad_batch
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.losses import classification as jax_cls
from r3d_tpu.losses import duration as jax_dur
from r3d_tpu.ops.effective_rank import effective_rank_loss as jax_erank_loss
from r3d_tpu.train import optim as jax_optim
from r3d_tpu.train.loop import last_non_padding_labels as jax_last_labels
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data.pipeline import pad_batch
from r3d_tpu_torch.data.synthetic import SyntheticSource
from r3d_tpu_torch.losses import classification as pt_cls
from r3d_tpu_torch.losses import duration as pt_dur
from r3d_tpu_torch.ops import effective_rank as pt_erank
from r3d_tpu_torch.train import optim as pt_optim
from r3d_tpu_torch.train.loop import Trainer, last_non_padding_labels
from r3d_tpu_torch.train.state import TrainState

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

PAD = 7


def _labels(rng, shape, n_class=6):
    gold = rng.randint(0, n_class, size=shape)
    gold[rng.rand(*shape) < 0.3] = PAD
    return gold


@pytest.mark.parametrize("excl", [None, 2])
def test_classification_losses_match_jax(excl):
    rng = np.random.RandomState(0 if excl is None else excl)
    logits = rng.randn(40, 9).astype(np.float32)
    logits[3, PAD] = 20.0           # a valid entry argmax-predicted as pad: +2.0
    gold = _labels(rng, (40,))
    gold[3] = 1
    ref, tref = rng.randint(0, 6, 5), rng.randint(0, 6, 5)
    lj, cj = jax_cls.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(gold), PAD, excl)
    lp, cp = pt_cls.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(gold), PAD,
                                       excl)
    assert abs(float(lp) - float(lj)) < 1e-6 * max(1.0, abs(float(lj)))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    lj, cj = jax_cls.weighted_cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(gold), PAD, jnp.asarray(ref), jnp.asarray(tref), excl)
    lp, cp = pt_cls.weighted_cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(gold), PAD, torch.from_numpy(ref),
        torch.from_numpy(tref), excl)
    assert abs(float(lp) - float(lj)) < 1e-6 * max(1.0, abs(float(lj)))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    nj = jax_cls.accuracy_counts(jnp.asarray(logits), jnp.asarray(gold), PAD, excl)
    np_ = pt_cls.accuracy_counts(torch.from_numpy(logits), torch.from_numpy(gold), PAD, excl)
    assert [int(x) for x in np_] == [int(x) for x in nj]


def test_ce_gradient_is_zero_at_masked_entries_and_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(30, 9).astype(np.float32)
    gold = _labels(rng, (30,))
    gj = jax.grad(lambda x: jax_cls.cross_entropy_loss(x, jnp.asarray(gold), PAD, 2)[0])(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    pt_cls.cross_entropy_loss(x, torch.from_numpy(gold), PAD, 2)[0].backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), atol=1e-7, rtol=0)
    assert not x.grad[torch.from_numpy((gold == PAD) | (gold == 2))].any()


def test_duration_loss_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(4, 8).astype(np.float32)
    dur = rng.rand(4, 8).astype(np.float32)
    dur[:, 5:] = PAD
    dur[3] = PAD                    # an all-pad row normalises to zeros, not NaN
    mask = (dur != PAD).astype(np.float32)
    want = jax_dur.duration_loss(jnp.asarray(pred), jnp.asarray(dur * mask), jnp.asarray(mask))
    got = pt_dur.duration_loss(torch.from_numpy(pred), torch.from_numpy(dur * mask),
                               torch.from_numpy(mask))
    assert abs(float(got) - float(want)) < 1e-6
    np.testing.assert_allclose(
        pt_dur.normalize_duration(torch.from_numpy(pred), torch.from_numpy(mask)).numpy(),
        np.asarray(jax_dur.normalize_duration(jnp.asarray(pred), jnp.asarray(mask))),
        atol=1e-7, rtol=0)


def test_last_non_padding_labels_match_jax():
    rng = np.random.RandomState(3)
    past = _labels(rng, (6, 20))
    past[2] = PAD                   # all pad -> pad
    np.testing.assert_array_equal(
        last_non_padding_labels(torch.from_numpy(past), PAD).numpy(),
        np.asarray(jax_last_labels(jnp.asarray(past), PAD)))


@pytest.mark.parametrize("case", ["random", "low-rank", "degenerate", "masked-batched"])
def test_effective_rank_and_gradient_match_jax(case):
    """Values and gradients of the loss, including the all-equal spectrum
    of tests/test_effective_rank.py, where the eigenvalue-only backward must
    stay finite. On a low-rank matrix the zero eigenvalues come out of eigh
    as fp32 noise of either sign, and d sigma / d lambda = 1 / (2 sigma)
    magnifies that noise without bound, so there only the value (to 1e-3:
    each noise eigenvalue of ~1e-6 adds a sigma of ~1e-3) and the finiteness
    of the gradient are compared."""
    rng = np.random.RandomState(4)
    mask = None
    if case == "random":
        x = rng.randn(50, 16).astype(np.float32)
    elif case == "low-rank":
        x = (rng.randn(50, 3) @ rng.randn(3, 16)).astype(np.float32)
    elif case == "degenerate":
        x = np.eye(8, dtype=np.float32)
    else:
        x = rng.randn(3, 40, 16).astype(np.float32)
        mask = (rng.rand(3, 40) < 0.7).astype(np.float32)
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.from_numpy(a)
    for target in (None, 4.0):
        vj, gj = jax.value_and_grad(
            lambda a: jax_erank_loss(a, J(mask), target))(jnp.asarray(x))
        xt = T(x).clone().requires_grad_()
        vp = pt_erank.effective_rank_loss(xt, T(mask), target)
        vp.backward()
        rel = 1e-3 if case == "low-rank" else 1e-4
        assert abs(float(vp) - float(vj)) <= rel * max(1.0, abs(float(vj)))
        assert torch.isfinite(xt.grad).all()
        if case == "low-rank":
            continue
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(gj).max())))


def test_schedule_and_adamw_match_optax_over_30_steps():
    """The pl_bolts schedule (epoch 0 at lr 0, warmup, cosine) and AdamW
    with weight decay on every parameter, fed the same gradients (one of
    them always zero, which optax still decays)."""
    tc = jax_config.TrainConfig(lr=1e-2, warmup_epochs=3, epochs=8, weight_decay=5e-3)
    spe = 4
    js = jax_optim.linear_warmup_cosine_schedule(tc.lr, tc.warmup_epochs, tc.epochs, spe)
    ps = pt_optim.linear_warmup_cosine_schedule(tc.lr, tc.warmup_epochs, tc.epochs, spe)
    for t in range(40):
        assert abs(ps(t) - float(js(t))) <= 1e-9 + 1e-6 * tc.lr, t
    assert ps(0) == ps(spe - 1) == 0.0
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(6, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32),
              "z": rng.randn(3).astype(np.float32)}
    tx = jax_optim.make_optimizer(tc, spe)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    pt_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    ptc = pt_config.TrainConfig(lr=1e-2, warmup_epochs=3, epochs=8, weight_decay=5e-3)
    opt, schedule = pt_optim.make_optimizer(ptc, pt_params.values(), spe)
    state = TrainState(torch.nn.Module(), opt, schedule)
    for _ in range(30):
        grads = {k: (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
        grads["z"][:] = 0.0
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in pt_params.items():
            p.grad = None if k == "z" else torch.from_numpy(grads[k])
        state.apply_gradients()
    assert state.step == 30
    for k, p in pt_params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0,
                                   err_msg=k)
    assert not np.allclose(np.asarray(jp["z"]), params["z"])   # decayed, not skipped


@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16"])
def test_pad_batch_matches_jax(feature_dtype):
    """Array-equal in fp32; in bf16 the storage is bit-equal to JAX's
    ``jnp.bfloat16`` cast (round to nearest even)."""
    kw = dict(n_videos=3, n_actions=4, vid_len_range=(40, 200), input_dim=10,
              depth_shape=(3, 4), seed=6)
    jsrc, psrc = JaxSource(**kw), SyntheticSource(**kw)
    jfn, n = jsrc.make_example_fn((0.3, 0.9), 1, 8)
    pfn, _ = psrc.make_example_fn((0.3, 0.9), 1, 8)
    want = jax_pad_batch([jfn(i) for i in range(n)], jsrc.pad_idx, (64, 128), 8,
                         with_depth=True, feature_dtype=feature_dtype)
    got = pad_batch([pfn(i) for i in range(n)], psrc.pad_idx, (64, 128), 8, with_depth=True,
                    feature_dtype=feature_dtype)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k]
        if feature_dtype == "bfloat16" and k in ("features", "depth_features"):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16), k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, k)


def test_convert_maps_a_gradient_pytree():
    """``state_dict_from_flax({"params": grads})`` names and lays out a JAX
    gradient pytree as the port's parameters (Dense kernels transposed)."""
    grads = {"fuser": {"safuser": {"block0": {"mlp1_kernel": np.arange(6.0).reshape(2, 3)}}},
             "transformer": {"decoder": {"layer0": {"cross_attn": {"q_proj": {
                 "kernel": np.ones((2, 2)), "bias": np.zeros(2)}}}}}}
    sd = state_dict_from_flax({"params": grads})
    np.testing.assert_array_equal(sd["fuser.safuser.block0.mlp1.weight"].numpy(),
                                  np.arange(6.0).reshape(2, 3).T)
    assert "transformer.decoder.layers.0.cross_attn.q_proj.weight" in sd


def _small_config(**train_kw):
    cfg = pt_config.get_config("synthetic")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_dim=32, n_head=4, input_dim=12),
        data=dataclasses.replace(cfg.data, depth_shape=(6, 5)),
        train=dataclasses.replace(cfg.train, **train_kw))


def test_trainer_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_small_config(), 6)


@pytest.mark.parametrize("kw,item", [({"rng_impl": "philox"}, "rng_impl")])
def test_trainer_refuses_what_is_not_ported(kw, item):
    """An ``rng_impl`` other than None, "threefry2x32" and "rbg" raises
    ``ValueError`` at construction ("rbg" once raised here and now runs,
    ``tests/test_torch_rng_impl.py``)."""
    with pytest.raises(ValueError, match=item):
        Trainer(_small_config(**kw), 6, device="cpu")


def test_trainer_refuses_accumulation_with_multi_step_dispatch():
    """``grad_accum`` and ``steps_per_dispatch`` exclude each other, as in
    JAX's ``fit`` (``r3d_tpu/train/loop.py:868-876``)."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(_small_config(grad_accum=2, steps_per_dispatch=2), 6, device="cpu")


def test_fit_skips_small_batches_and_refuses_a_checkpointer():
    """The BN batch guard: batches under ``min_train_batch`` do not train.
    A checkpointer, which ``fit`` refused before the port had checkpoints,
    is now taken: the open gate saves the best, every epoch the last."""
    src = SyntheticSource(n_videos=3, n_actions=5, vid_len_range=(60, 90), input_dim=12,
                          depth_shape=(6, 5), seed=0)
    fn, n = src.make_example_fn((0.3, 0.5), 1, 8)
    batches = [pad_batch([fn(i) for i in range(j, min(j + 4, n))], src.pad_idx, (64, 128), 8,
                         True) for j in range(0, n, 4)]
    trainer = Trainer(_small_config(min_train_batch=4, epochs=1), src.n_class, device="cpu")
    state = trainer.init_state(len(batches))
    lines = []
    trainer.fit(state, batches, batches[:1], seed=0, log=lines.append)
    assert state.step == sum(b["features"].shape[0] >= 4 for b in batches) < len(batches)
    assert lines[0].startswith("Epoch [1/1] Loss : ") and lines[1].startswith("Validation Loss:")
    calls = []

    class Recorder:
        def save_best(self, state, seed, epoch):
            calls.append(("best", seed, epoch))

        def save_last(self, state, seed):
            calls.append(("last", seed))

    lines = []
    trainer.fit(state, batches, batches[:1], seed=3, log=lines.append, checkpointer=Recorder())
    assert calls == [("best", 3, 0), ("last", 3)]
    assert lines[2].startswith("Best model saved (val acc ")
