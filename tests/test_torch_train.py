"""The port's training slice against the JAX package's, on the CPU.

Both frameworks start from the JAX init (carried across with
``convert.state_dict_from_flax``), see the same synthetic batches (each
package's own ``SyntheticSource`` and ``BucketedLoader`` from the same
seeds) and run with dropout 0 and fuser dropout 0: flax and torch draw
different dropout streams, so dropout is checked by its invariants
(``tests/test_torch_kernels.py``). Tolerances:

- one train step: loss 1e-5, gradients 1e-5 relative to each tensor's
  largest entry, BN statistics 1e-6 (fp32, summation order only); updated
  parameters 1e-6 on 99 % of each tensor's entries and 2 lr on all (see
  ``_assert_state_close``: Adam amplifies the rounding of near-zero
  gradients);
- a 2-epoch fit: per-step losses and validation metrics 1e-4, final
  parameters and BN statistics 1e-4 on 99 % of the entries and 2 lr per
  update on all;
- metrics that count (correct predictions, gate decisions) equal.

The ``futr`` loop (the 50salads model and loop at reduced width: features
only, unweighted CE with no exclude class, the single-metric gate) runs the
same 2-epoch comparison in fp32, and one bf16 train step is held to stated
bounds (``test_futr_bf16_step_matches_jax``).
"""

import re

import numpy as np
import pytest
import torch

import jax
import optax

from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.data.pipeline import pad_batch as jax_pad_batch
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data.pipeline import BucketedLoader
from r3d_tpu_torch.data.synthetic import SyntheticSource
from r3d_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

OBS = (0.2, 0.3, 0.5)


def _configs(**train_kw):
    model = dict(model="futr_fusion_bn", hidden_dim=32, n_head=4, n_query=8, input_dim=12,
                 max_pos_len=128, dropout=0.0, fuser_dropout=0.0)
    data = dict(dataset="synthetic", gt_format="plain", seq_buckets=(64, 128),
                train_obs_percs=OBS, depth_shape=(6, 5))
    train = dict(loop="proposed_depth", batch_size=4, epochs=2, warmup_epochs=1, lr=1e-3,
                 min_train_batch=0, weighted_ce=True, exclude_class_idx=4, **train_kw)
    make = lambda m: m.get_config("synthetic").replace(
        model=m.ModelConfig(**model), data=m.DataConfig(**data), train=m.TrainConfig(**train))
    return make(jax_config), make(pt_config)


def _sources():
    kw = dict(n_videos=6, n_actions=5, vid_len_range=(60, 120), input_dim=12,
              depth_shape=(6, 5), seed=0)
    return JaxSource(**kw), SyntheticSource(**kw)


def _loaders(src, Loader, shuffle, seed=0):
    fn, n = src.make_example_fn(OBS, 1, 8)
    return Loader(num_examples=n, make_example_fn=fn, batch_size=4, pad_idx=src.pad_idx,
                  buckets=(64, 128), n_query=8, with_depth=True, shuffle=shuffle, seed=seed)


def _jax_init(jcfg, jsrc):
    trainer = JaxTrainer(jcfg, jsrc.n_class)
    fn, _ = jsrc.make_example_fn(OBS, 1, 8)
    example = jax_pad_batch([fn(i) for i in range(4)], jsrc.pad_idx, (64, 128), 8,
                            with_depth=True)
    train = _loaders(jsrc, JaxLoader, True)
    state = trainer.init_state(jax.random.PRNGKey(0), example, steps_per_epoch=len(train))
    # The bottom-k channel mask is a step function of |gamma|. At the flax
    # init every gamma is 1, so after one update the order of the tied
    # gammas is decided by rounding and the two frameworks pick different
    # channels. Gammas spread 0.1 apart keep the choice stable for far more
    # updates than the fit takes (each moves a gamma by at most ~lr).
    params = jax.device_get(state.params)
    rng = np.random.RandomState(7)
    for name in ("bn_rgb", "bn_depth"):
        params["fuser"][name]["scale"] = rng.permutation(0.2 + 0.1 * np.arange(32)).astype(
            np.float32)
    return trainer, state.replace(params=params), len(train)


def _variables(state):
    return jax.device_get({"params": state.params, "batch_stats": state.batch_stats})


# Adam's first updates are lr * g / (|g| + 1e-8) per entry, so an entry whose
# gradient is within a few 1e-8 of 0 turns a rounding difference of g into a
# step difference of up to lr. Some biases have a gradient of exactly 0 in
# exact arithmetic, so all their entries are such: the duration head's (the
# L1-normalised duration is invariant under it) and every attention key
# projection's (it shifts all of a query's scores alike). The state check
# therefore holds every entry to ``step_atol`` (2 lr per update) and all but
# 1 % of the entries of every other tensor to ``atol``.
def _noise_only(name):
    return name == "heads.fc_len.bias" or name.endswith("k_proj.bias")


def _assert_state_close(model, jstate, atol, step_atol):
    want = state_dict_from_flax(_variables(jstate))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        diff = np.abs(got[k].numpy() - want[k].numpy())
        assert diff.max() <= step_atol, (k, diff.max())
        if not _noise_only(k):
            assert np.mean(diff > atol) <= 0.01, (k, np.sort(diff.ravel())[-5:])


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = _configs()
    jsrc, psrc = _sources()
    jtrainer, jstate, steps = _jax_init(jcfg, jsrc)
    return jcfg, pcfg, jsrc, psrc, jtrainer, jstate, steps


def test_one_train_step_matches_jax(setup):
    """Epoch 0 (train mode) and epoch 1 (sticky): loss, counts, every
    gradient and the BN statistics from the same weights and batch; then one
    full update in epoch 1 (lr 1e-3)."""
    jcfg, pcfg, jsrc, psrc, jtrainer, jstate, steps = setup
    batch_j = next(iter(_loaders(jsrc, JaxLoader, False)))
    batch_p = next(iter(_loaders(psrc, BucketedLoader, False)))
    for k in batch_j:
        np.testing.assert_array_equal(batch_p[k].numpy(), batch_j[k])
    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    for epoch in (0, 1):
        # fresh weights each time: the port's train-mode forward updates the
        # BN running statistics in place, JAX's returns them
        state = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
        fz = jtrainer._sticky(epoch)
        grad_core = jax.jit(lambda p, bs, b, e=epoch, fz=fz: jtrainer._grad_core(
            p, bs, b, jax.random.PRNGKey(0), e, frozen=fz))
        grads_j, metrics_j, stats_j = grad_core(jstate.params, jstate.batch_stats,
                                                jax.tree.map(np.asarray, batch_j))
        state.model.train(not trainer._sticky(epoch))
        state.model.zero_grad()
        metrics_p = trainer._grad_core(state.model, trainer.to_device(batch_p))
        assert abs(float(metrics_p["loss"]) - float(metrics_j["loss"])) < 1e-5
        for k in ("cls_correct", "cls_total", "seg_correct", "seg_total"):
            assert int(metrics_p[k]) == int(metrics_j[k]), k
        want = state_dict_from_flax({"params": jax.device_get(grads_j)})
        for name, p in state.model.named_parameters():
            w = want[name].numpy()
            err = np.abs(p.grad.numpy() - w).max()
            assert err <= 1e-5 * max(1.0, np.abs(w).max()), (epoch, name, err)
        want = state_dict_from_flax({"batch_stats": jax.device_get(stats_j)})
        got = state.model.state_dict()
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-6,
                                       rtol=0, err_msg=name)
    # one full update in epoch 1 against JAX's apply_gradients
    fresh = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    fresh.step = steps
    # optax's schedule reads its own count; Adam's stays at its first update
    sched = lambda x: isinstance(x, optax.ScaleByScheduleState)
    jstep = jax.tree.map(np.array, jstate)   # a copy: the JAX step donates its state
    jstep = jstep.replace(opt_state=jax.tree.map(
        lambda x: x._replace(count=x.count + steps) if sched(x) else x,
        jstep.opt_state, is_leaf=sched))
    jnew, _ = jtrainer.make_train_step(frozen=True)(
        jstep, jax.tree.map(np.asarray, batch_j), jax.random.PRNGKey(0), 1)
    trainer.train_step(fresh, batch_p, 1)
    _assert_state_close(fresh.model, jnew, 1e-6, step_atol=2e-3)


class _Gates:
    """Records the JAX fit's best-gate decisions."""

    def __init__(self):
        self.best = []

    def save_best(self, state, seed, epoch):
        self.best.append(epoch)

    def save_last(self, state, seed):
        pass


def _numbers(lines):
    """The numbers of the log lines, without the clips/s rate."""
    out = []
    for line in lines:
        line = re.sub(r"\([0-9.]+ clips/s\)", "", line)
        out.append([float(x) for x in re.findall(r"-?\d+\.\d+", line)])
    return out


def test_fit_matches_jax(setup):
    """A 2-epoch fit from the JAX init: the sticky twin engages at epoch 1;
    per-step losses (both frameworks' train steps recorded as fit calls
    them), validation metrics, gate decisions and the final params and
    batch_stats agree."""
    jcfg, pcfg, jsrc, psrc, jtrainer, jstate, steps = setup
    assert [jtrainer._sticky(e) for e in (0, 1)] == [False, True]
    jlosses, plosses, modes = [], [], []
    make_step = jtrainer.make_train_step

    def recording_make_step(frozen=False):
        step = make_step(frozen=frozen)

        def recorded(state, batch, rng, epoch):
            state, metrics = step(state, batch, rng, epoch)
            jlosses.append(float(metrics["loss"]))
            return state, metrics

        return recorded

    jtrainer.make_train_step = recording_make_step
    jlog, gates = [], _Gates()
    try:
        jfinal = jtrainer.fit(jax.tree.map(np.array, jstate),  # a copy: fit donates it
                              _loaders(jsrc, JaxLoader, True, seed=3),
                              _loaders(jsrc, JaxLoader, False), seed=0, checkpointer=gates,
                              log=jlog.append)
    finally:
        jtrainer.make_train_step = make_step

    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    train_step = trainer.train_step

    def recorded(state, batch, epoch):
        metrics = train_step(state, batch, epoch)
        plosses.append(float(metrics["loss"]))
        modes.append(state.model.training)
        return metrics

    trainer.train_step = recorded
    pstate = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    plog = []
    trainer.fit(pstate, _loaders(psrc, BucketedLoader, True, seed=3),
                _loaders(psrc, BucketedLoader, False), seed=0, log=plog.append)
    assert modes == [True] * steps + [False] * steps   # the sticky twin from epoch 1
    np.testing.assert_allclose(plosses, jlosses, atol=1e-4, rtol=0)
    jlog = [line for line in jlog if not line.startswith("Best model")]
    assert [line.split(":")[0] for line in plog] == [line.split(":")[0] for line in jlog]
    for a, b in zip(_numbers(plog), _numbers(jlog)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)  # printed to 3 decimals
    assert trainer.best_epochs == gates.best
    assert pstate.step == 2 * steps
    _assert_state_close(pstate.model, jfinal, 1e-4, step_atol=2e-3 * steps)


def test_eval_step_matches_jax(setup):
    jcfg, pcfg, jsrc, psrc, jtrainer, jstate, steps = setup
    batch_j = next(iter(_loaders(jsrc, JaxLoader, False)))
    batch_p = next(iter(_loaders(psrc, BucketedLoader, False)))
    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    state = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    want = jtrainer.make_eval_step()(jstate, jax.tree.map(np.asarray, batch_j))
    got = trainer.make_eval_step()(state, batch_p)
    assert sorted(got) == sorted(want)
    for k in want:
        # erank: the Gram matrix's smallest eigenvalues sit at its fp32
        # rounding floor, and sigma = sqrt(lambda) magnifies them
        rtol = 1e-3 if k == "erank" else 1e-5
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-4, rtol=rtol,
                                   err_msg=k)


# ---- the futr loop: the 50salads layout (features only) ----

def _futr_configs(dtype="float32"):
    model = dict(model="futr", hidden_dim=32, n_head=4, n_query=20, input_dim=12,
                 n_decoder_layers=2, max_pos_len=128, seg_excludes_none=True, dropout=0.0,
                 compute_dtype=dtype)
    data = dict(dataset="50salads", depth_features_dir=None, gt_format="plain",
                seq_buckets=(64, 128), train_obs_percs=OBS,
                feature_dtype="bfloat16" if dtype == "bfloat16" else "float32")
    train = dict(loop="futr", batch_size=4, epochs=2, warmup_epochs=1, lr=1e-3,
                 min_train_batch=0)
    make = lambda m: m.get_config("50salads").replace(
        model=m.ModelConfig(**model), data=m.DataConfig(**data), train=m.TrainConfig(**train))
    return make(jax_config), make(pt_config)


def _futr_setup(dtype="float32"):
    jcfg, pcfg = _futr_configs(dtype)
    kw = dict(n_videos=6, n_actions=19, vid_len_range=(60, 120), input_dim=12, seed=1)
    jsrc, psrc = JaxSource(**kw), SyntheticSource(**kw)
    fd = pcfg.data.feature_dtype

    def loaders(src, Loader, shuffle, seed=0):
        fn, n = src.make_example_fn(OBS, 1, 20)
        extra = {} if Loader is JaxLoader else {"feature_dtype": fd}
        return Loader(num_examples=n, make_example_fn=fn, batch_size=4, pad_idx=src.pad_idx,
                      buckets=(64, 128), n_query=20, with_depth=False, shuffle=shuffle,
                      seed=seed, **extra)

    jtrainer = JaxTrainer(jcfg, jsrc.n_class)
    fn, _ = jsrc.make_example_fn(OBS, 1, 20)
    example = jax_pad_batch([fn(i) for i in range(4)], jsrc.pad_idx, (64, 128), 20)
    steps = len(loaders(jsrc, JaxLoader, True))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), example, steps_per_epoch=steps)
    return jcfg, pcfg, jsrc, psrc, jtrainer, jstate, steps, loaders


def test_futr_fit_matches_jax():
    """A 2-epoch ``futr``-loop fit from the JAX init: per-step losses,
    validation metrics, the single-metric gate decisions and the final
    parameters."""
    jcfg, pcfg, jsrc, psrc, jtrainer, jstate, steps, loaders = _futr_setup()
    assert [jtrainer._sticky(e) for e in (0, 1)] == [False, True]
    jlosses, plosses = [], []
    make_step = jtrainer.make_train_step

    def recording_make_step(frozen=False):
        step = make_step(frozen=frozen)

        def recorded(state, batch, rng, epoch):
            state, metrics = step(state, batch, rng, epoch)
            jlosses.append(float(metrics["loss"]))
            return state, metrics

        return recorded

    jtrainer.make_train_step = recording_make_step
    jlog, gates = [], _Gates()
    try:
        jfinal = jtrainer.fit(jax.tree.map(np.array, jstate),
                              loaders(jsrc, JaxLoader, True, seed=3),
                              loaders(jsrc, JaxLoader, False), seed=0, checkpointer=gates,
                              log=jlog.append)
    finally:
        jtrainer.make_train_step = make_step

    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    train_step = trainer.train_step

    def recorded(state, batch, epoch):
        metrics = train_step(state, batch, epoch)
        plosses.append(float(metrics["loss"]))
        return metrics

    trainer.train_step = recorded
    pstate = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    plog = []
    trainer.fit(pstate, loaders(psrc, BucketedLoader, True, seed=3),
                loaders(psrc, BucketedLoader, False), seed=0, log=plog.append)
    assert len(plosses) == 2 * steps
    np.testing.assert_allclose(plosses, jlosses, atol=1e-4, rtol=0)
    jlog = [line for line in jlog if not line.startswith("Best model")]
    assert [line.split(":")[0] for line in plog] == [line.split(":")[0] for line in jlog]
    for a, b in zip(_numbers(plog), _numbers(jlog)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)
    assert trainer.best_epochs == gates.best
    _assert_state_close(pstate.model, jfinal, 1e-4, step_atol=2e-3 * steps)


@pytest.mark.parametrize("loop,opened", [("futr", [0]), ("proposed_depth", [0, 1])])
def test_best_gate_follows_the_loop(loop, opened):
    """The ``futr`` loop saves on a better class accuracy only; a better
    weighted accuracy alone opens ``proposed_depth``'s gate."""
    _, pcfg = _futr_configs()
    trainer = Trainer(pcfg.replace(train=pt_config.TrainConfig(loop=loop)), 20, device="cpu")
    best = (0.0, 0.0)
    for epoch, weighted in enumerate((1.0, 3.0)):   # the class accuracy stays 0.5
        val = {"cls_correct": 5.0, "cls_total": 10.0, "weight_acc_sum": weighted,
               "weight_acc_cnt": 4.0}
        best = trainer._finish_epoch(None, epoch, {}, 1, 4, 1.0, lambda st: (val, 1), best,
                                     lambda line: None)
    assert trainer.best_epochs == opened


# bf16 bounds for one step (read on this host): the loss within 5.0e-4 of
# JAX's (bound 1e-2); gradients within 6.5e-3 of the model's largest entry
# (bound 5e-2) and the gradient vector's cosine with JAX's 0.99989 (bound
# 0.999): the bf16 rounding differences of test_torch_models.py
def test_futr_bf16_step_matches_jax():
    jcfg, pcfg, jsrc, psrc, jtrainer, jstate, steps, loaders = _futr_setup("bfloat16")
    batch_j = next(iter(loaders(jsrc, JaxLoader, False)))
    batch_p = next(iter(loaders(psrc, BucketedLoader, False)))
    np.testing.assert_array_equal(batch_p["features"].float().numpy(),
                                  np.asarray(batch_j["features"], np.float32).astype(
                                      jax.numpy.bfloat16).astype(np.float32))
    grads_j, metrics_j, _ = jax.jit(lambda p, b: jtrainer._grad_core(
        p, {}, b, jax.random.PRNGKey(0), 0))(jstate.params, jax.tree.map(np.asarray, batch_j))
    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    state = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    state.model.train()
    metrics_p = trainer._grad_core(state.model, trainer.to_device(batch_p))
    assert abs(float(metrics_p["loss"]) - float(metrics_j["loss"])) <= 1e-2
    want = state_dict_from_flax({"params": jax.device_get(grads_j)})
    got = dict(state.model.named_parameters())
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in got.items():
        assert np.abs(p.grad.numpy() - want[name].numpy()).max() <= 5e-2 * top, name
    a = torch.cat([got[n].grad.flatten() for n in sorted(want)])
    b = torch.cat([want[n].flatten() for n in sorted(want)])
    assert float(torch.nn.functional.cosine_similarity(a, b, dim=0)) > 0.999
