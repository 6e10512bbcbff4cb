"""Multi-step dispatch and gradient accumulation in the port's ``Trainer``
(``make_multi_step``, ``make_cached_train_fn``, ``make_accum_step``), on
the CPU.

Torch-only invariants at the synthetic model's widths (hidden 32, 2 heads
of 16) in the 256 and 512 buckets, the decoder's cross-attention on K3's
route (its plain version here), dropout on:

- K steps from one stacked batch, and K cached steps from one [K, B] index
  table, equal K single ``train_step`` calls exactly (rtol = atol = 0):
  parameters, BN statistics, AdamW moments and the summed metrics;
- ``grad_accum = K`` makes one update from the mean of the K microbatch
  gradients, exactly as the mean taken by hand (rtol = atol = 0), updates
  the BN statistics once per microbatch in order, advances ``state.step``
  by K and reads the schedule at the update count; K identical
  microbatches without dropout give one plain step's parameters (1e-6:
  the mean of identical fp32 gradients is exact, Adam's update of it may
  round differently by one ulp);
- ``fit`` groups consecutive same-shape batches into accumulated updates
  and trains the leftovers one by one.

Against JAX: ``fit`` with ``grad_accum = 2`` from JAX's init (fp32, dropout
off) over 2 epochs with a 1-epoch warmup, held to JAX's ``fit`` with the
bounds of ``tests/test_torch_train.py``'s 2-epoch fit, with equal update
counts (optax's schedule count) and batch counts.
"""

import copy
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu_torch.convert import state_dict_from_flax

from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.pipeline import BucketedLoader, pad_batch
from r3d_tpu_torch.train.loop import Trainer, _stack
from test_torch_device_cache import (
    BUCKETS, NQ, OBS, host_loader, k3_route, port_config, port_source, source_videos)
from test_torch_train import (
    OBS as TRAIN_OBS, _assert_state_close, _configs, _jax_init, _numbers, _sources, _variables)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


def _fresh(trainer, state_dict, steps=3, seed=0):
    state = trainer.init_state(steps, state_dict)
    trainer._seed_dropout(state, seed, 0)
    return state


def _assert_same_state(a, b):
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for pa, pb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert (a.step, a.updates) == (b.step, b.updates)


@pytest.fixture(scope="module")
def dispatch_setup():
    src = port_source()
    cfg = port_config()
    trainer = Trainer(cfg, src.n_class, device="cpu")
    state_dict = trainer.init_state(3).model.state_dict()
    fn, n = src.make_example_fn(OBS, 1, NQ)
    batches = [pad_batch([fn(i) for i in idx], src.pad_idx, BUCKETS, NQ, with_depth=True)
               for idx in ((0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11))]
    return src, cfg, state_dict, batches


def test_multi_step_equals_single_steps(dispatch_setup, monkeypatch):
    calls = k3_route(monkeypatch)
    src, cfg, state_dict, _ = dispatch_setup
    fn, _ = src.make_example_fn(OBS, 1, NQ)
    # three batches of one shape: the 256 bucket
    short = [i for i in range(len(src.videos) * len(OBS)) if fn(i).features.shape[0] <= 256]
    batches = [pad_batch([fn(i) for i in short[j:j + 2]], src.pad_idx, BUCKETS, NQ,
                         with_depth=True) for j in (0, 2, 4)]
    assert {b["features"].shape[1] for b in batches} == {256}
    trainer = Trainer(cfg, src.n_class, device="cpu")
    single, multi = _fresh(trainer, state_dict), _fresh(trainer, state_dict)
    want = {}
    for b in batches:
        for k, v in trainer.train_step(single, b, 0).items():
            want[k] = want.get(k, 0.0) + v
    got = trainer.make_multi_step()(multi, _stack(batches), 0)
    _assert_same_state(multi, single)
    assert multi.step == 3
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (256, True) in calls


def test_cached_dispatch_equals_single_steps(dispatch_setup, monkeypatch):
    calls = k3_route(monkeypatch)
    src, cfg, state_dict, _ = dispatch_setup
    cache = dc.build_cache(source_videos(src), OBS, 1, NQ, src.pad_idx, src.n_class, BUCKETS,
                           device="cpu")
    plan = dc.epoch_plan(cache, 2, seed=1, epoch=0)
    S0 = max(BUCKETS, key=lambda b: sum(S == b for S, _ in plan))
    idxs = [idx for S, idx in plan if S == S0][:3]
    assert len(idxs) == 3
    fn, _ = src.make_example_fn(OBS, 1, NQ)
    trainer = Trainer(cfg, src.n_class, device="cpu")
    host, cached, one_by_one = (_fresh(trainer, state_dict) for _ in range(3))
    for idx in idxs:
        trainer.train_step(host, pad_batch([fn(int(i)) for i in idx], src.pad_idx, (S0,), NQ,
                                           with_depth=True), 1)
    step = trainer.make_cached_train_fn(cache)
    step(cached, cache.data, torch.from_numpy(np.stack(idxs)), S0, 1)
    for idx in idxs:
        step(one_by_one, cache.data, torch.from_numpy(idx[None]), S0, 1)
    _assert_same_state(cached, host)
    _assert_same_state(one_by_one, host)
    assert (S0, True) in calls


def test_grad_accum_is_the_mean_microbatch_gradient(dispatch_setup, monkeypatch):
    k3_route(monkeypatch)
    src, _, state_dict, batches = dispatch_setup
    fn, _ = src.make_example_fn(OBS, 1, NQ)
    S = batches[0]["features"].shape[1]
    pair = [batches[0], pad_batch([fn(i) for i in (1, 2, 3, 0)], src.pad_idx, (S,), NQ,
                                  with_depth=True)]
    trainer = Trainer(port_config(grad_accum=2), src.n_class, device="cpu")
    accum, oracle = _fresh(trainer, state_dict), _fresh(trainer, state_dict)
    lrs = []
    sched = accum.schedule
    accum.schedule = lambda t: lrs.append(t) or sched(t)
    trainer.make_accum_step()(accum, _stack(pair), 0)

    # by hand: each microbatch's gradient in order from the same module, then the mean
    oracle.model.train()
    grads = []
    stats = []
    for b in pair:
        oracle.optimizer.zero_grad(set_to_none=True)
        trainer._grad_core(oracle.model, trainer.to_device(b))
        grads.append({n: p.grad.clone() for n, p in oracle.model.named_parameters()
                      if p.grad is not None})
        stats.append(copy.deepcopy({k: v for k, v in oracle.model.state_dict().items()
                                    if "running" in k}))
    for n, p in oracle.model.named_parameters():
        p.grad = (grads[0][n] + grads[1][n]) / 2 if n in grads[0] else None
    oracle.apply_gradients()
    oracle.step += 1
    oracle.extra_batches += 1
    _assert_same_state(accum, oracle)
    assert accum.step == 2 and accum.updates == 1 and lrs == [0]
    # the BN running statistics moved once per microbatch
    assert any(not torch.equal(stats[0][k], stats[1][k]) for k in stats[0])


def test_accum_of_identical_microbatches_is_one_step(dispatch_setup):
    src, _, state_dict, batches = dispatch_setup
    cfg = port_config(grad_accum=3)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0, fuser_dropout=0.0))
    trainer = Trainer(cfg, src.n_class, device="cpu")
    one, accum = _fresh(trainer, state_dict), _fresh(trainer, state_dict)
    m1 = trainer.train_step(one, batches[0], 0)
    m3 = trainer.make_accum_step()(accum, _stack([batches[0]] * 3), 0)
    assert abs(float(m1["loss"]) - float(m3["loss"])) <= 1e-6
    assert (one.step, accum.step, accum.updates) == (1, 3, 1)
    for (k, a), b in zip(one.model.named_parameters(), accum.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)


def test_fit_groups_accumulated_updates(dispatch_setup):
    src, _, state_dict, _ = dispatch_setup
    trainer = Trainer(port_config(grad_accum=2, epochs=1), src.n_class, device="cpu")
    shapes = [b["features"].shape for b in host_loader(src, seed=1)]
    # each run of one shape: its pairs update once each, an odd batch alone
    runs = []
    for shape in shapes:
        if runs and runs[-1][0] == shape:
            runs[-1][1] += 1
        else:
            runs.append([shape, 1])
    updates = sum(n // 2 + n % 2 for _, n in runs)
    state = _fresh(trainer, state_dict, steps=len(shapes))
    lines = []
    trainer.fit(state, host_loader(src, seed=1), host_loader(src, shuffle=False), seed=1,
                log=lines.append)
    assert state.step == len(shapes) and state.updates == updates < len(shapes)
    assert lines[0].startswith("Epoch [1/1] Loss : ")


def test_fit_grad_accum_matches_jax():
    """One 128 bucket, batches of 4 and a last one of 2: each epoch makes
    two accumulated updates and one single step, so the update count falls
    behind the batch count. The warmup holds the learning rate at 0 through
    the schedule's epoch 0 and at 1e-3 from its epoch 1, which JAX reaches
    by its update count over an epoch of updates: the port's schedule must
    read the same count at the same epoch length, or epoch 1 would start at
    another rate."""
    jcfg, pcfg = _configs(grad_accum=2)
    jsrc, psrc = _sources()
    jtrainer, jstate, steps = _jax_init(jcfg, jsrc)

    def loader(src, Loader, shuffle):
        fn, n = src.make_example_fn(TRAIN_OBS, 1, 8)
        return Loader(num_examples=n, make_example_fn=fn, batch_size=4, pad_idx=src.pad_idx,
                      buckets=(128,), n_query=8, with_depth=True, shuffle=shuffle, seed=3)

    jlog, plog = [], []
    jfinal = jtrainer.fit(jax.tree.map(np.array, jstate),   # a copy: fit donates it
                          loader(jsrc, JaxLoader, True), loader(jsrc, JaxLoader, False), seed=0,
                          log=jlog.append)
    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    pstate = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    trainer.fit(pstate, loader(psrc, BucketedLoader, True), loader(psrc, BucketedLoader, False),
                seed=0, log=plog.append)
    sched = lambda x: isinstance(x, optax.ScaleByScheduleState)
    counts = {int(x.count) for x in jax.tree.leaves(jfinal.opt_state, is_leaf=sched)
              if sched(x)}
    assert steps == 5 and counts == {pstate.updates} == {6}
    assert pstate.step == int(jfinal.step) == 2 * steps
    jlog = [l for l in jlog if not l.startswith("Best")]
    plog = [l for l in plog if not l.startswith("Best")]
    assert [l.split(":")[0] for l in plog] == [l.split(":")[0] for l in jlog]
    for a, b in zip(_numbers(plog), _numbers(jlog)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)   # printed to 3 decimals
    _assert_state_close(pstate.model, jfinal, 1e-4, step_atol=2e-3 * steps)
