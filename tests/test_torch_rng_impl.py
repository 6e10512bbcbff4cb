"""``TrainConfig.rng_impl`` in the port's ``Trainer``, on the CPU.

The port's dropout streams never matched flax's, so the flag keeps JAX's
documented properties (``r3d_tpu/config.py:262-274``) on the port's own
generators, with the synthetic model of ``tests/test_torch_dispatch.py``
(hidden 32, dropout 0.1, the 256 and 512 buckets, K3's route):

- None and ``"threefry2x32"`` seed exactly as before the flag had a meaning
  (the final state of a 2-epoch fit bit-equal to one seeded by the old
  derivation, rtol = atol = 0);
- ``"rbg"`` draws other masks from the same seed, each keep rate within
  5 binomial standard deviations of 1 - p, and ends another fit;
- under ``"rbg"`` the paths that must agree under one impl still do, bit
  for bit: ``fit``, ``fit_cached`` (one step and three a dispatch) and
  ``fit_hybrid``; K steps a dispatch and K single steps; an accumulated
  update and its microbatches by hand; pp's base seed on every rank of a
  dp coordinate;
- any other name raises ``ValueError``; ``--rng_impl rbg`` trains through
  the CLI (``tests/test_torch_cli.py``).
"""

import copy

import numpy as np
import pytest
import torch

from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.datasets import build_loader, build_source
from r3d_tpu_torch.data.pipeline import pad_batch
from r3d_tpu_torch.models.layers import dropout, set_generators
from r3d_tpu_torch.parallel.pipeline import draw_base_seed
from r3d_tpu_torch.train.loop import Trainer, _stack, dropout_base_seed
from test_torch_device_cache import (
    BUCKETS, NQ, OBS, _budgets, _disk_configs, disk_data, host_loader, k3_route, port_config,
    port_source, source_videos)  # noqa: F401  (disk_data is a fixture)
from test_torch_dispatch import _assert_same_state, _fresh

torch.set_num_threads(1)


def _old_seed_dropout(self, state, seed, start_epoch):
    """``Trainer._seed_dropout`` as it read before ``rng_impl`` had a meaning."""
    dropout_seed = seed if start_epoch == 0 else hash((seed, start_epoch)) & (2**63 - 1)
    if self.rank:
        dropout_seed = hash((dropout_seed, -self.rank)) & (2**63 - 1)
    set_generators(state.model, torch.Generator(self.device).manual_seed(dropout_seed),
                   torch.Generator().manual_seed(dropout_seed))


def _fit(src, rng_impl, monkeypatch=None, start_epoch=0):
    trainer = Trainer(port_config(rng_impl=rng_impl), src.n_class, device="cpu")
    if monkeypatch is not None:
        monkeypatch.setattr(Trainer, "_seed_dropout", _old_seed_dropout)
    state = trainer.init_state(3, seed=5)
    trainer.fit(state, host_loader(src, seed=1), host_loader(src, shuffle=False), seed=1,
                log=lambda *a: None, start_epoch=start_epoch)
    return state


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                  b.model.state_dict().values()))


@pytest.fixture(scope="module")
def fits():
    """2-epoch fits: the default, threefry2x32 and rbg."""
    src = port_source()
    return src, {impl: _fit(src, impl) for impl in (None, "threefry2x32", "rbg")}


def test_default_and_threefry_keep_the_old_streams(fits, monkeypatch):
    src, states = fits
    old = _fit(src, None, monkeypatch)
    _assert_same_state(states[None], old)
    _assert_same_state(states["threefry2x32"], old)
    # a resumed run too: the start epoch folded into the same seed
    resumed = _fit(src, "threefry2x32", start_epoch=1)
    _assert_same_state(resumed, _fit(src, None, monkeypatch, start_epoch=1))


def test_rbg_draws_other_masks_at_the_same_seed(fits):
    src, states = fits
    assert not _equal(states["rbg"], states[None])
    n, p = 200_000, 0.1
    masks = {}
    for impl in (None, "rbg"):
        for rank in (0, 1):
            trainer = Trainer(port_config(rng_impl=impl), src.n_class, device="cpu")
            trainer.rank = rank
            state = trainer.init_state(3, seed=5)
            trainer._seed_dropout(state, 1, 0)
            gen = next(m.generator for m in state.model.modules()
                       if getattr(m, "generator", None) is not None)
            keep = dropout(torch.ones(n), p, gen) != 0
            assert abs(keep.float().mean().item() - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
            masks[impl, rank] = keep
    assert not torch.equal(masks[None, 0], masks["rbg", 0])
    assert not torch.equal(masks["rbg", 0], masks["rbg", 1])   # ranks draw apart
    assert dropout_base_seed(1, "rbg") != dropout_base_seed(1, None) == 1
    assert dropout_base_seed(1, "rbg") == dropout_base_seed(1, "rbg") != dropout_base_seed(2, "rbg")


@pytest.mark.parametrize("K", [1, 3], ids=["one_step", "three_steps_a_dispatch"])
def test_rbg_fit_cached_equals_fit(fits, K, monkeypatch):
    calls = k3_route(monkeypatch)
    src, states = fits
    cache = dc.build_cache(source_videos(src), OBS, 1, NQ, src.pad_idx, src.n_class, BUCKETS,
                           device="cpu")
    trainer = Trainer(port_config(rng_impl="rbg", steps_per_dispatch=K), src.n_class,
                      device="cpu")
    state = trainer.init_state(3, seed=5)
    trainer.fit_cached(state, cache, None, seed=1, log=lambda *a: None, val_cache=cache)
    host = Trainer(port_config(rng_impl="rbg"), src.n_class, device="cpu")
    want = host.init_state(3, seed=5)
    host.fit(want, host_loader(src, seed=1), host_loader(src, shuffle=False), seed=1,
             log=lambda *a: None)
    _assert_same_state(state, want)
    assert not _equal(state, states[None])
    assert {Lk for Lk, ok in calls if ok} == {256, 512}


def test_rbg_fit_hybrid_equals_fit(disk_data, monkeypatch):   # noqa: F811
    k3_route(monkeypatch)
    _, pcfg = _disk_configs(disk_data, epochs=1, rng_impl="rbg")
    psrc = build_source(pcfg.data, "train_split.txt")
    budget = _budgets(psrc, pcfg)["hybrid_longest"][0]
    h = dc.hybrid_cache_from_source(psrc, pcfg.data, NQ, max_bytes=budget, policy="longest",
                                    device="cpu")
    states = {}
    for route in ("host", "hybrid"):
        trainer = Trainer(pcfg, psrc.n_class, device="cpu")
        state = trainer.init_state(3, seed=4)
        val = build_loader(build_source(pcfg.data, "val_split.txt"), pcfg.data, 4, NQ,
                           mode="val", shuffle=False)
        if route == "host":
            trainer.fit(state, build_loader(psrc, pcfg.data, 4, NQ, seed=1), val, seed=1,
                        log=lambda *a: None)
        else:
            trainer.fit_hybrid(state, h, val, seed=1, log=lambda *a: None)
        states[route] = state
    _assert_same_state(states["hybrid"], states["host"])


@pytest.fixture(scope="module")
def rbg_setup():
    src = port_source()
    trainer = Trainer(port_config(rng_impl="rbg"), src.n_class, device="cpu")
    state_dict = trainer.init_state(3).model.state_dict()
    fn, _ = src.make_example_fn(OBS, 1, NQ)
    return src, state_dict, fn


def test_rbg_dispatch_equals_single_steps(rbg_setup, monkeypatch):
    k3_route(monkeypatch)
    src, state_dict, fn = rbg_setup
    short = [i for i in range(len(src.videos) * len(OBS)) if fn(i).features.shape[0] <= 256]
    batches = [pad_batch([fn(i) for i in short[j:j + 2]], src.pad_idx, BUCKETS, NQ,
                         with_depth=True) for j in (0, 2, 4)]
    trainer = Trainer(port_config(rng_impl="rbg"), src.n_class, device="cpu")
    single, multi = _fresh(trainer, state_dict), _fresh(trainer, state_dict)
    loss = sum(trainer.train_step(single, b, 0)["loss"] for b in batches)
    got = trainer.make_multi_step()(multi, _stack(batches), 0)
    _assert_same_state(multi, single)
    assert torch.equal(got["loss"], loss)
    # epoch 0's learning rate is 0 (the warmup): the masks show in the loss
    threefry = Trainer(port_config(), src.n_class, device="cpu")
    other = _fresh(threefry, state_dict)
    assert not torch.equal(sum(threefry.train_step(other, b, 0)["loss"] for b in batches), loss)


def test_rbg_accumulated_update_is_its_microbatches(rbg_setup, monkeypatch):
    k3_route(monkeypatch)
    src, state_dict, fn = rbg_setup
    pair = [pad_batch([fn(i) for i in idx], src.pad_idx, (512,), NQ, with_depth=True)
            for idx in ((0, 1, 2, 3), (1, 2, 3, 0))]
    trainer = Trainer(port_config(grad_accum=2, rng_impl="rbg"), src.n_class, device="cpu")
    accum, oracle = _fresh(trainer, state_dict), _fresh(trainer, state_dict)
    trainer.make_accum_step()(accum, _stack(pair), 0)
    oracle.model.train()
    grads = []
    for b in pair:
        oracle.optimizer.zero_grad(set_to_none=True)
        trainer._grad_core(oracle.model, trainer.to_device(b))
        grads.append({n: p.grad.clone() for n, p in oracle.model.named_parameters()
                      if p.grad is not None})
    for n, p in oracle.model.named_parameters():
        p.grad = (grads[0][n] + grads[1][n]) / 2 if n in grads[0] else None
    oracle.apply_gradients()
    oracle.step += 1
    oracle.extra_batches += 1
    _assert_same_state(accum, oracle)


def test_rbg_pp_base_seed_is_one_per_dp_coordinate(rbg_setup):
    """pp's per-(layer, microbatch) streams follow from one base seed that
    every pp rank of a dp coordinate draws alike (its dp rank is theirs):
    the same under rbg on two such ranks, another than threefry's."""
    src, state_dict, _ = rbg_setup
    bases = {}
    for impl in ("rbg", "rbg", None):
        trainer = Trainer(port_config(rng_impl=impl), src.n_class, device="cpu")
        state = _fresh(trainer, copy.deepcopy(state_dict))
        state.model.train()
        layers = state.model.transformer.decoder.layers
        bases.setdefault(impl, []).append(draw_base_seed(layers))
    assert bases["rbg"][0] == bases["rbg"][1] is not None
    assert bases["rbg"][0] != bases[None][0]


@pytest.mark.parametrize("impl", ["philox", "unsafe_rbg", ""])
def test_other_names_raise(impl):
    cfg = port_config(rng_impl=impl)
    with pytest.raises(ValueError, match="rng_impl"):
        Trainer(cfg, 6, device="cpu")
    with pytest.raises(ValueError, match="rng_impl"):
        dropout_base_seed(0, impl)

