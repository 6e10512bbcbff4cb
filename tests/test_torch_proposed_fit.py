"""The ``proposed`` loop (``futr_proposed``, the query-conditioned FUTR of
``50salads_proposed`` and ``breakfast_proposed``) against the JAX
package's, on the CPU.

- A 2-epoch ``fit`` from the JAX init over the same synthetic batches with
  a query stream, fp32, dropout 0: per-step losses and validation metrics
  within 1e-4 (printed lines to their 3 decimals), the two-metric gate's
  decisions equal, the final parameters within the bounds of
  ``tests/test_torch_train.py``'s fits; ``fc_l3``, which takes no loss in
  this loop and moves only by AdamW's decay, within 1e-6. The loop is not
  sticky: both epochs train in train mode.
- On a 50salads-layout dataset on disk, with dropout 0.1 and every decoder
  attention on the kernels' route (their plain versions on the CPU):
  ``fit_cached == fit`` and ``fit_hybrid == fit`` in the port, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from chip_smoke import write_proposed_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.data.pipeline import BucketedLoader as JaxLoader
from r3d_tpu.data.pipeline import pad_batch as jax_pad_batch
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.datasets import build_loader, build_source
from r3d_tpu_torch.data.pipeline import BucketedLoader
from r3d_tpu_torch.data.synthetic import SyntheticSource
from r3d_tpu_torch.models import layers
from r3d_tpu_torch.ops import attention as pt_attention
from r3d_tpu_torch.train.loop import Trainer
from test_torch_train import _assert_state_close, _Gates, _numbers, _variables

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

OBS = (0.2, 0.3, 0.5)
NQ = 8
QUERY_CLASSES = 9    # the query pad id is 9: query_num 10


def _configs():
    model = dict(model="futr_proposed", hidden_dim=32, n_head=4, n_query=NQ, input_dim=12,
                 n_decoder_layers=2, max_pos_len=128, seg_excludes_none=True, dropout=0.0,
                 query_num=QUERY_CLASSES + 1)
    data = dict(dataset="50salads", depth_features_dir=None, gt_format="plain",
                seq_buckets=(64, 128), train_obs_percs=OBS)
    train = dict(loop="proposed", batch_size=4, epochs=2, warmup_epochs=1, lr=1e-3,
                 min_train_batch=0)
    make = lambda m: m.get_config("50salads_proposed").replace(
        model=m.ModelConfig(**model), data=m.DataConfig(**data), train=m.TrainConfig(**train))
    return make(jax_config), make(pt_config)


def _loaders(src, Loader, shuffle, seed=0):
    fn, n = src.make_example_fn(OBS, 1, NQ)
    return Loader(num_examples=n, make_example_fn=fn, batch_size=4, pad_idx=src.pad_idx,
                  buckets=(64, 128), n_query=NQ, with_depth=False, with_query=True,
                  query_pad_idx=QUERY_CLASSES, shuffle=shuffle, seed=seed)


def test_proposed_fit_matches_jax():
    jcfg, pcfg = _configs()
    kw = dict(n_videos=6, n_actions=5, vid_len_range=(60, 120), input_dim=12,
              n_query_classes=QUERY_CLASSES, seed=3)
    jsrc, psrc = JaxSource(**kw), SyntheticSource(**kw)
    jtrainer = JaxTrainer(jcfg, jsrc.n_class)
    fn, _ = jsrc.make_example_fn(OBS, 1, NQ)
    example = jax_pad_batch([fn(i) for i in range(4)], jsrc.pad_idx, (64, 128), NQ,
                            with_query=True, query_pad_idx=QUERY_CLASSES)
    steps = len(_loaders(jsrc, JaxLoader, True))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), example, steps_per_epoch=steps)
    assert [jtrainer._sticky(e) for e in (0, 1)] == [False, False]
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
        jfinal = jtrainer.fit(jax.tree.map(np.array, jstate),
                              _loaders(jsrc, JaxLoader, True, seed=3),
                              _loaders(jsrc, JaxLoader, False), seed=0, checkpointer=gates,
                              log=jlog.append)
    finally:
        jtrainer.make_train_step = make_step

    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    assert [trainer._sticky(e) for e in (0, 1)] == [False, False]
    train_step = trainer.train_step

    def recorded(state, batch, epoch):
        metrics = train_step(state, batch, epoch)
        plosses.append(float(metrics["loss"]))
        modes.append(state.model.training)
        return metrics

    trainer.train_step = recorded
    init = state_dict_from_flax(_variables(jstate))
    pstate = trainer.init_state(steps, init)
    plog = []
    trainer.fit(pstate, _loaders(psrc, BucketedLoader, True, seed=3),
                _loaders(psrc, BucketedLoader, False), seed=0, log=plog.append)
    assert len(plosses) == 2 * steps and all(modes)
    np.testing.assert_allclose(plosses, jlosses, atol=1e-4, rtol=0)
    jlog = [line for line in jlog if not line.startswith("Best model")]
    assert [line.split(":")[0] for line in plog] == [line.split(":")[0] for line in jlog]
    for a, b in zip(_numbers(plog), _numbers(jlog)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)
    assert trainer.best_epochs == gates.best
    _assert_state_close(pstate.model, jfinal, 1e-4, step_atol=2e-3 * steps)
    want = state_dict_from_flax(_variables(jfinal))
    for name in ("fc_l3.weight", "fc_l3.bias"):
        got = pstate.model.state_dict()[name]
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-6, rtol=0)
    # only the decay moved it: no gradient reaches fc_l3 in this loop
    w0 = init["fc_l3.weight"]
    moved = float((w0 - pstate.model.fc_l3.weight.detach()).abs().max())
    assert 0 < moved < 1e-3 * float(w0.abs().max())


@pytest.fixture(scope="module")
def salads_root(tmp_path_factory):
    """Four train videos of 700-1,000 frames and one val video at sample
    rate 1 after the config override: windows of 140-500 rows in the 256 and
    512 buckets."""
    return write_proposed_dataset(tmp_path_factory.mktemp("proposed_fit"), "50salads_proposed",
                                  (700, 800, 900, 1000), (800,), input_dim=12, seed=1,
                                  run=(20, 80))


def _disk_config(root):
    cfg = pt_config.get_config("50salads_proposed")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, data_root=root, sample_rate=1,
                                 seq_buckets=(256, 512), feature_dtype="float32"),
        model=dataclasses.replace(cfg.model, hidden_dim=32, n_head=2, input_dim=12, n_query=NQ,
                                  max_pos_len=512, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=4, epochs=1, warmup_epochs=1,
                                  min_train_batch=0))


@pytest.mark.parametrize("route", ["fit_cached", "fit_hybrid"])
def test_cached_routes_equal_fit(salads_root, route, monkeypatch):
    """The query stream through the device cache (and the hybrid cache's
    host rows at their own bucket) trains exactly as the host loader does,
    with dropout on and every decoder attention on the kernels' route."""
    card = torch.device("cuda")
    taken = []

    def eligible(Lq, Lk, D, device):
        ok = pt_attention.attention_kernel_eligible(Lq, Lk, D, card)
        taken.append((Lq, Lk, ok))
        return ok

    monkeypatch.setattr(layers, "attention_kernel_eligible", eligible)
    cfg = _disk_config(salads_root)
    src = build_source(cfg.data, "train.split1.bundle")
    val_src = build_source(cfg.data, "test.split1.bundle")
    states, logs = {}, {}
    for r in ("fit", route):
        trainer = Trainer(cfg, src.n_class, device="cpu")
        state = trainer.init_state(3, seed=2)
        val = build_loader(val_src, cfg.data, 4, NQ, mode="val", shuffle=False)
        logs[r] = []
        if r == "fit":
            trainer.fit(state, build_loader(src, cfg.data, 4, NQ, seed=1), val, seed=1,
                        log=logs[r].append)
        elif r == "fit_cached":
            cache = dc.cache_from_source(src, cfg.data, NQ, device="cpu")
            trainer.fit_cached(state, cache, None, seed=1, log=logs[r].append,
                               val_cache=dc.cache_from_source(val_src, cfg.data, NQ,
                                                              device="cpu"))
        else:
            _, frows, frb, _, _, _ = dc._unit_probe(src, cfg.data)
            h = dc.hybrid_cache_from_source(src, cfg.data, NQ, device="cpu",
                                            max_bytes=2 * int(frows.max()) * (frb + 4))
            assert 0 < h.host_frac < 1 and h.with_query
            trainer.fit_hybrid(state, h, val, seed=1, log=logs[r].append)
        states[r] = state
    strip = lambda lines: [l.split("(")[0] for l in lines]   # the clips/s rate aside
    assert strip(logs["fit"]) == strip(logs[route])
    for (k, a), b in zip(states["fit"].model.state_dict().items(),
                         states[route].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert any(ok for _, _, ok in taken) and all(ok == (Lq == Lk) for Lq, Lk, ok in taken)
