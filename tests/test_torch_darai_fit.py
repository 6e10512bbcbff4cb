"""The ``unsupervised`` loop (``darai``: ``futr_unsupervised``, the
curriculum composite) against the JAX package's, on the CPU.

- A 2-epoch ``fit`` from the JAX init over the same batches of a darai-layout
  dataset on disk (multi-sequence features, L3 queries with the config's pad
  47 and exclude 48), fp32, ``warmup_loss_epochs`` (1, 3) so that epoch 0
  trains on the focal L3 term and epoch 1 on the temporal cluster term, and
  the SupCon term on: per-step losses within 1e-4, the validation lines to
  their printed decimals, the gate's decisions equal, the final state within
  the bounds of ``tests/test_torch_train.py``'s fits. The decoder's dropout is
  0; the source's hard-coded ``Dropout(0.1)`` draws from streams the two
  frameworks do not share, so it is set to rate 0 on both sides inside this
  test (its invariants are held in ``tests/test_torch_unsupervised_model.py``).
  The loop is sticky: epoch 1 trains the module-eval forward. Also with
  ``grad_accum=2`` (the segment ids stacked with their microbatches). The
  correctness gate weighs a frame 1 or 5 by two argmaxes, a step function:
  every step's smallest top-2 margin of the L3 and seg logits is checked to
  lie well above the outputs' error, so no weight can differ.
- In the port, with every dropout on and the decoder's cross-attention on the
  kernels' route (their plain versions on the CPU): ``fit_cached == fit``
  (the segment ids derived on the device from the gathered batch), and three
  steps a dispatch equal to one, on both routes, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen
import jax

from chip_smoke import write_darai_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.data import datasets as jax_ds
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.models import futr_unsupervised, layers
from r3d_tpu_torch.train.loop import Trainer
from test_torch_train import _assert_state_close, _Gates, _numbers, _variables

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

TRAIN = ((80, 90), (100,), (70, 75), (95,))
VAL = ((85, 60),)
NQ = 8
MARGIN_MIN = 2e-4   # the least top-2 margin a step may show: 10x the forward bound of 2e-5


class _NoDropout:
    """flax ``nn.Dropout`` at rate 0."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_darai_dataset(tmp_path_factory.mktemp("darai_fit"), TRAIN, VAL, input_dim=12,
                               seed=6)


def _configs(root, **train_kw):
    model = dict(hidden_dim=32, n_head=4, n_query=NQ, input_dim=12, max_pos_len=64,
                 dropout=0.0)
    data = dict(data_root=root, sample_rate=2, seq_buckets=(64,))
    train = dict(dict(batch_size=6, epochs=2, warmup_epochs=1, min_train_batch=0,
                      warmup_loss_epochs=(1, 3), supcon_weight=0.5, supcon_samples=64),
                 **train_kw)
    out = []
    for m in (jax_config, pt_config):
        base = m.get_config("darai")
        out.append(base.replace(model=dataclasses.replace(base.model, **model),
                                data=dataclasses.replace(base.data, **data),
                                train=dataclasses.replace(base.train, **train)))
    return out


def _top2(logits):
    top = torch.topk(logits.detach().float(), 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


@pytest.mark.parametrize("accum", [1, 2])
def test_unsupervised_fit_matches_jax(root, monkeypatch, accum):
    """With ``grad_accum=2`` the first two batches of an epoch make one
    update from their stacked batch, segment ids included, the third its
    own: the per-step losses are not recorded there, the rest holds."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(futr_unsupervised, "SRC_DROPOUT", 0.0)
    jcfg, pcfg = _configs(root, grad_accum=accum)
    jsrc = jax_ds.build_source(jcfg.data, "train_split.txt")
    jval = jax_ds.build_source(jcfg.data, "val_split.txt")
    psrc = pt_ds.build_source(pcfg.data, "train_split.txt")
    pval = pt_ds.build_source(pcfg.data, "val_split.txt")

    def loaders(ds, cfg, src, val):
        return (ds.build_loader(src, cfg.data, 6, NQ, seed=3),
                ds.build_loader(val, cfg.data, 1, NQ, mode="val", shuffle=False))

    jtrainer = JaxTrainer(jcfg, jsrc.n_class)
    example = next(iter(jax_ds.build_loader(jsrc, jcfg.data, 6, NQ, shuffle=False)))
    steps = len(loaders(jax_ds, jcfg, jsrc, jval)[0])
    assert steps == 3
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), example, steps_per_epoch=steps)
    assert [jtrainer._sticky(e) for e in (0, 1)] == [False, True]
    jlosses, plosses, modes, margins = [], [], [], []
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
        jfinal = jtrainer.fit(jax.tree.map(np.array, jstate), *loaders(jax_ds, jcfg, jsrc, jval),
                              seed=0, checkpointer=gates, log=jlog.append)
    finally:
        jtrainer.make_train_step = make_step

    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    losses = trainer._losses

    def recorded_losses(outputs, batch, epoch=0, train=True):
        if train:
            margins.append(min(_top2(outputs["l3"]), _top2(outputs["seg"])))
        return losses(outputs, batch, epoch, train)

    trainer._losses = recorded_losses
    train_step = trainer.train_step

    def recorded(state, batch, epoch):
        metrics = train_step(state, batch, epoch)
        plosses.append(float(metrics["loss"]))
        modes.append(state.model.training)
        return metrics

    trainer.train_step = recorded
    pstate = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    plog = []
    trainer.fit(pstate, *loaders(pt_ds, pcfg, psrc, pval), seed=0, log=plog.append)
    assert min(margins) >= MARGIN_MIN, margins
    if accum == 1:
        assert len(plosses) == 2 * steps and modes == [True] * steps + [False] * steps
        np.testing.assert_allclose(plosses, jlosses, atol=1e-4, rtol=0)
    else:
        assert len(margins) == 2 * steps and len(plosses) == len(jlosses) == 2
    jlog = [line for line in jlog if not line.startswith("Best model")]
    assert [line.split(":")[0] for line in plog] == [line.split(":")[0] for line in jlog]
    for a, b in zip(_numbers(plog), _numbers(jlog)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)
    assert trainer.best_epochs == gates.best
    _assert_state_close(pstate.model, jfinal, 1e-4, step_atol=2e-3 * steps)


def _run(root, route, K=1):
    """One port run of ``route`` with dropout on and the decoder's
    cross-attention on the kernels' route; returns (log, state)."""
    _, cfg = _configs(root, steps_per_dispatch=K, supcon_weight=0.0)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.1))
    src = pt_ds.build_source(cfg.data, "train_split.txt")
    val = pt_ds.build_source(cfg.data, "val_split.txt")
    trainer = Trainer(cfg, src.n_class, device="cpu")
    state = trainer.init_state(3, seed=2)
    log = []
    if route == "fit":
        trainer.fit(state, pt_ds.build_loader(src, cfg.data, 6, NQ, seed=1),
                    pt_ds.build_loader(val, cfg.data, 1, NQ, mode="val", shuffle=False),
                    seed=1, log=log.append)
    else:
        trainer.fit_cached(state, dc.cache_from_source(src, cfg.data, NQ, device="cpu"), None,
                           seed=1, log=log.append,
                           val_cache=dc.cache_from_source(val, cfg.data, NQ, device="cpu"))
    return [line.split("(")[0] for line in log], state.model.state_dict()


def _kernels_route(monkeypatch):
    monkeypatch.setattr(layers, "attention_kernel_eligible",
                        lambda Lq, Lk, D, device: Lq != Lk)


@pytest.fixture(scope="module")
def fit_run(root):
    with pytest.MonkeyPatch.context() as mp:
        _kernels_route(mp)
        return _run(root, "fit")


@pytest.mark.parametrize("route,K", [("fit_cached", 1), ("fit", 3), ("fit_cached", 3)])
def test_routes_and_dispatch_equal_fit(root, fit_run, route, K, monkeypatch):
    _kernels_route(monkeypatch)
    want_log, want = fit_run
    log, got = _run(root, route, K)
    assert log == want_log
    for k in want:
        assert torch.equal(got[k], want[k]), k
