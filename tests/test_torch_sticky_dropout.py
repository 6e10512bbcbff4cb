"""The sticky-epoch rule for the dropouts whose rate is written into the
model (ROADMAP C4), on the CPU.

JAX's frozen twin of the sticky epochs (``r3d_tpu/train/loop.py:94-110``)
zeroes only ``cfg.dropout`` and ``fuser_dropout`` and applies the model at
``train=True``, so the self-attention source's ``Dropout(0.1)``
(``r3d_tpu/models/futr_unsupervised.py:133``), the depth queries'
(``:184-186``) and the TCN's two ``Dropout(0.2)`` a block
(``r3d_tpu/models/baselines.py:184,187``) stay on there. The port's sticky
step (``Trainer._train_mode``: ``model.eval()``, then ``frozen_twin``) must
do the same. The frameworks draw different streams, so the dropouts are held
by their invariants in one sticky train step at the real rates, with
``cfg.dropout = 0``: among the nonzero inputs the keep rate lies within 3
sigma of 1 - rate, a kept value is its input over 1 - rate and a dropped one
0, and the backward passes the gradient through the forward's mask, scaled
alike. Before the repair the port's sticky step ran these dropouts in eval
mode, and the keep rate read 1.0. Validation (``model.eval()`` alone) still
keeps every value.
"""

import dataclasses

import numpy as np
import pytest
import torch

from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.models.layers import FixedDropout
from r3d_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 9


def _config(model):
    base = pt_config.get_config("nturgbd" if model == "tcn" else "darai")
    loop = "tcn" if model == "tcn" else "unsupervised"
    return base.replace(
        model=dataclasses.replace(base.model, model=model, hidden_dim=32, n_head=4,
                                  input_dim=12, max_pos_len=128, dropout=0.0),
        train=dataclasses.replace(base.train, loop=loop, batch_size=4, warmup_epochs=0,
                                  min_train_batch=0))


def _batch(rng, B=4, S=64, Q=8):
    past = rng.randint(0, N_CLASS, (B, S))
    past[1, 45:] = N_CLASS + 1
    target = rng.randint(0, N_CLASS, (B, Q))
    q = rng.randint(0, 47, (B, S))
    q[past == N_CLASS + 1] = 47
    return {"features": torch.from_numpy(rng.randn(B, S, 12).astype(np.float32)),
            "past_label": torch.from_numpy(past), "query_label": torch.from_numpy(q),
            "trans_future_target": torch.from_numpy(target),
            "trans_future_dur": torch.from_numpy(rng.rand(B, Q).astype(np.float32))}


class _Record:
    """Each call's (input, output, grad of input, grad of output)."""

    def __init__(self, module):
        self.calls = []
        module.register_forward_hook(self.forward)

    def forward(self, module, args, out):
        call = {"x": args[0].detach(), "y": out.detach(), "training": module.training}
        self.calls.append(call)
        if out.requires_grad and out is not args[0]:
            out.register_hook(lambda g: call.__setitem__("gy", g.detach()))
            args[0].register_hook(lambda g: call.__setitem__("gx", g.detach()))


@pytest.mark.parametrize("model,names", [
    ("futr_unsupervised", ("src_drop",)),
    ("futr_unsupervised_depth", ("src_drop", "query_drop")),
    ("tcn", ("drop",)),
])
def test_sticky_step_keeps_the_fixed_dropouts_on(model, names):
    cfg = _config(model)
    trainer = Trainer(cfg, N_CLASS, device="cpu")
    assert trainer._sticky(1)
    state = trainer.init_state(1)
    trainer._seed_dropout(state, 0, 0)
    drops = {n: getattr(state.model, n) for n in names}
    assert all(isinstance(d, FixedDropout) for d in drops.values())
    records = {n: _Record(d) for n, d in drops.items()}
    batch = trainer._with_seg_ids(_batch(np.random.RandomState(0)))
    trainer.train_step(state, batch, epoch=1)
    assert not state.model.training   # the module-eval forward, BN and cfg.dropout off
    for n, rec in records.items():
        rate = drops[n].rate
        assert rate == (0.2 if model == "tcn" else 0.1)
        for call in rec.calls:
            assert call["training"]
            x, y = call["x"], call["y"]
            live = x != 0
            kept = live & (y != 0)
            n_live = int(live.sum())
            keep = int(kept.sum()) / n_live
            sigma = np.sqrt(rate * (1 - rate) / n_live)
            assert abs(keep - (1 - rate)) <= 3 * sigma, (n, keep, n_live)
            torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0, atol=0)
            assert y[live & ~kept].eq(0).all()
            gx, gy = call["gx"], call["gy"]
            torch.testing.assert_close(gx[live], (gy * kept / (1 - rate))[live], rtol=1e-6,
                                       atol=0)
    # validation keeps every value
    trainer._eval(state, trainer.to_device(batch))
    assert all(r.calls[-1]["training"] is False and torch.equal(r.calls[-1]["x"],
                                                                 r.calls[-1]["y"])
               for r in records.values())
