"""AdamW with the epoch-stepped linear-warmup cosine schedule.

Counterpart of ``r3d_tpu/train/optim.py``. The reference steps pl_bolts'
``LinearWarmupCosineAnnealingLR`` once per epoch; the schedule is its closed
form as a function of ``step // steps_per_epoch``, including the quirk that
epoch 0 trains at ``warmup_start_lr`` (0.0). As optax counts, update t (from
0) uses ``schedule(t)``. AdamW: beta 0.9 / 0.999, eps 1e-8, weight decay on
every parameter (biases and norms too). optax decays a parameter whose
gradient is zero, while ``torch.optim.AdamW`` skips one whose ``.grad`` is
None, so ``TrainState.apply_gradients`` fills missing gradients with zeros.
Parameters with ``requires_grad`` off (the LSTM's zero input-side biases,
which flax's cells do not have) are left out of the optimizer.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from r3d_tpu_torch.config import TrainConfig


def linear_warmup_cosine_schedule(base_lr: float, warmup_epochs: int, max_epochs: int,
                                  steps_per_epoch: int, warmup_start_lr: float = 0.0,
                                  eta_min: float = 0.0) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < warmup_epochs:
            return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / max(warmup_epochs - 1, 1)
        progress = (epoch - warmup_epochs) / max(max_epochs - warmup_epochs, 1)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * progress))

    return schedule


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int):
    """(optimizer, schedule); the caller sets the learning rate from the
    schedule before each step."""
    if cfg.opt_mu_dtype is not None:
        raise NotImplementedError("opt_mu_dtype is not ported (ROADMAP queue A, item A10)")
    opt = torch.optim.AdamW([p for p in params if p.requires_grad], lr=0.0,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    schedule = linear_warmup_cosine_schedule(cfg.lr, cfg.warmup_epochs, cfg.epochs,
                                             steps_per_epoch)
    return opt, schedule
