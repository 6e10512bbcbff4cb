"""Train state: the module (parameters and BatchNorm buffers), the optimizer
and the update count. Counterpart of ``r3d_tpu/train/state.py``; the port
updates in place where JAX returns a new pytree."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0            # loader batches consumed
    extra_batches: int = 0   # of those, the ones an accumulated update took beyond its first

    @property
    def updates(self) -> int:
        """The optimizer updates so far: the count optax's schedule reads."""
        return self.step - self.extra_batches

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at
        ``schedule(updates)``, then ``step += 1``."""
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
