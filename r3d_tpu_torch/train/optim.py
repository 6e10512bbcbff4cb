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

``opt_mu_dtype='bfloat16'`` (optax's ``mu_dtype``) stores the first moment
in bf16. ``torch.optim.AdamW`` cannot, so ``AdamWLowMu`` takes that step as
optax's ``scale_by_adam`` does; the fp32 default keeps ``torch.optim.AdamW``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from r3d_tpu_torch.config import TrainConfig
from r3d_tpu_torch.parallel.mesh import is_sharded


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


class AdamWLowMu(torch.optim.Optimizer):
    """AdamW with its first moment stored in bf16, as
    ``optax.adamw(mu_dtype=bfloat16)`` computes it: ``mu = (1 - b1) g + b1
    mu_prev``, where ``b1 mu_prev`` is a bf16 product, b1 itself rounded to
    bf16 (optax multiplies the stored moment by a weakly typed Python float:
    0.9 becomes 0.8984375), before the fp32 sum; the bias correction (with
    the true b1) and the update use that fp32 ``mu``; only the stored state
    is rounded. Then ``p -= lr (update + weight_decay p)``. The state has
    ``torch.optim.AdamW``'s keys (``step``, ``exp_avg``, ``exp_avg_sq``), the
    first moment in bf16, the second in fp32. Every parameter of a group
    needs a gradient (``TrainState.apply_gradients`` fills zeros)."""

    mu_dtype = torch.bfloat16

    def __init__(self, params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    def load_state_dict(self, state_dict):
        # torch casts a loaded floating-point state to its parameter's dtype
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            states = [self.state[p] for p in params]
            grads = [p.grad.float() for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            mu = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(mus, b1_mu)])
            nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(nus, b2))
            steps = [st["step"] for st in states]
            torch._foreach_add_(steps, 1.0)
            count = float(steps[0])
            mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** count))
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu_hat, denom)
            torch._foreach_add_(update, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_add_(params, update, alpha=-group["lr"])
            # DTensor (FSDP) has no rule for _foreach_copy_: copy the shards
            torch._foreach_copy_(_local(mus), _local(mu))
            torch._foreach_copy_(_local(nus), _local(nu))


def _local(ts):
    """Each tensor of ``ts``, or this rank's shard of a sharded one."""
    return [t.to_local() if is_sharded(t) else t for t in ts]


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int):
    """(optimizer, schedule); the caller sets the learning rate from the
    schedule before each step."""
    params = [p for p in params if p.requires_grad]
    kw = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.opt_mu_dtype in (None, "float32"):
        opt = torch.optim.AdamW(params, **kw)
    elif cfg.opt_mu_dtype == "bfloat16":
        opt = AdamWLowMu(params, **kw)
    else:
        raise ValueError(f"opt_mu_dtype {cfg.opt_mu_dtype!r}: float32 or bfloat16")
    schedule = linear_warmup_cosine_schedule(cfg.lr, cfg.warmup_epochs, cfg.epochs,
                                             steps_per_epoch)
    return opt, schedule
