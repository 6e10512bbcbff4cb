"""The ``proposed_depth`` and ``futr`` training loops on one card.

Counterpart of those two loops of ``r3d_tpu/train/loop.py``:

    trainer = Trainer(config, n_class)                 # CUDA by default
    state = trainer.init_state(len(train_loader), state_dict)
    state = trainer.fit(state, train_loader, val_loader, seed)

One train step is forward, the losses (CE over the anticipated actions,
weighted and excluding a class where the config says so, as
``proposed_depth``'s does; duration MSE; segmentation CE), backward and an
AdamW update, with the BatchNorm running statistics of the fusion models
updated in place by the forward. The fusion models take (features, depth,
mask), the others (features, mask). Epoch 0 trains in train mode
(batch-statistics BN, dropout); with sticky eval (COMPAT #37, both loops)
epochs >= 1 train the module-eval forward with gradients on
(``model.eval()``: running-statistics BN, no dropout), which is exactly the
JAX package's ``_model_for(frozen=True)``. Validation runs the module-eval
forward without the pad mask. Metrics accumulate on the device and are read
once per epoch; the best gate (``proposed_depth``: either of two metrics;
``futr``: the class accuracy alone) and the log lines are the JAX
package's.

``fit`` takes JAX's ``checkpointer`` (``train/checkpoint.py``: the best
gate saves ``seed_{s}_checkpoint{e}`` and ``seed_{s}_best``, every epoch
``seed_{s}_last``), ``metrics_logger`` (one record an epoch, the JAX
package's fields) and ``start_epoch`` (a resume).

Not ported yet, and raising ``NotImplementedError`` naming their ROADMAP
item: other loops (item 12), ``steps_per_dispatch > 1``, ``grad_accum > 1``
and ``rng_impl`` (item 10). Meshes (item 14) have no argument. ``fit``
ignores ``device_cache``, as JAX's ``Trainer.fit`` does.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from r3d_tpu_torch.config import Config
from r3d_tpu_torch.losses.classification import (
    accuracy_counts,
    cross_entropy_loss,
    weighted_cross_entropy_loss,
)
from r3d_tpu_torch.losses.duration import duration_loss
from r3d_tpu_torch.models import build_model, init_weights, is_fusion_model
from r3d_tpu_torch.models.layers import set_generators
from r3d_tpu_torch.ops.effective_rank import effective_rank, effective_rank_loss
from r3d_tpu_torch.serving import resolve_device
from r3d_tpu_torch.train.optim import make_optimizer
from r3d_tpu_torch.train.state import TrainState

_FLOAT_STREAMS = ("features", "depth_features", "trans_future_dur")
INIT_SEED = 0  # the seeded init without a state_dict
LOOPS = ("proposed_depth", "futr")


def last_non_padding_labels(past_label: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """[B, S] -> [B]: the last non-pad label of each row; pad_idx if the row
    is all pad (train_proposed_depth.py:28-50)."""
    S = past_label.shape[1]
    valid = past_label != pad_idx
    pos = torch.where(valid, torch.arange(S, device=past_label.device)[None, :], -1)
    last = past_label.gather(-1, pos.argmax(-1)[:, None])[:, 0]
    return torch.where(valid.any(-1), last, torch.full_like(last, pad_idx))


class Trainer:
    """Train and eval steps for a Config, and the epoch loop."""

    def __init__(self, config: Config, n_class: int,
                 device: Union[str, torch.device] = "cuda"):
        tc = config.train
        if tc.loop not in LOOPS:
            raise NotImplementedError(
                f"loop {tc.loop!r} is not ported yet (ROADMAP queue A, item 12)")
        if tc.steps_per_dispatch > 1 or tc.grad_accum > 1 or tc.rng_impl is not None:
            raise NotImplementedError(
                "steps_per_dispatch > 1, grad_accum > 1 and rng_impl are not ported yet "
                "(ROADMAP queue A, item 10)")
        self.device = resolve_device(device)
        self.config = config
        self.n_class = n_class
        self.pad_idx = n_class + 1  # main_utkinects.py:109
        self.is_fusion = is_fusion_model(config.model.model)
        se = tc.sticky_eval
        # every ported loop is sticky by default (r3d_tpu/train/loop.py:86-91)
        self.sticky_eval = True if se is None else bool(se)
        self.best_epochs = []   # epochs at which the best gate opened

    def _sticky(self, epoch: int) -> bool:
        """True when this training epoch runs the module-eval forward: the
        reference's first validate (end of epoch 0) flips the module to eval
        and the loop never flips it back."""
        return self.sticky_eval and epoch >= 1

    # ------------------------------------------------------------------ setup
    def init_state(self, steps_per_epoch: int,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                   seed: int = INIT_SEED) -> TrainState:
        """The model on the trainer's device, from ``state_dict`` (e.g.
        ``convert.state_dict_from_flax`` of the JAX init) or, without one,
        from ``init_weights`` under ``seed``; AdamW at update 0."""
        cfg = self.config
        model = build_model(cfg.model, self.n_class, cfg.data.depth_shape)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        model.to(self.device)
        optimizer, schedule = make_optimizer(cfg.train, model.parameters(), steps_per_epoch)
        return TrainState(model, optimizer, schedule)

    def to_device(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A host batch on the card: float streams keep their dtype, labels
        become int64 (torch's index type)."""
        return {k: v.to(self.device, non_blocking=True) if k in _FLOAT_STREAMS
                else v.to(self.device, non_blocking=True).long() for k, v in batch.items()}

    def _model_inputs(self, batch, with_mask: bool) -> Tuple:
        mask = (batch["past_label"] == self.pad_idx) if with_mask else None
        if self.is_fusion:
            return batch["features"], batch["depth_features"], mask
        return batch["features"], mask

    # ------------------------------------------------------------- loss logic
    def _losses(self, outputs, batch, train: bool = True):
        """(total, metrics) of the ``proposed_depth`` and ``futr`` loops: the
        JAX ``Trainer._losses`` branches those loops take."""
        cfg = self.config
        pad = self.pad_idx
        excl = cfg.train.exclude_class_idx
        past_label = batch["past_label"]
        target = batch["trans_future_target"]
        dur = batch["trans_future_dur"]
        dur_mask = (dur != pad).float()
        total = torch.zeros((), device=past_label.device)
        metrics: Dict[str, torch.Tensor] = {}

        if cfg.model.seg and "seg" in outputs:
            seg = outputs["seg"]
            seg_flat = seg.reshape(-1, seg.shape[-1])
            gold = past_label.reshape(-1)
            loss_seg, _ = cross_entropy_loss(seg_flat, gold, pad, excl)
            nc, nw = accuracy_counts(seg_flat, gold, pad, excl)
            total = total + loss_seg
            metrics.update(loss_seg=loss_seg, seg_correct=nc, seg_total=nw)

        if cfg.model.anticipate:
            act = outputs["action"]
            act_flat = act.reshape(-1, act.shape[-1])
            gold_t = target.reshape(-1)
            if cfg.train.weighted_ce:
                reference = last_non_padding_labels(past_label, pad)
                loss_cls, _ = weighted_cross_entropy_loss(
                    act_flat, gold_t, pad, reference, target[:, 0], excl)
            else:
                loss_cls, _ = cross_entropy_loss(act_flat, gold_t, pad, excl)
            nc, nw = accuracy_counts(act_flat, gold_t, pad, excl)
            total = total + loss_cls
            metrics.update(loss_cls=loss_cls, cls_correct=nc, cls_total=nw)
            if not train:
                # the reference validate's "weighted accuracy": per-example
                # accuracy over non-pad slots, no exclude class, mean over rows
                nonpad = target != pad
                row_nc = ((act.argmax(-1) == target) & nonpad).sum(1)
                row_nw = nonpad.sum(1)
                row_acc = torch.where(row_nw > 0, row_nc / row_nw.clamp_min(1),
                                      torch.zeros((), device=act.device))
                metrics["weight_acc_sum"] = row_acc.sum().float()
                metrics["weight_acc_cnt"] = torch.tensor(float(target.shape[0]),
                                                         device=act.device)
            if "duration" in outputs:
                loss_dur = duration_loss(outputs["duration"], dur * dur_mask, dur_mask)
                total = total + loss_dur
                metrics.update(loss_dur=loss_dur)

        m = cfg.model
        if "fused" in outputs and (m.erank_weight > 0.0 or m.log_erank):
            valid = (past_label != pad).float()
            if m.erank_weight > 0.0:
                loss_rank = effective_rank_loss(outputs["fused"], valid, m.erank_target)
                total = total + m.erank_weight * loss_rank
                metrics.update(loss_erank=loss_rank)
            if m.log_erank and (not train or m.erank_weight > 0.0):
                metrics.update(erank=effective_rank(outputs["fused"].detach(), valid).mean())

        metrics["loss"] = total
        return total, metrics

    # ------------------------------------------------------------- train step
    def _grad_core(self, model, batch) -> Dict[str, torch.Tensor]:
        """Forward + losses + backward of one batch on the card; the
        gradients land in the parameters' ``.grad``."""
        outputs = model(*self._model_inputs(batch, with_mask=True))
        total, metrics = self._losses(outputs, batch, train=True)
        total.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, state: TrainState, batch, epoch: int) -> Dict[str, torch.Tensor]:
        """One update of ``state`` in place from a host batch; returns the
        step's metrics on the device (not synchronised)."""
        state.model.train(not self._sticky(epoch))
        state.optimizer.zero_grad(set_to_none=True)
        metrics = self._grad_core(state.model, self.to_device(batch))
        state.apply_gradients()
        return metrics

    def make_eval_step(self):
        """eval_step(state, host batch) -> metrics on the device: the
        module-eval forward without pad masks (train_proposed_depth.py:52-108)."""

        def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
            state.model.eval()
            batch = self.to_device(batch)
            with torch.no_grad():
                outputs = state.model(*self._model_inputs(batch, with_mask=False))
                _, metrics = self._losses(outputs, batch, train=False)
            return metrics

        return eval_step

    # ------------------------------------------------------------ outer loop
    def fit(self, state: TrainState, train_loader, val_loader, seed: int, log=print,
            checkpointer=None, metrics_logger=None, start_epoch: int = 0) -> TrainState:
        """The epoch loop from ``start_epoch``: train (skipping batches under
        ``min_train_batch``, the BN guard), log, validate, record, gate and
        checkpoint. Dropout draws from generators seeded with ``seed`` and,
        in a resumed run, its start epoch (JAX folds it into its key)."""
        cfg = self.config.train
        eval_step = self.make_eval_step()
        dropout_seed = seed if start_epoch == 0 else hash((seed, start_epoch)) & (2**63 - 1)
        gen = torch.Generator(self.device).manual_seed(dropout_seed)
        set_generators(state.model, gen, torch.Generator().manual_seed(dropout_seed))
        best = (0.0, 0.0)
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            agg: Dict[str, torch.Tensor] = {}
            n_batches = n_clips = 0
            for batch in train_loader:
                if batch["features"].shape[0] < cfg.min_train_batch:
                    continue  # BN guard (train_proposed_depth.py:148)
                metrics = self.train_step(state, batch, epoch)
                n_clips += batch["features"].shape[0]
                n_batches += 1
                for k, v in metrics.items():
                    agg[k] = agg.get(k, 0.0) + v
            best = self._finish_epoch(
                state, epoch, _to_host(agg), n_batches, n_clips, time.time() - t0,
                lambda st: self._validate(st, eval_step, val_loader), best, log,
                seed=seed, metrics_logger=metrics_logger, checkpointer=checkpointer)
        return state

    def _finish_epoch(self, state, epoch, agg, n_batches, n_clips, dt, validate, best, log,
                      seed=0, metrics_logger=None, checkpointer=None):
        """Train log line, validation, the metrics record
        (``r3d_tpu/train/loop.py:1066-1079``) and the best gate: ``futr``
        gates on the class accuracy alone (train.py:63), ``proposed_depth``
        on either metric and overwrites both bests
        (train_proposed_depth.py:237-241). An open gate saves the best
        checkpoints; every epoch saves the last. Returns (best_val_acc,
        best_weight_acc)."""
        cfg = self.config.train
        best_val_acc, best_weight_acc = best
        loss = agg.get("loss", 0.0) / max(n_batches, 1)
        acc = agg.get("cls_correct", 0.0) / max(agg.get("cls_total", 0.0), 1.0)
        log(f"Epoch [{epoch + 1}/{cfg.epochs}] Loss : {loss:.3f} "
            f"Acc : {acc:.3f} ({n_clips / max(dt, 1e-9):.1f} clips/s)")
        vagg, vb = validate(state)
        val_acc = vagg.get("cls_correct", 0.0) / max(vagg.get("cls_total", 0.0), 1.0)
        val_loss = vagg.get("loss", 0.0) / max(vb, 1)
        weight_acc = vagg.get("weight_acc_sum", 0.0) / max(vagg.get("weight_acc_cnt", 0.0), 1.0)
        log(f"Validation Loss: {val_loss:.3f}, Class Accuracy: {val_acc:.3f}, "
            f"Weighted Accuracy: {weight_acc:.3f}")
        if metrics_logger is not None:
            rec = {f"train_{k}": v / max(n_batches, 1) for k, v in agg.items()}
            rec.update(epoch=epoch, seed=seed, train_acc=acc, val_loss=val_loss,
                       val_acc=val_acc, val_weight_acc=weight_acc,
                       clips_per_sec=n_clips / max(dt, 1e-9))
            if "erank" in vagg:   # the paper's analysis curve, per epoch
                rec["val_erank"] = vagg["erank"] / max(vb, 1)
            metrics_logger.log(rec, step=int(state.step))
        two_metric = cfg.loop != "futr"
        if val_acc > best_val_acc or (two_metric and weight_acc > best_weight_acc):
            best_val_acc, best_weight_acc = val_acc, weight_acc
            self.best_epochs.append(epoch)
            if checkpointer is not None:
                checkpointer.save_best(state, seed=seed, epoch=epoch)
                log(f"Best model saved (val acc {val_acc:.3f})")
        if checkpointer is not None:
            checkpointer.save_last(state, seed=seed)
        return best_val_acc, best_weight_acc

    def _validate(self, state, eval_step, val_loader):
        """One pass over val_loader, metrics summed on the device; returns
        (float metrics, number of batches)."""
        agg: Dict[str, torch.Tensor] = {}
        vb = 0
        for batch in val_loader:
            for k, v in eval_step(state, batch).items():
                agg[k] = agg.get(k, 0.0) + v
            vb += 1
        return _to_host(agg), vb


def _to_host(agg: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Device metric sums -> floats, in one synchronisation."""
    if not agg:
        return {}
    values = torch.stack([torch.as_tensor(v).double() for v in agg.values()]).tolist()
    return dict(zip(agg.keys(), values))
