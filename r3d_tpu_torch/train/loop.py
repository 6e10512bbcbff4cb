"""The ``proposed_depth``, ``futr``, ``proposed``, ``unsupervised``,
``unimodal`` and ``tcn`` training loops on one card.

Counterpart of the loops of ``r3d_tpu/train/loop.py``:

    trainer = Trainer(config, n_class)                 # CUDA by default
    state = trainer.init_state(len(train_loader), state_dict)
    state = trainer.fit(state, train_loader, val_loader, seed)

One train step is forward, the losses (CE over the anticipated actions,
weighted and excluding a class where the config says so, as
``proposed_depth``'s does; duration MSE; segmentation CE), backward and an
AdamW update, with the BatchNorm running statistics of the fusion models
updated in place by the forward. The fusion models take (features, depth,
mask), the query models (``models.QUERY_MODELS``) (features, query,
mask, query_len: the gaze stream's true rows, else None), the others
(features, mask). ``proposed`` and ``unimodal`` are ``futr``'s losses
under the two-metric gate, ``tcn`` under the accuracy-only gate; the query
models' ``l3`` output takes no loss there, and a model without a
``duration`` head (the TCN) no duration loss. With MoE FFNs the total adds
``moe_aux_weight`` times the layers' balance terms (``moe_aux``), on every
training route.

``unsupervised`` (``darai``; train_unsupervised.py:294-362) is the
curriculum composite: the seg CE and the weighted class CE without an
exclude class, the duration MSE, the focal L3 loss (pad and exclude ids
``l3_pad_idx``, ``l3_exclude_idx``) and the temporal cluster loss over the
``l3`` logits by segment ids of the query labels (``seg_ids``, on the host
for ``fit``, on the device for ``fit_cached``); the correctness gate weighs
each frame 1 where both its L3 and its seg prediction are right, else 5,
and with ``wbar`` their mean the total is ``(1 - 1/wbar) * ((1 - wf) *
l3 + wf * cluster) + (1/wbar) * (cls + dur + seg)``, ``wf`` the triangular
warmup over ``warmup_loss_epochs``; validation sums l3 + seg + cls.
``supcon_weight > 0`` adds the SupCon term over the ``supcon`` stream.

Epoch 0 trains in train mode (batch-statistics BN, dropout); with sticky
eval (COMPAT #37: ``futr``, ``proposed_depth``, ``unsupervised`` and
``tcn``, not ``proposed`` or ``unimodal``, whose reference loops restore
train mode after every validation) epochs >= 1 train the JAX package's
``_model_for(frozen=True)``: the module-eval forward with gradients on
(``model.eval()``: running-statistics BN, the configured dropouts off),
applied as JAX applies it, with ``train=True`` (``frozen_twin``):
``futr_fusion_grad`` keeps ranking its channels by the training forward's
probe (``models.fuser.mark_sticky``), not by activation as its eval mode
does, and the dropouts whose rate is written into the model
(``FixedDropout``: the self-attention and depth sources', the TCN's) stay
on (ROADMAP C4). Validation runs
the module-eval forward without the pad mask. Metrics accumulate on the
device and are read once per epoch; the best gate (``proposed_depth``,
``proposed`` and ``unsupervised``: either of two metrics; ``futr``: the
class accuracy alone) and the log lines are the JAX package's.

``fit`` takes JAX's ``checkpointer`` (``train/checkpoint.py``: the best
gate saves ``seed_{s}_checkpoint{e}`` and ``seed_{s}_best``, every epoch
``seed_{s}_last``), ``metrics_logger`` (one record an epoch, the JAX
package's fields) and ``start_epoch`` (a resume). ``steps_per_dispatch =
K`` runs K consecutive same-shape host batches from one stacked copy
(``make_multi_step``); ``grad_accum = K`` makes one update from the mean
gradient of K microbatches (``make_accum_step``); the two exclude each
other, as in JAX.

The device cache (``data/device_cache.py``) has its own loops, JAX's:
``fit_cached`` trains from a ``DeviceCache`` on the card, each dispatch K
steps whose batches are gathered there from a [K, B] index table (no batch
copy, no host synchronisation until the epoch ends), and validates from a
val cache; ``fit_hybrid`` trains from a ``HybridCache`` in the host
loader's batch order. Both seed and draw dropout as ``fit`` does, so
``fit_cached == fit`` and ``fit_hybrid == fit``.

``Trainer(config, n_class, mesh=make_mesh(...))`` trains data-parallel
over the mesh's dp group (``parallel/mesh.py``): every rank runs the same
loop on its share of each batch (``batch_sharding``: the host batch's rows,
the cached routes' [k, B] index table along B, the hybrid batch's view ids;
every row where B does not divide), inside ``split_rows``, so the
BatchNorm statistics, the fusers' activation rankings and the duration
loss's count are the global batch's; the gradients are averaged over the
group (FSDP2 reduce-scatters those of the parameters ``shard_state``
sharded); the epoch's metric sums are reduced over the group once, before
they are logged, gated or checkpointed; the BN guard reads the global batch.
Rank 0 draws today's dropout streams, the other ranks fold their rank into
the seeds; where every rank holds the whole batch (B % W != 0) the group
takes rank 0's update and metrics, as one process would draw one set of
masks for it. Only rank 0 logs. One rank computes exactly what no mesh
does.
Families whose step mixes rows beyond that refuse a group above one rank
(``dp_refusal``).

Not ported yet, and raising ``NotImplementedError`` naming its ROADMAP
item: ``rng_impl`` (A10); mesh axes other than dp (A14).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from r3d_tpu_torch.config import Config
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.pipeline import bucket_length, pad_batch, query_fill
from r3d_tpu_torch.losses.classification import (
    accuracy_counts,
    cross_entropy_loss,
    focal_loss,
    weighted_cross_entropy_loss,
)
from r3d_tpu_torch.losses.duration import duration_loss
from r3d_tpu_torch.losses.supcon import supcon_loss
from r3d_tpu_torch.losses.temporal import (
    segment_ids_from_labels,
    segment_ids_from_labels_torch,
    temporal_cluster_loss,
)
from r3d_tpu_torch.models import (
    _QUERY_SOURCES,
    build_model,
    init_weights,
    is_fusion_model,
    model_needs_query,
)
from r3d_tpu_torch.models.fuser import mark_sticky
from r3d_tpu_torch.models.layers import FixedDropout, set_generators
from r3d_tpu_torch.models.moe import moe_aux
from r3d_tpu_torch.ops.effective_rank import effective_rank, effective_rank_loss
from r3d_tpu_torch.parallel.mesh import (
    average_gradients,
    batch_sharding,
    broadcast_buffers,
    check_mesh,
    cut,
    dp_group,
    dp_rank,
    dp_size,
    global_count,
    split_group,
    split_rows,
    take_rows,
)
from r3d_tpu_torch.serving import resolve_device
from r3d_tpu_torch.train.optim import make_optimizer
from r3d_tpu_torch.train.state import TrainState

INIT_SEED = 0  # the seeded init without a state_dict
LOOPS = ("proposed_depth", "futr", "proposed", "unsupervised", "unimodal", "tcn")
STICKY_LOOPS = ("futr", "proposed_depth", "unsupervised", "tcn")   # r3d_tpu/train/loop.py:86-91
ACCURACY_GATE_LOOPS = ("futr", "tcn")   # train.py:63, train_tcn.py:44
# metrics that are sums over rows (the others are means over a fixed number
# of entries per row): a dp group adds them up, and averages the rest
_SUM_METRICS = ("_correct", "_total", "_sum", "_cnt")


def dp_refusal(config: Config) -> Optional[str]:
    """Why ``config`` cannot train on a dp group above one rank, or None:
    its step mixes rows in a way the per-rank step does not reproduce
    (ROADMAP queue A, item A14)."""
    if config.train.loop == "unsupervised":
        return ("the unsupervised loop's correctness-gate mean, cluster and SupCon terms "
                "mix rows across the batch")
    if _QUERY_SOURCES.get(config.model.model) == "self_attention":
        return "the self-attention query source attends across the batch (COMPAT #17)"
    if config.model.moe_experts > 0:
        return "MoE routing's expert capacity is shared across the batch"
    return None


def triangular_warmup(epoch: int, start: int, peak: int, end: int) -> float:
    """train_unsupervised.get_warmup_factor:10-32: 0 -> 1 over [start,
    peak], 1 -> 0 over [peak, end], 0 outside; in fp32, as JAX computes it."""
    e = np.float32(epoch)
    up = (e - np.float32(start)) / np.float32(max(peak - start, 1))
    down = np.float32(1.0) - (e - np.float32(peak)) / np.float32(max(end - peak, 1))
    return float(np.clip(up if e < peak else down, np.float32(0.0), np.float32(1.0)))


def last_non_padding_labels(past_label: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """[B, S] -> [B]: the last non-pad label of each row; pad_idx if the row
    is all pad (train_proposed_depth.py:28-50)."""
    S = past_label.shape[1]
    valid = past_label != pad_idx
    pos = torch.where(valid, torch.arange(S, device=past_label.device)[None, :], -1)
    last = past_label.gather(-1, pos.argmax(-1)[:, None])[:, 0]
    return torch.where(valid.any(-1), last, torch.full_like(last, pad_idx))


def frozen_twin(model: torch.nn.Module) -> None:
    """Make ``model`` (already in eval mode) JAX's frozen twin of the sticky
    epochs, which runs at ``train=True`` with only the configured dropout
    rates zeroed: every ``CMFuserGrad`` ranks by the probe
    (``mark_sticky``), and every ``FixedDropout`` goes back to train mode
    (ROADMAP C4)."""
    mark_sticky(model)
    for m in model.modules():
        if isinstance(m, FixedDropout):
            m.train(True)


class Trainer:
    """Train and eval steps for a Config, and the epoch loop."""

    def __init__(self, config: Config, n_class: int,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        tc = config.train
        if tc.loop not in LOOPS:
            raise ValueError(f"unknown loop {tc.loop!r}")
        if tc.rng_impl is not None:
            raise NotImplementedError("rng_impl is not ported yet (ROADMAP queue A, item A10)")
        if tc.grad_accum > 1 and tc.steps_per_dispatch > 1:
            raise ValueError("grad_accum and steps_per_dispatch are mutually exclusive: one "
                             "stacks microbatches per update, the other updates per step")
        check_mesh(mesh)
        self.mesh = mesh
        self.dp, self.rank, self.group = dp_size(mesh), dp_rank(mesh), dp_group(mesh)
        why = dp_refusal(config) if self.dp > 1 else None
        if why is not None:
            raise NotImplementedError(f"data parallelism for {config.model.model!r} in the "
                                      f"{tc.loop!r} loop is not ported: {why} (ROADMAP queue "
                                      "A, item A14)")
        self.device = resolve_device(device)
        self.config = config
        self.n_class = n_class
        self.pad_idx = n_class + 1  # main_utkinects.py:109
        self.is_fusion = is_fusion_model(config.model.model)
        self.needs_query = model_needs_query(config.model.model)
        se = tc.sticky_eval
        self.sticky_eval = tc.loop in STICKY_LOOPS if se is None else bool(se)
        self.best_epochs = []   # epochs at which the best gate opened

    def _sticky(self, epoch: int) -> bool:
        """True when this training epoch runs the module-eval forward: the
        reference's first validate (end of epoch 0) flips the module to eval
        and the loop never flips it back."""
        return self.sticky_eval and epoch >= 1

    def _train_mode(self, model, epoch: int) -> None:
        """Train mode in epoch 0; in a sticky epoch JAX's frozen twin: the
        module-eval forward with the training forward's channel ranking and
        the fixed-rate dropouts on."""
        sticky = self._sticky(epoch)
        model.train(not sticky)
        if sticky:
            frozen_twin(model)

    # ------------------------------------------------------------- dp group
    def _rows(self, n: int) -> Optional[slice]:
        """This rank's rows of a batch of ``n`` (None: all of them)."""
        return batch_sharding(self.mesh, n) if self.dp > 1 else None

    def _split(self, rows: Optional[slice]):
        """The block's batch is split over the group where ``rows`` is set."""
        return split_rows(self.group if rows is not None else None)

    def _replicated(self) -> bool:
        """On a group, every rank holds the whole batch (``_rows`` None)."""
        return self.group is not None and split_group() is None

    def _shared(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A step's metrics for the group's sum (``_to_host``): where every
        rank held every row, rank 0's alone, its means times the group's
        size (the ranks' dropout draws differ)."""
        if not self._replicated():
            return metrics
        if self.rank:
            return {k: torch.zeros_like(v) for k, v in metrics.items()}
        return {k: v if k.endswith(_SUM_METRICS) else v * self.dp for k, v in metrics.items()}

    def _to_host(self, agg: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """Device metric sums -> floats in one synchronisation; on a group,
        summed over it, the means divided by its size."""
        if self.group is None or not agg:
            return _to_host(agg)
        v = torch.stack([torch.as_tensor(x).double() for x in agg.values()])
        torch.distributed.all_reduce(v, group=self.group)
        return {k: x if k.endswith(_SUM_METRICS) else x / self.dp
                for k, x in zip(agg.keys(), v.tolist())}

    # ------------------------------------------------------------------ setup
    def init_state(self, steps_per_epoch: int,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                   seed: int = INIT_SEED) -> TrainState:
        """The model on the trainer's device, from ``state_dict`` (e.g.
        ``convert.state_dict_from_flax`` of the JAX init) or, without one,
        from ``init_weights`` under ``seed``; AdamW at update 0. The
        schedule reads the update count, so under ``grad_accum = K`` its
        epoch is ``steps_per_epoch // K + steps_per_epoch % K`` updates long
        (``r3d_tpu/train/loop.py:126-131``)."""
        cfg = self.config
        model = build_model(cfg.model, self.n_class, cfg.data.depth_shape)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        model.to(self.device)
        ga = max(1, cfg.train.grad_accum)
        sched_steps = max(1, steps_per_epoch // ga + steps_per_epoch % ga)
        optimizer, schedule = make_optimizer(cfg.train, model.parameters(), sched_steps)
        return TrainState(model, optimizer, schedule)

    def to_device(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A host batch on the card: float streams keep their dtype, labels
        become int64 (torch's index type)."""
        return _long_labels({k: v.to(self.device, non_blocking=True) for k, v in batch.items()})

    def _index_table(self, rows: List[np.ndarray]) -> torch.Tensor:
        """[k, B] view ids on the card, copied from pinned memory without
        waiting for the card."""
        t = torch.from_numpy(np.stack(rows).astype(np.int64))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _model_inputs(self, batch, with_mask: bool) -> Tuple:
        mask = (batch["past_label"] == self.pad_idx) if with_mask else None
        if self.is_fusion:
            return batch["features"], batch["depth_features"], mask
        if self.needs_query:
            return batch["features"], batch.get("query_label"), mask, batch.get("query_len")
        return batch["features"], mask

    def _with_seg_ids(self, batch):
        """An ``unsupervised`` host batch with its ``seg_ids``: the label
        runs of the raw padded query map (``valid=None``), as
        ``r3d_tpu/train/loop.py:893-903`` derives them."""
        if self.config.train.loop != "unsupervised":
            return batch
        ids = segment_ids_from_labels(batch["query_label"].numpy(), None,
                                      self.config.train.max_segments)
        return dict(batch, seg_ids=torch.from_numpy(ids))

    # ------------------------------------------------------------- loss logic
    def _losses(self, outputs, batch, epoch: int = 0, train: bool = True):
        """(total, metrics) of the ported loops: the JAX ``Trainer._losses``
        branches they take."""
        cfg = self.config
        pad = self.pad_idx
        unsup = cfg.train.loop == "unsupervised"
        # the unsupervised loop's seg and class CE have no exclude class
        # (train_unsupervised.py:327, 340)
        excl = None if unsup else cfg.train.exclude_class_idx
        past_label = batch["past_label"]
        target = batch["trans_future_target"]
        dur = batch["trans_future_dur"]
        dur_mask = (dur != pad).float()
        zero = torch.zeros((), device=past_label.device)
        total = loss_seg = loss_cls = loss_dur = zero
        seg_correct = None
        metrics: Dict[str, torch.Tensor] = {}

        if cfg.model.seg and "seg" in outputs:
            seg = outputs["seg"]
            seg_flat = seg.reshape(-1, seg.shape[-1])
            gold = past_label.reshape(-1)
            loss_seg, seg_correct = cross_entropy_loss(seg_flat, gold, pad, excl)
            nc, nw = accuracy_counts(seg_flat, gold, pad, excl)
            total = total + loss_seg
            metrics.update(loss_seg=loss_seg, seg_correct=nc, seg_total=nw)

        if cfg.model.anticipate:
            act = outputs["action"]
            act_flat = act.reshape(-1, act.shape[-1])
            gold_t = target.reshape(-1)
            if cfg.train.weighted_ce or unsup:
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
                loss_dur = duration_loss(outputs["duration"], dur * dur_mask, dur_mask,
                                         global_count(dur_mask.sum()))
                total = total + loss_dur
                metrics.update(loss_dur=loss_dur)

        if unsup and "l3" in outputs:
            total = self._curriculum(outputs, batch, epoch, train, metrics, seg_correct,
                                     loss_seg, loss_cls, loss_dur)

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

    def _curriculum(self, outputs, batch, epoch, train, metrics, seg_correct, loss_seg,
                    loss_cls, loss_dur):
        """The ``unsupervised`` total (``r3d_tpu/train/loop.py:230-291``):
        the curriculum composite under the correctness gate in training,
        l3 + seg + cls in validation; the L3 counters go into ``metrics``."""
        tr = self.config.train
        l3 = outputs["l3"]
        l3_flat = l3.reshape(-1, l3.shape[-1])
        q_flat = batch["query_label"].reshape(-1)
        loss_l3, l3_correct = focal_loss(l3_flat, q_flat, tr.l3_pad_idx, tr.l3_exclude_idx)
        nc, nw = accuracy_counts(l3_flat, q_flat, tr.l3_pad_idx, tr.l3_exclude_idx)
        metrics.update(loss_l3=loss_l3, l3_correct=nc, l3_total=nw)
        if not train:
            # the reference validate sums l3 + seg + cls (train_unsupervised.py:147-198)
            return loss_l3 + loss_seg + loss_cls
        loss_cluster = temporal_cluster_loss(l3, batch["seg_ids"], tr.max_segments)
        metrics.update(loss_supcon=loss_cluster)
        # 1 where both the L3 and the seg prediction are right, else 5
        # (train_unsupervised.py:357)
        both = (l3_correct & seg_correct if seg_correct is not None
                else torch.zeros_like(l3_correct))
        wbar = torch.where(both, 1.0, 5.0).mean()
        wf = triangular_warmup(epoch, 0, *tr.warmup_loss_epochs)
        total = ((1.0 - 1.0 / wbar) * ((1.0 - wf) * loss_l3 + wf * loss_cluster)
                 + (1.0 / wbar) * (loss_cls + loss_dur + loss_seg))
        if tr.supcon_weight > 0.0 and "supcon" in outputs:
            # the commented "soft label loss" (train_unsupervised.py:314-319):
            # SupCon over the unit-norm per-frame embeddings against their L3
            # labels, the first supcon_samples frames, ramped to the warmup peak
            feats = outputs["supcon"].reshape(-1, outputs["supcon"].shape[-1])
            feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-6)
            n = min(tr.supcon_samples, feats.shape[0])
            loss_sc = supcon_loss(feats[:n, None, :], q_flat[:n],
                                  temperature=tr.supcon_temperature)
            ramp = float(min(np.float32(1.0), np.float32(epoch)
                             / np.float32(max(tr.warmup_loss_epochs[0], 1))))
            total = total + tr.supcon_weight * ramp * loss_sc
            metrics.update(loss_supcon2=loss_sc)
        return total

    # ------------------------------------------------------------- train step
    def _grad_core(self, model, batch, epoch: int = 0) -> Dict[str, torch.Tensor]:
        """Forward + losses + backward of one batch on the card; the
        gradients land in the parameters' ``.grad``."""
        outputs = model(*self._model_inputs(batch, with_mask=True))
        total, metrics = self._losses(outputs, batch, epoch, train=True)
        w = self.config.model.moe_aux_weight
        if self.config.model.moe_experts > 0 and w > 0.0:
            # the MoE layers' balance terms (r3d_tpu/train/loop.py:347-361)
            aux = moe_aux(model)
            total = total + w * aux
            metrics.update(moe_aux=aux, loss=total)
        if self._replicated():
            # every rank holds the whole batch: the group's mean gradient is
            # rank 0's (exact for a power-of-two group), whose dropout draws
            # are one process's; the other ranks' masks differ
            total = total * (self.dp if self.rank == 0 else 0.0)
        total.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def _step(self, state: TrainState, batch, epoch: int) -> Dict[str, torch.Tensor]:
        """One update of ``state`` in place from a batch on the card (this
        rank's rows of it on a group)."""
        self._train_mode(state.model, epoch)
        state.optimizer.zero_grad(set_to_none=True)
        metrics = self._grad_core(state.model, batch, epoch)
        average_gradients(state.model, self.group)
        state.apply_gradients()
        return self._updated(state, metrics)

    def _updated(self, state: TrainState, metrics):
        """After an update on a group from a batch every rank held whole:
        rank 0's BN statistics everywhere (the ranks' dropout draws differ)."""
        if self._replicated():
            broadcast_buffers(state.model, self.group)
        return self._shared(metrics)

    def train_step(self, state: TrainState, batch, epoch: int) -> Dict[str, torch.Tensor]:
        """One update of ``state`` in place from a host batch; returns the
        step's metrics on the device (not synchronised)."""
        rows = self._rows(batch["features"].shape[0])
        with self._split(rows):
            return self._step(state, self.to_device(take_rows(batch, rows)), epoch)

    def make_multi_step(self):
        """multi_step(state, stacked host batch [K, ...], epoch) -> metrics
        summed over K: one copy to the card, then the K steps in order,
        exactly K ``train_step`` calls (``r3d_tpu/train/loop.py:698``)."""

        def multi_step(state: TrainState, stacked, epoch: int) -> Dict[str, torch.Tensor]:
            rows = self._rows(stacked["features"].shape[1])
            stacked = self.to_device(take_rows(stacked, rows, axis=1))
            agg: Dict[str, torch.Tensor] = {}
            with self._split(rows):
                for i in range(stacked["features"].shape[0]):
                    _add(agg, self._step(state, {k: v[i] for k, v in stacked.items()}, epoch))
            return agg

        return multi_step

    def make_accum_step(self):
        """accum_step(state, stacked host batch [K, ...], epoch) -> metrics
        averaged over K: one update from the mean gradient of K microbatches
        (``r3d_tpu/train/loop.py:722``). The gradients sum in order across
        the K backward calls and divide by K (equal weights); the BN running
        statistics update per microbatch, in order; ``state.step`` advances
        by K, as it counts loader batches, while the schedule reads the
        update count, as optax's does."""

        def accum_step(state: TrainState, stacked, epoch: int) -> Dict[str, torch.Tensor]:
            rows = self._rows(stacked["features"].shape[1])
            stacked = self.to_device(take_rows(stacked, rows, axis=1))
            K = stacked["features"].shape[0]
            self._train_mode(state.model, epoch)
            state.optimizer.zero_grad(set_to_none=True)
            agg: Dict[str, torch.Tensor] = {}
            with self._split(rows):
                for i in range(K):
                    _add(agg, self._grad_core(state.model,
                                              {k: v[i] for k, v in stacked.items()}, epoch))
                average_gradients(state.model, self.group)
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(K)
                state.apply_gradients()
                state.step += K - 1
                state.extra_batches += K - 1
                return self._updated(state, {k: v / K for k, v in agg.items()})

        return accum_step

    def make_cached_train_fn(self, cache):
        """cached_multi_step(state, data, idx [K, B] on the card, S, epoch)
        -> metrics summed over K: K steps, each gathering its batch of bucket
        length ``S`` from the cache's tensors ``data``
        (``r3d_tpu/train/loop.py:770``). Nothing is copied to the card but
        ``idx``, and nothing waits for the card; an ``unsupervised`` batch
        gets its ``seg_ids`` there, from the gathered query labels."""
        sr, pad, qpad = cache.sample_rate, cache.pad_idx, cache.query_pad_idx

        def cached_multi_step(state: TrainState, data, idx: torch.Tensor, S: int,
                              epoch: int) -> Dict[str, torch.Tensor]:
            agg: Dict[str, torch.Tensor] = {}
            for ids in idx:
                batch = self._device_seg_ids(_long_labels(dc.assemble(data, ids, S, sr, pad,
                                                                      qpad)))
                _add(agg, self._step(state, batch, epoch))
            return agg

        return cached_multi_step

    def _device_seg_ids(self, batch):
        """``_with_seg_ids`` of a batch on the card (the JAX twin's
        ``segment_ids_from_labels_jnp``, ``r3d_tpu/train/loop.py:782-800``)."""
        if self.config.train.loop != "unsupervised":
            return batch
        return dict(batch, seg_ids=segment_ids_from_labels_torch(
            batch["query_label"], self.config.train.max_segments))

    def make_cached_eval_fn(self, cache):
        """cached_eval(state, data, idx [K, B], S) -> metrics summed over K:
        the validation counterpart of ``make_cached_train_fn``."""
        sr, pad, qpad = cache.sample_rate, cache.pad_idx, cache.query_pad_idx

        def cached_eval(state: TrainState, data, idx: torch.Tensor, S: int
                        ) -> Dict[str, torch.Tensor]:
            agg: Dict[str, torch.Tensor] = {}
            for ids in idx:
                _add(agg, self._eval(state, _long_labels(dc.assemble(data, ids, S, sr, pad,
                                                                     qpad))))
            return agg

        return cached_eval

    def make_hybrid_train_fn(self, hybrid):
        """hybrid_step(state, data, view_ids [B], host_pos [Bh], host_part,
        S, epoch) -> metrics: the batch's cached rows gathered on the card,
        its host rows (``host_part``, collated at their own bucket) copied,
        padded to ``S`` with ``pad_batch``'s values and put in their
        positions (``r3d_tpu/train/loop.py:1261``)."""
        cache = hybrid.cache
        sr, pad, qpad = cache.sample_rate, cache.pad_idx, cache.query_pad_idx
        fills = {"features": 0, "depth_features": 0, "past_label": pad,
                 "query_label": query_fill(pad, qpad)}

        def hybrid_step(state: TrainState, data, view_ids, host_pos, host_part, S: int,
                        epoch: int) -> Dict[str, torch.Tensor]:
            batch = dc.assemble(data, view_ids, S, sr, pad, qpad)
            for k, v in host_part.items():
                v = v.to(self.device, non_blocking=True)
                if k in fills and v.shape[1] < S:
                    full = v.new_full((v.shape[0], S) + v.shape[2:], fills[k])
                    full[:, :v.shape[1]] = v
                    v = full
                batch[k][host_pos] = v.to(batch[k].dtype)
            return self._step(state, self._device_seg_ids(_long_labels(batch)), epoch)

        return hybrid_step

    def _eval(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        state.model.eval()
        with torch.no_grad():
            outputs = state.model(*self._model_inputs(batch, with_mask=False))
            _, metrics = self._losses(outputs, batch, train=False)
        return self._shared(metrics)

    def make_eval_step(self):
        """eval_step(state, host batch) -> metrics on the device: the
        module-eval forward without pad masks (train_proposed_depth.py:52-108)."""

        def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
            rows = self._rows(batch["features"].shape[0])
            with self._split(rows):
                return self._eval(state, self.to_device(take_rows(batch, rows)))

        return eval_step

    # ------------------------------------------------------------ outer loop
    def _seed_dropout(self, state: TrainState, seed: int, start_epoch: int) -> None:
        """Dropout draws from generators seeded with ``seed`` and, in a
        resumed run, its start epoch (JAX folds it into its key); on a
        group, ranks above 0 fold in their rank."""
        dropout_seed = seed if start_epoch == 0 else hash((seed, start_epoch)) & (2**63 - 1)
        if self.rank:
            # two ranks never draw the same masks for different rows
            dropout_seed = hash((dropout_seed, -self.rank)) & (2**63 - 1)
        set_generators(state.model, torch.Generator(self.device).manual_seed(dropout_seed),
                       torch.Generator().manual_seed(dropout_seed))

    def fit(self, state: TrainState, train_loader, val_loader, seed: int, log=print,
            checkpointer=None, metrics_logger=None, start_epoch: int = 0) -> TrainState:
        """The epoch loop from ``start_epoch``: train (skipping batches under
        ``min_train_batch``, the BN guard), log, validate, record, gate and
        checkpoint."""
        cfg = self.config.train
        eval_step = self.make_eval_step()
        accum = max(1, cfg.grad_accum)
        K = accum if accum > 1 else max(1, cfg.steps_per_dispatch)
        group_step = self.make_accum_step() if accum > 1 else self.make_multi_step()

        def steps_of(epoch):
            # the BN guard (train_proposed_depth.py:148), then the seg ids
            kept = (self._with_seg_ids(b) for b in train_loader
                    if b["features"].shape[0] >= cfg.min_train_batch)
            for n, batches in _same_shape_runs(kept, _shapes, K):
                if n > 1:
                    # K steps, or one update over K microbatches
                    yield (group_step(state, _stack(batches), epoch), 1 if accum > 1 else n,
                           n * batches[0]["features"].shape[0])
                else:
                    yield (self.train_step(state, batches[0], epoch), 1,
                           batches[0]["features"].shape[0])

        return self._epochs(state, seed, start_epoch, steps_of,
                            lambda st: self._validate(st, eval_step, val_loader), log,
                            checkpointer, metrics_logger)

    def _cached_validator(self, val_loader, val_cache, K: int):
        """validate(state) -> (metrics, batches): over ``val_cache`` in the
        host val loader's order when there is one, else over ``val_loader``."""
        if val_cache is None:
            eval_step = self.make_eval_step()
            return lambda st: self._validate(st, eval_step, val_loader)
        cfg = self.config.train
        cached_eval = self.make_cached_eval_fn(val_cache)

        def validate(st):
            agg: Dict[str, torch.Tensor] = {}
            vb = 0
            plan = dc.epoch_plan(val_cache, cfg.val_batch_size or cfg.batch_size, 0, 0,
                                 shuffle=False, drop_remainder=False)
            for _, entries in _same_shape_runs(plan, _plan_shape, K):
                rows = self._rows(len(entries[0][1]))
                idx = self._index_table([cut(idx, rows) for _, idx in entries])
                with self._split(rows):
                    _add(agg, cached_eval(st, val_cache.data, idx, entries[0][0]))
                vb += len(entries)
            return self._to_host(agg), vb

        return validate

    def fit_cached(self, state: TrainState, cache, val_loader, seed: int, log=print,
                   checkpointer=None, metrics_logger=None, start_epoch: int = 0,
                   val_cache=None) -> TrainState:
        """``fit`` from a ``DeviceCache`` (``r3d_tpu/train/loop.py:1146``):
        each epoch's plan (``epoch_plan``: the host loader's shuffle by
        ``seed + epoch``, batches under ``min_train_batch`` dropped) runs in
        dispatches of up to ``steps_per_dispatch`` same-shape steps, each
        batch gathered on the card; the metrics stay there until the epoch's
        one synchronisation. Validation runs from ``val_cache`` when given,
        else from ``val_loader``."""
        cfg = self.config.train
        K = max(1, cfg.steps_per_dispatch)
        train_fn = self.make_cached_train_fn(cache)

        def steps_of(epoch):
            plan = [(S, idx) for S, idx in dc.epoch_plan(cache, cfg.batch_size, seed, epoch,
                                                         drop_remainder=False)
                    if len(idx) >= cfg.min_train_batch]
            for n, entries in _same_shape_runs(plan, _plan_shape, K):
                S, idx0 = entries[0]
                rows = self._rows(len(idx0))
                idx = self._index_table([cut(idx, rows) for _, idx in entries])
                with self._split(rows):
                    metrics = train_fn(state, cache.data, idx, S, epoch)
                yield metrics, n, n * len(idx0)

        return self._epochs(state, seed, start_epoch, steps_of,
                            self._cached_validator(val_loader, val_cache, K), log,
                            checkpointer, metrics_logger)

    def fit_hybrid(self, state: TrainState, hybrid, val_loader, seed: int, log=print,
                   checkpointer=None, metrics_logger=None, start_epoch: int = 0,
                   val_cache=None) -> TrainState:
        """``fit`` from a ``HybridCache`` (``r3d_tpu/train/loop.py:1322``):
        the host loader's batches (``hybrid_epoch_plan``), each with its
        cached rows gathered on the card and its host rows collated at their
        own bucket; one step a batch (``steps_per_dispatch`` does not apply:
        the batches differ in their host rows)."""
        cfg = self.config.train
        cache = hybrid.cache
        step_fn = self.make_hybrid_train_fn(hybrid)
        pin = self.device.type == "cuda"

        def steps_of(epoch):
            for chunk in dc.hybrid_epoch_plan(hybrid, cfg.batch_size, seed, epoch):
                if len(chunk) < cfg.min_train_batch:
                    continue   # BN guard, as fit's
                cached_id = hybrid.view_cached_id[chunk]
                host_sel = np.where(cached_id < 0)[0]
                examples = [hybrid.host_example(int(chunk[i])) for i in host_sel]
                nrows = ([int(cache.nrows_host[c]) for c in cached_id if c >= 0]
                         + [len(e.features) for e in examples])
                S = bucket_length(max(nrows), cache.buckets)   # the global batch's
                rows = self._rows(len(chunk))
                if rows is not None:
                    # this rank's view ids, and the host rows among them
                    mine = (host_sel >= rows.start) & (host_sel < rows.stop)
                    examples = [e for e, m in zip(examples, mine) if m]
                    host_sel = host_sel[mine] - rows.start
                    cached_id = cached_id[rows]
                part = {}
                if examples:
                    # the host rows at their own bucket: fewer bytes to copy
                    Sh = bucket_length(max(len(e.features) for e in examples), cache.buckets)
                    part = pad_batch(examples, cache.pad_idx, (Sh,), cache.n_query,
                                     with_depth=hybrid.with_depth,
                                     feature_dtype=cache.feature_dtype, pin_memory=pin,
                                     with_query=hybrid.with_query,
                                     query_pad_idx=cache.query_pad_idx)
                view_ids = self._index_table([np.where(cached_id >= 0, cached_id, 0)])[0]
                host_pos = self._index_table([host_sel])[0]
                with self._split(rows):
                    metrics = step_fn(state, cache.data, view_ids, host_pos, part, S, epoch)
                yield metrics, 1, len(chunk)

        return self._epochs(state, seed, start_epoch, steps_of,
                            self._cached_validator(val_loader, val_cache, 1), log,
                            checkpointer, metrics_logger)

    def _epochs(self, state: TrainState, seed: int, start_epoch: int, steps_of, validate, log,
                checkpointer, metrics_logger) -> TrainState:
        """The epoch loop of ``fit``, ``fit_cached`` and ``fit_hybrid``:
        dropout seeded, then each epoch's dispatches (``steps_of(epoch)``
        yields (metrics, batches, clips) for each) summed on the device and
        read once, and ``_finish_epoch``. Only rank 0 logs."""
        self._seed_dropout(state, seed, start_epoch)
        if self.rank:
            log = _quiet
        best = (0.0, 0.0)
        for epoch in range(start_epoch, self.config.train.epochs):
            t0 = time.time()
            agg: Dict[str, torch.Tensor] = {}
            n_batches = n_clips = 0
            for metrics, nb, nc in steps_of(epoch):
                _add(agg, metrics)
                n_batches += nb
                n_clips += nc
            best = self._finish_epoch(
                state, epoch, self._to_host(agg), n_batches, n_clips, time.time() - t0, validate,
                best, log, seed=seed, metrics_logger=metrics_logger, checkpointer=checkpointer)
        return state

    def _finish_epoch(self, state, epoch, agg, n_batches, n_clips, dt, validate, best, log,
                      seed=0, metrics_logger=None, checkpointer=None):
        """Train log line, validation, the metrics record
        (``r3d_tpu/train/loop.py:1066-1079``) and the best gate: ``futr``
        and ``tcn`` gate on the class accuracy alone (train.py:63,
        train_tcn.py:44), the others on either metric and overwrite both
        bests (train_proposed_depth.py:237-241). An open gate saves the best
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
        two_metric = cfg.loop not in ACCURACY_GATE_LOOPS
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
        return self._to_host(agg), vb


def _quiet(*_args) -> None:
    """The log of ranks above 0."""


def _long_labels(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Labels as int64 (torch's index type); float streams (features, depth,
    durations, a gaze query) as they are."""
    return {k: v if v.is_floating_point() else v.long() for k, v in batch.items()}


def _add(agg: Dict[str, torch.Tensor], metrics: Mapping[str, torch.Tensor]) -> None:
    """Sum ``metrics`` into ``agg`` on the device."""
    for k, v in metrics.items():
        agg[k] = agg.get(k, 0.0) + v


def _stack(batches: List[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Host batches stacked to [K, ...], pinned where they were."""
    out = {}
    for k, v in batches[0].items():
        buf = torch.empty((len(batches),) + tuple(v.shape), dtype=v.dtype,
                          pin_memory=v.is_pinned())
        out[k] = torch.stack([b[k] for b in batches], out=buf)
    return out


def _shapes(batch: Mapping[str, torch.Tensor]) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in batch.items()}


def _plan_shape(entry: Tuple[int, np.ndarray]) -> Tuple[int, int]:
    """An epoch plan entry's (bucket, batch size)."""
    return entry[0], len(entry[1])


def _same_shape_runs(items: Iterable, shape: Callable, K: int) -> Iterator[Tuple[int, list]]:
    """(n, items): runs of K consecutive items of one ``shape(item)``, the
    leftovers of a run one at a time (the dispatch groups of JAX's ``fit``
    and ``Trainer._group_same_shape``, ``r3d_tpu/train/loop.py:919-948,
    1117``)."""
    buf: list = []
    sig = None

    def flush():
        if len(buf) == K:
            yield K, list(buf)
        else:
            yield from ((1, [it]) for it in buf)
        buf.clear()

    for it in items:
        s = shape(it)
        if buf and s != sig:
            yield from flush()
        sig = s
        buf.append(it)
        if len(buf) == K:
            yield from flush()
    yield from flush()


def _to_host(agg: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Device metric sums -> floats, in one synchronisation."""
    if not agg:
        return {}
    values = torch.stack([torch.as_tensor(v).double() for v in agg.values()]).tolist()
    return dict(zip(agg.keys(), values))
