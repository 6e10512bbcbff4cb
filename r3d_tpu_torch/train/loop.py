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

``Trainer(config, n_class, mesh=make_mesh(...))`` trains over the mesh
(``parallel/mesh.py``; the state placed by ``shard_state``): every rank
runs the same loop on its dp coordinate's share of each batch
(``batch_sharding``: the host batch's rows, the cached routes' [k, B] index
table along B, the hybrid batch's view ids; every row where B does not
divide), inside ``split_rows`` over the dp group, so the BatchNorm
statistics, the fusers' activation rankings, MoE's routing, the duration
loss's count, the unsupervised loop's correctness-gate mean, cluster
counts and SupCon frames, and the self-attention source's keys are the
global batch's; the ranks of one dp coordinate (its tp and ep ranks) hold
the same rows and their slices of the parameters (``place_model``), and
their replicated parameters stay equal bit for bit; the gradients are
averaged over the dp group (FSDP2 reduce-scatters those of the parameters
``shard_state`` sharded); the epoch's metric sums are reduced over the dp
group once, before they are logged, gated or checkpointed; the BN guard
reads the global batch. The ranks of dp coordinate 0 draw today's dropout
streams, the others fold their coordinate into the seeds (a tp or ep rank
draws its dp coordinate's whole masks and keeps its slice); where every
rank holds the whole batch (B % W != 0) the group takes rank 0's update
and metrics, as one process would draw one set of masks for it. Only rank
0 logs. One rank computes exactly what no mesh does.

On an sp axis each batch's sequence is cut too (``seq_sharding``: every
array whose axis 1 is the bucket's S, axis 2 of a stacked batch, when sp
divides S; the cached routes gather only the rank's frames on the card),
and the rows' group is the dp x sp ranks: the BatchNorm statistics, the
rankings and the duration count reduce over it, the effective rank's Gram
matrices sum over sp alone, the weighted CE reads the whole ``past_label``
row (gathered, no gradient), the gradients average over dp x sp (FSDP's
shards over sp after its reduce-scatter), and the epoch's per-frame counts
(``seg_*``, ``l3_*``) sum over dp x sp while its per-query counts
(``cls_*``, ``weight_acc_*``) sum over dp alone. The unsupervised loop's
terms keep the one-process values: the focal L3 loss and the correctness
gate's mean are means over equal frame blocks, the cluster loss sums its
per-segment statistics over sp (``losses/temporal.py``), SupCon's first
``supcon_samples`` frames are gathered over sp, then over the dp group, in
the global batch's order, and the cached routes number each row's segments
on its query labels gathered over sp, then keep the rank's frames, as the
host route numbers the whole row and cuts. A bucket sp does not divide runs
whole on every sp rank. The sp ranks of a dp coordinate share its dropout
streams.

On a pp axis (``parallel/pipeline.py``) every pp rank of a dp coordinate
holds its rows and every parameter; the decoder stack runs as the GPipe
pipeline in every step, validation and the sweep included (the cached and
hybrid routes run GPipe whatever ``pp_schedule`` says, as JAX's cached
routes call its plain step core, ``r3d_tpu/train/loop.py:770-807``), the
gradients summed over pp where the stages split the work and averaged over
dp x sp as without pp. ``pp_schedule="1f1b"`` makes ``fit``'s host-route
step ``make_1f1b_train_step``'s (``parallel/pipeline_1f1b.py``):
``make_accum_step``'s update over M microbatches, for the futr and fusion
families, raising ``ValueError`` with JAX's reason for anything else.

``rng_impl`` picks the dropout streams' base seed, as JAX's picks the
bit-generator of its base key (``r3d_tpu/train/loop.py:316-326``); the
port's streams never matched flax's, so the names keep JAX's documented
properties rather than its bits. None and ``"threefry2x32"`` seed from the
run's seed itself; ``"rbg"`` from another seed derived from it
(``dropout_base_seed``), so the same seed draws other masks. Every stream
(per step, per rank, a resumed run's, pp's per (layer, microbatch)) follows
from that base, so paths that must agree under one impl still do. Another
name raises ``ValueError``, as ``jax.random.key`` does.
"""

from __future__ import annotations

import contextlib
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
    build_model,
    init_weights,
    is_fusion_model,
    model_needs_query,
)
from r3d_tpu_torch.models.fuser import mark_sticky
from r3d_tpu_torch.models.futr import positions
from r3d_tpu_torch.models.futr_unsupervised import check_gaze_cut
from r3d_tpu_torch.models.layers import FixedDropout, set_generators
from r3d_tpu_torch.models.moe import moe_aux
from r3d_tpu_torch.ops.effective_rank import effective_rank, effective_rank_loss
from r3d_tpu_torch.parallel.mesh import (
    average_gradients,
    axis,
    batch_sharding,
    axis_size,
    broadcast_buffers,
    cut,
    dp_rank,
    dp_size,
    gather_rows,
    global_count,
    global_mean,
    grad_group,
    is_writer,
    seq_axis,
    seq_sharding,
    sp_group,
    split_mesh,
    take_rows,
    take_seq,
)
from r3d_tpu_torch.parallel.pipeline import draw_base_seed, stage_generators, stage_layers
from r3d_tpu_torch.parallel.pipeline_1f1b import pipelined_value_and_grad
from r3d_tpu_torch.parallel.tensor import cut_seq, gather_seq
from r3d_tpu_torch.serving import resolve_device
from r3d_tpu_torch.train.optim import make_optimizer
from r3d_tpu_torch.train.state import TrainState

INIT_SEED = 0  # the seeded init without a state_dict
LOOPS = ("proposed_depth", "futr", "proposed", "unsupervised", "unimodal", "tcn")
STICKY_LOOPS = ("futr", "proposed_depth", "unsupervised", "tcn")   # r3d_tpu/train/loop.py:86-91
ACCURACY_GATE_LOOPS = ("futr", "tcn")   # train.py:63, train_tcn.py:44
RNG_IMPLS = (None, "threefry2x32", "rbg")   # TrainConfig.rng_impl's values
# the "rbg" streams' tag: an integer, not a string's hash(), which Python
# salts per process (PYTHONHASHSEED), so ranks and runs would disagree
RBG_STREAM = 0x72626731
# metrics that are sums over rows (the others are means over a fixed number
# of entries per row): a dp group adds them up, and averages the rest
_SUM_METRICS = ("_correct", "_total", "_sum", "_cnt")
# the sums over frames: on a cut sequence each sp rank counts its own; the
# other sums count queries, which every sp rank holds alike
_FRAME_METRICS = ("seg_correct", "seg_total", "l3_correct", "l3_total")


def dropout_base_seed(seed: int, rng_impl: Optional[str]) -> int:
    """The dropout streams' base seed for ``rng_impl``: ``seed`` itself for
    None and ``"threefry2x32"``, another 63-bit seed drawn from (``seed``,
    ``RBG_STREAM``) for ``"rbg"``."""
    if rng_impl not in RNG_IMPLS:
        raise ValueError(f"unknown rng_impl {rng_impl!r} (supported: "
                         f"{', '.join(repr(i) for i in RNG_IMPLS)})")
    if rng_impl != "rbg":
        return seed
    state = np.random.SeedSequence([seed % 2**64, RBG_STREAM]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


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
        dropout_base_seed(0, tc.rng_impl)   # an unknown rng_impl raises here, not at fit
        if tc.grad_accum > 1 and tc.steps_per_dispatch > 1:
            raise ValueError("grad_accum and steps_per_dispatch are mutually exclusive: one "
                             "stacks microbatches per update, the other updates per step")
        check_gaze_cut(config, mesh)
        self.mesh = mesh
        self.dp, self.rank = dp_size(mesh), dp_rank(mesh)
        self.sp = axis(mesh, "sp")
        self.group = grad_group(mesh)   # the dp x sp ranks the gradients average over
        self._cut = (False, False)      # the current batch's (rows, sequence) are cut
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

    # ------------------------------------------------------------ the group
    def _rows(self, n: int) -> Optional[slice]:
        """This rank's rows of a batch of ``n`` (None: all of them)."""
        return batch_sharding(self.mesh, n) if self.dp > 1 else None

    def _seq(self, S: int) -> Optional[slice]:
        """This sp rank's frames of a bucket of ``S`` (None: all of them)."""
        return seq_sharding(self.mesh, S) if self.sp is not None else None

    @contextlib.contextmanager
    def _split(self, rows: Optional[slice], seq: Optional[slice] = None):
        """The block's batch is split over dp where ``rows`` is set and over
        sp where ``seq`` is (``split_rows`` over their group)."""
        prev = self._cut
        self._cut = (rows is not None, seq is not None)
        try:
            with split_mesh(self.mesh, *self._cut):
                yield
        finally:
            self._cut = prev

    def _replicated(self) -> bool:
        """On a dp group, every dp rank holds the whole batch (``_rows`` None)."""
        return self.dp > 1 and not self._cut[0]

    def _shared(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A step's metrics for the group's sum (``_to_host``): where every
        dp rank held every row, dp rank 0's alone, its means times dp (the
        ranks' dropout draws differ); on sp, the sums each sp rank holds
        alike (every sum where the sequence ran whole) sp rank 0's alone."""
        replicated = self._replicated()
        if replicated and self.rank:
            return {k: torch.zeros_like(v) for k, v in metrics.items()}
        alike = self.sp is not None and self.sp.rank > 0
        if not (replicated or alike):
            return metrics
        out = {}
        for k, v in metrics.items():
            if not k.endswith(_SUM_METRICS):
                out[k] = v * self.dp if replicated else v
            elif alike and not (self._cut[1] and k in _FRAME_METRICS):
                out[k] = torch.zeros_like(v)
            else:
                out[k] = v
        return out

    def _to_host(self, agg: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """Device metric sums -> floats in one synchronisation; on a group,
        summed over it, the means divided by its size."""
        if self.group is None or not agg:
            return _to_host(agg)
        v = torch.stack([torch.as_tensor(x).double() for x in agg.values()])
        torch.distributed.all_reduce(v, group=self.group)
        W = torch.distributed.get_world_size(self.group)
        return {k: x if k.endswith(_SUM_METRICS) else x / W
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
                # the whole row's last label: gathered over a cut sequence
                reference = last_non_padding_labels(gather_seq(past_label, seq_axis()), pad)
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
            # each example's Gram matrix sums over its frames: over sp where they are cut
            sp = seq_axis()
            frames = None if sp is None else sp.group
            if m.erank_weight > 0.0:
                loss_rank = effective_rank_loss(outputs["fused"], valid, m.erank_target, frames)
                total = total + m.erank_weight * loss_rank
                metrics.update(loss_erank=loss_rank)
            if m.log_erank and (not train or m.erank_weight > 0.0):
                metrics.update(erank=effective_rank(outputs["fused"].detach(), valid,
                                                    frames).mean())

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
        wbar = global_mean(torch.where(both, 1.0, 5.0), (0,))
        wf = triangular_warmup(epoch, 0, *tr.warmup_loss_epochs)
        total = ((1.0 - 1.0 / wbar) * ((1.0 - wf) * loss_l3 + wf * loss_cluster)
                 + (1.0 / wbar) * (loss_cls + loss_dur + loss_seg))
        if tr.supcon_weight > 0.0 and "supcon" in outputs:
            # the commented "soft label loss" (train_unsupervised.py:314-319):
            # SupCon over the unit-norm per-frame embeddings against their L3
            # labels, the first supcon_samples frames of the global batch in
            # its (row, frame) order: each row made whole over sp, then the
            # dp group's rows (mostly the first ranks'), gathered with their
            # gradient; ramped to the warmup peak
            sp = seq_axis()
            sc = gather_rows(gather_seq(outputs["supcon"], sp))
            feats = sc.reshape(-1, sc.shape[-1])
            n = min(tr.supcon_samples, feats.shape[0])
            feats = feats[:n]
            feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-6)
            labels = gather_rows(gather_seq(batch["query_label"], sp)).reshape(-1)[:n]
            loss_sc = supcon_loss(feats[:, None, :], labels, temperature=tr.supcon_temperature)
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
        average_gradients(state.model, self.group, sp_group(self.mesh))
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
        seq = self._seq(batch["features"].shape[1])
        with self._split(rows, seq):
            return self._step(state, self.to_device(take_seq(take_rows(batch, rows), seq)), epoch)

    # ------------------------------------------------------ the pp schedule
    def _wants_1f1b(self) -> bool:
        return self.config.mesh.pp_schedule == "1f1b" and axis_size(self.mesh, "pp") > 1

    def make_train_step(self):
        """train_step(state, host batch, epoch) -> metrics: ``train_step``,
        or on a pp mesh with ``pp_schedule="1f1b"`` the 1F1B step."""
        return self.make_1f1b_train_step() if self._wants_1f1b() else self.train_step

    def make_1f1b_train_step(self):
        """The train step scheduled 1F1B over the pp axis
        (``r3d_tpu/train/loop.py:make_1f1b_train_step``): the batch splits
        into M (``pp_microbatches``, else pp) microbatches of its rows in
        order; the pre (input embed, for the fusion models depth embed and
        fuser) runs per microbatch, the decoder's layers are the stages, the
        last stage runs the final norm, the heads and each microbatch's
        losses (``parallel/pipeline_1f1b.py``). Semantics are
        ``make_accum_step``'s over the M microbatches (their mean gradient;
        each microbatch's losses, duration count and BN statistics its own);
        ``state.step`` advances by 1.

        On dp, microbatch m is the global rows [m B/M, (m+1) B/M) and dp rank
        r pipelines microbatches [r M/dp, (r+1) M/dp) where dp divides M
        (every microbatch where it does not: rank 0's update, as one process
        would draw one set of masks); every rank runs the fusion models' pre
        over all M microbatches in order, so the BN running statistics
        advance as ``make_accum_step``'s on every rank. Anything else raises
        ``ValueError`` with JAX's reason."""
        cfg, mc = self.config.model, self.config.mesh
        pp = axis(self.mesh, "pp")
        M = mc.pp_microbatches or pp.size
        B = self.config.train.batch_size

        def bail(reason: str):
            raise ValueError(f"pp_schedule='1f1b' requested but unsupported: {reason}. "
                             "Use pp_schedule='gpipe' (the default) for this config.")

        fusion = self.is_fusion and cfg.model != "afft"
        if cfg.model != "futr" and not fusion:
            bail(f"model {cfg.model!r} (only the futr/fusion families have the pre/stage/last "
                 "split; afft has no decoder stack to pipeline, the query family reads "
                 "pre-decoder streams)")
        if self.config.train.loop not in ("futr", "proposed", "proposed_depth"):
            bail(f"loop {self.config.train.loop!r} (losses must live entirely in the last "
                 "stage; the unsupervised composite reads pre-decoder streams)")
        if cfg.use_encoder or cfg.moe_experts > 0 or cfg.sow_attn:
            bail("use_encoder/moe_experts/sow_attn")
        if not cfg.pos_emb:
            bail("pos_emb=False")
        if any(axis_size(self.mesh, a) != 1 for a in ("tp", "sp", "ep")):
            bail("tp/sp/ep > 1 (1f1b shards pp x dp only)")
        if mc.fsdp:
            bail("fsdp (grads are assembled manually)")
        if cfg.n_decoder_layers % pp.size != 0:
            bail(f"{cfg.n_decoder_layers} decoder layers do not split into {pp.size} stages")
        if B % M != 0:
            bail(f"batch {B} does not divide into {M} microbatches")
        if self.config.train.grad_accum > 1 or self.config.train.steps_per_dispatch > 1:
            bail("grad_accum/steps_per_dispatch > 1")
        split = self.dp > 1 and M % self.dp == 0
        own = (range(self.rank * M // self.dp, (self.rank + 1) * M // self.dp) if split
               else range(M))

        def step(state: TrainState, batch, epoch: int) -> Dict[str, torch.Tensor]:
            model = state.model
            self._train_mode(model, epoch)
            state.optimizer.zero_grad(set_to_none=True)
            rows = batch["features"].shape[0]
            if rows % M:
                raise ValueError(f"pp_schedule='1f1b': a batch of {rows} rows does not divide "
                                 f"into {M} microbatches")
            b = self.to_device(batch)   # the whole batch: microbatches, not rows, split dp
            S = b["features"].shape[1]
            mb = {k: list(v.chunk(M)) for k, v in b.items()}
            mask = [p == self.pad_idx for p in mb["past_label"]]
            dec = model.transformer.decoder
            pre: Dict[int, Tuple[torch.Tensor, ...]] = {}
            for m in range(M):
                if m not in own and not fusion:
                    continue
                with torch.set_grad_enabled(m in own):
                    memory = model.embed(mb["features"][m])
                    if fusion:   # the BN statistics per microbatch, in order
                        memory = model.fuser(memory, model.depth_embed(mb["depth_features"][m]))
                if m in own:
                    Bm, C = memory.shape[0], memory.shape[-1]
                    pos = positions(model.pos_embedding, S).to(memory.dtype).expand(Bm, S, C)
                    query = model.query_embed[None].to(memory.dtype).expand(Bm, -1, -1)
                    pre[m] = (memory, pos, query)
            base = draw_base_seed(dec.layers)
            mine = stage_layers(len(dec.layers), pp)

            def stage_fn(x, c, a, i):
                for li in mine:
                    with stage_generators(dec.layers[li], base, li, a["m"]):
                        x = dec.layers[li](x, c["memory"], c["pos"], c["query_pos"], a["mask"])
                return x

            def last_fn(y, c, a, i):
                outputs = model.heads(dec.norm(y), c["memory"])
                if fusion:
                    outputs["fused"] = c["memory"].float()
                return self._losses(outputs, a, epoch, train=True)

            consts = [dict(zip(("memory", "pos", "query_pos"), pre[m])) for m in own]
            aux = [{"m": m, "mask": mask[m], "past_label": mb["past_label"][m],
                    "trans_future_target": mb["trans_future_target"][m],
                    "trans_future_dur": mb["trans_future_dur"][m]} for m in own]
            inject = [torch.zeros_like(pre[m][2]) for m in own]
            stage_params = list(dec.layers.parameters())
            last_params = list(dec.norm.parameters()) + list(model.heads.parameters())
            _, sums, g_stage, g_last, _, d_consts = pipelined_value_and_grad(
                stage_fn, last_fn, stage_params, last_params, inject, consts, aux, pp)
            outs = [t for m in own for t in pre[m]]
            grads = [c[k] for c in d_consts for k in ("memory", "pos", "query_pos")]
            torch.autograd.backward(outs, [g.to(t.dtype) for t, g in zip(outs, grads)])
            for p, g in zip(stage_params + last_params, g_stage + g_last):
                p.grad = g
            # the mean over microbatches; replicated microbatches: rank 0's update
            scale = 1.0 / len(own)
            if self.dp > 1 and not split:
                scale = self.dp / M if self.rank == 0 else 0.0
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(scale)
            average_gradients(model, self.group)
            state.apply_gradients()
            if not split:
                return self._shared({k: v / M for k, v in sums.items()})
            return {k: v / (M if k.endswith(_SUM_METRICS) else len(own))
                    for k, v in sums.items()}

        return step

    def make_multi_step(self):
        """multi_step(state, stacked host batch [K, ...], epoch) -> metrics
        summed over K: one copy to the card, then the K steps in order,
        exactly K ``train_step`` calls (``r3d_tpu/train/loop.py:698``)."""

        def multi_step(state: TrainState, stacked, epoch: int) -> Dict[str, torch.Tensor]:
            rows = self._rows(stacked["features"].shape[1])
            seq = self._seq(stacked["features"].shape[2])
            stacked = self.to_device(take_seq(take_rows(stacked, rows, axis=1), seq, axis=2))
            agg: Dict[str, torch.Tensor] = {}
            with self._split(rows, seq):
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
            seq = self._seq(stacked["features"].shape[2])
            stacked = self.to_device(take_seq(take_rows(stacked, rows, axis=1), seq, axis=2))
            K = stacked["features"].shape[0]
            self._train_mode(state.model, epoch)
            state.optimizer.zero_grad(set_to_none=True)
            agg: Dict[str, torch.Tensor] = {}
            with self._split(rows, seq):
                for i in range(K):
                    _add(agg, self._grad_core(state.model,
                                              {k: v[i] for k, v in stacked.items()}, epoch))
                average_gradients(state.model, self.group, sp_group(self.mesh))
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(K)
                state.apply_gradients()
                state.step += K - 1
                state.extra_batches += K - 1
                return self._updated(state, {k: v / K for k, v in agg.items()})

        return accum_step

    def make_cached_train_fn(self, cache):
        """cached_multi_step(state, data, idx [K, B] on the card, S, epoch,
        seq) -> metrics summed over K: K steps, each gathering its batch of
        bucket length ``S`` (the frames ``seq`` of it, where given) from the
        cache's tensors ``data`` (``r3d_tpu/train/loop.py:770``). Nothing is
        copied to the card but ``idx``, and nothing waits for the card; an
        ``unsupervised`` batch gets its ``seg_ids`` there, from the gathered
        query labels."""
        sr, pad, qpad = cache.sample_rate, cache.pad_idx, cache.query_pad_idx

        def cached_multi_step(state: TrainState, data, idx: torch.Tensor, S: int,
                              epoch: int, seq: Optional[slice] = None
                              ) -> Dict[str, torch.Tensor]:
            agg: Dict[str, torch.Tensor] = {}
            for ids in idx:
                batch = self._device_seg_ids(_long_labels(dc.assemble(data, ids, S, sr, pad,
                                                                      qpad, seq)))
                _add(agg, self._step(state, batch, epoch))
            return agg

        return cached_multi_step

    def _device_seg_ids(self, batch):
        """``_with_seg_ids`` of a batch on the card (the JAX twin's
        ``segment_ids_from_labels_jnp``, ``r3d_tpu/train/loop.py:782-800``):
        on a cut sequence, of each row's query labels gathered over sp, the
        rank's frames kept, as the host route numbers the whole row."""
        if self.config.train.loop != "unsupervised":
            return batch
        sp = seq_axis()
        ids = segment_ids_from_labels_torch(gather_seq(batch["query_label"], sp),
                                            self.config.train.max_segments)
        return dict(batch, seg_ids=cut_seq(ids, sp))

    def make_cached_eval_fn(self, cache):
        """cached_eval(state, data, idx [K, B], S) -> metrics summed over K:
        the validation counterpart of ``make_cached_train_fn``."""
        sr, pad, qpad = cache.sample_rate, cache.pad_idx, cache.query_pad_idx

        def cached_eval(state: TrainState, data, idx: torch.Tensor, S: int,
                        seq: Optional[slice] = None) -> Dict[str, torch.Tensor]:
            agg: Dict[str, torch.Tensor] = {}
            for ids in idx:
                _add(agg, self._eval(state, _long_labels(dc.assemble(data, ids, S, sr, pad,
                                                                     qpad, seq))))
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
                        epoch: int, seq: Optional[slice] = None) -> Dict[str, torch.Tensor]:
            batch = dc.assemble(data, view_ids, S, sr, pad, qpad, seq)
            for k, v in host_part.items():
                v = v.to(self.device, non_blocking=True)
                if k in fills:
                    if v.shape[1] < S:
                        full = v.new_full((v.shape[0], S) + v.shape[2:], fills[k])
                        full[:, :v.shape[1]] = v
                        v = full
                    v = cut(v, seq, 1)
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
            seq = self._seq(batch["features"].shape[1])
            with self._split(rows, seq):
                return self._eval(state, self.to_device(take_seq(take_rows(batch, rows), seq)))

        return eval_step

    # ------------------------------------------------------------ outer loop
    def _seed_dropout(self, state: TrainState, seed: int, start_epoch: int) -> None:
        """Dropout draws from generators seeded with the ``rng_impl``'s base
        seed of ``seed`` and, in a resumed run, its start epoch (JAX folds
        it into its key); on a group, ranks above 0 fold in their rank."""
        base = dropout_base_seed(seed, self.config.train.rng_impl)
        dropout_seed = base if start_epoch == 0 else hash((base, start_epoch)) & (2**63 - 1)
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
        one_step = self.make_train_step()

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
                    yield (one_step(state, batches[0], epoch), 1,
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
                seq = self._seq(entries[0][0])
                idx = self._index_table([cut(idx, rows) for _, idx in entries])
                with self._split(rows, seq):
                    _add(agg, cached_eval(st, val_cache.data, idx, entries[0][0], seq))
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
                seq = self._seq(S)
                idx = self._index_table([cut(idx, rows) for _, idx in entries])
                with self._split(rows, seq):
                    metrics = train_fn(state, cache.data, idx, S, epoch, seq)
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
                seq = self._seq(S)
                with self._split(rows, seq):
                    metrics = step_fn(state, cache.data, view_ids, host_pos, part, S, epoch, seq)
                yield metrics, 1, len(chunk)

        return self._epochs(state, seed, start_epoch, steps_of,
                            self._cached_validator(val_loader, val_cache, 1), log,
                            checkpointer, metrics_logger)

    def _epochs(self, state: TrainState, seed: int, start_epoch: int, steps_of, validate, log,
                checkpointer, metrics_logger) -> TrainState:
        """The epoch loop of ``fit``, ``fit_cached`` and ``fit_hybrid``:
        dropout seeded, then each epoch's dispatches (``steps_of(epoch)``
        yields (metrics, batches, clips) for each) summed on the device and
        read once, and ``_finish_epoch``. Only global rank 0 logs."""
        self._seed_dropout(state, seed, start_epoch)
        if not is_writer():
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
