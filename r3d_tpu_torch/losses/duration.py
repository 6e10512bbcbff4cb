"""Duration head loss (counterpart of ``r3d_tpu/losses/duration.py``)."""

from __future__ import annotations

import torch


def normalize_duration(durations, mask):
    """exp -> mask -> L1 normalize along the last axis, dividing by
    max(|x|_1, 1e-12) as ``F.normalize(p=1)`` does."""
    x = torch.exp(durations) * mask.to(durations.dtype)
    return x / x.abs().sum(-1, keepdim=True).clamp_min(1e-12)


def duration_loss(pred_durations, target_durations, dur_mask, count=None):
    """Squared error of the normalized prediction against target * mask,
    summed and divided by the number of VALID duration slots (at least 1),
    or by ``count`` where the caller gives one (the rows split over a dp
    group: ``parallel.mesh.global_count``)."""
    mask = dur_mask.to(pred_durations.dtype)
    sq = (normalize_duration(pred_durations, dur_mask) - target_durations * mask) ** 2
    return sq.sum() / (mask.sum().clamp_min(1.0) if count is None else count)
