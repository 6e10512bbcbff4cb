"""Classification losses with the reference's ``utils.py`` semantics.

Counterpart of ``r3d_tpu/losses/classification.py``, with its quirks kept:

- ``cross_entropy_loss`` (``cal_loss``): masked entries contribute 0 but
  still count in the mean's denominator, plus a fixed +2.0 penalty wherever
  a valid entry is argmax-predicted as the pad class;
- ``weighted_cross_entropy_loss`` (``cal_weighted_loss``): each sequence's
  entries weigh 10 when its first future label differs from its last
  observed label, else 1; mean over all entries; no pad penalty;
- ``focal_loss``: alpha = 1, gamma = 2 on the CE, the focal weight from
  the true class's probability at the raw gold, pad entries included
  (their CE is 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _valid_mask(gold, pad_idx: int, exclude_class_idx: Optional[int]):
    mask = gold != pad_idx
    if exclude_class_idx is not None:
        mask = mask & (gold != exclude_class_idx)
    return mask


def _masked_ce(logits, gold, mask):
    """Per-entry CE, exactly 0 (and gradient-free) at masked entries."""
    safe_gold = torch.where(mask, gold, torch.zeros_like(gold))
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, safe_gold[..., None])[..., 0]
    return torch.where(mask, ce, torch.zeros_like(ce))


def cross_entropy_loss(logits, gold, pad_idx: int, exclude_class_idx: Optional[int] = None,
                       penalty_weight: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, C], gold [N] int -> (loss, correct mask)."""
    mask = _valid_mask(gold, pad_idx, exclude_class_idx)
    ce = _masked_ce(logits, gold, mask)
    pred = logits.argmax(-1)
    penalty = penalty_weight * ((pred == pad_idx) & mask).to(logits.dtype)
    return (ce + penalty).mean(), (pred == gold) & mask


def weighted_cross_entropy_loss(logits, gold, pad_idx: int, reference_labels, target_ref,
                                exclude_class_idx: Optional[int] = None,
                                weight_same: float = 1.0, weight_different: float = 10.0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B*T, C], gold [B*T]; reference_labels (last observed label)
    and target_ref (first future label) [B]."""
    mask = _valid_mask(gold, pad_idx, exclude_class_idx)
    ce = _masked_ce(logits, gold, mask)
    # Python scalars: a tensor made from one would be a blocking copy to the card
    weights = torch.where(reference_labels == target_ref, weight_same, weight_different)
    expanded = weights.repeat_interleave(ce.shape[0] // weights.shape[0])
    correct = (logits.argmax(-1) == gold) & mask
    return (ce * expanded).mean(), correct


def accuracy_counts(logits, gold, pad_idx: int, exclude_class_idx: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_correct, n_valid) as in ``cal_performance``."""
    mask = _valid_mask(gold, pad_idx, exclude_class_idx)
    return ((logits.argmax(-1) == gold) & mask).sum(), mask.sum()


def focal_loss(logits, gold, pad_idx: int, exclude_class_idx: Optional[int] = None,
               alpha: float = 1.0, gamma: float = 2.0, penalty_weight: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``focal_loss`` (utils.py:493-540): the CE weighted by alpha (1 - p)^gamma
    of the true class, mean over all entries -> (loss, correct mask). The
    weight reads the raw gold, pad entries too (their CE is 0); its gather
    index is clipped to the logits' width, since the pad and exclude ids may
    lie past it (``darai``: 47 and 48 against 48 logits)."""
    mask = _valid_mask(gold, pad_idx, exclude_class_idx)
    ce = _masked_ce(logits, gold, mask)
    probs = torch.softmax(logits, dim=-1)
    idx = gold.clamp(0, logits.shape[-1] - 1)
    true_probs = torch.gather(probs, -1, idx[..., None])[..., 0]
    pred = logits.argmax(-1)
    penalty = penalty_weight * ((pred == pad_idx) & mask).to(logits.dtype)
    loss = (alpha * (1.0 - true_probs) ** gamma * ce + penalty).mean()
    return loss, (pred == gold) & mask
