"""Supervised contrastive loss (reference loss/spc.py:65-161, Khosla et al.).

Counterpart of ``r3d_tpu/losses/supcon.py``: the 'all' and 'one' contrast
modes, with an anchor that has no positive pair dividing by 1 instead of 0.
"""

from __future__ import annotations

from typing import Optional

import torch


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, temperature: float = 0.07,
                base_temperature: float = 0.07, contrast_mode: str = "all") -> torch.Tensor:
    """features [B, n_views, D]; labels [B] or mask [B, B]."""
    if features.ndim > 3:
        features = features.reshape(features.shape[0], features.shape[1], -1)
    B, n_views = features.shape[:2]
    if labels is not None and mask is not None:
        raise ValueError("Cannot define both labels and mask")
    if labels is None and mask is None:
        mask = torch.eye(B, dtype=features.dtype, device=features.device)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).to(features.dtype)
    else:
        mask = mask.to(features.dtype)
    # [B, V, D] -> [V*B, D] (torch.cat(torch.unbind(dim=1)) order)
    contrast = torch.cat(torch.unbind(features, dim=1), dim=0)
    if contrast_mode == "one":
        anchor, anchor_count = features[:, 0], 1
    elif contrast_mode == "all":
        anchor, anchor_count = contrast, n_views
    else:
        raise ValueError(f"Unknown mode: {contrast_mode}")
    logits = anchor @ contrast.T / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    mask = mask.repeat(anchor_count, n_views)
    logits_mask = 1.0 - torch.eye(B * anchor_count, mask.shape[1], dtype=mask.dtype,
                                  device=mask.device)
    mask = mask * logits_mask
    log_prob = logits - torch.log((torch.exp(logits) * logits_mask).sum(1, keepdim=True))
    pos = mask.sum(1)
    pos = torch.where(pos < 1e-6, torch.ones_like(pos), pos)
    loss = -(temperature / base_temperature) * (mask * log_prob).sum(1) / pos
    return loss.reshape(anchor_count, B).mean()
