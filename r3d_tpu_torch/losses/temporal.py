"""Temporal clustering losses (reference utils.py:229-321).

Counterpart of ``r3d_tpu/losses/temporal.py``. The reference builds Python
lists of (start, end) intervals from the ground truth's label runs
(train_unsupervised.py:34-64); here, as in the JAX package, a dense map of
segment ids stands for them:

    seg_ids: [B, T] int, the run index of each frame (0..K-1), -1 for
             padded or invalid frames; K = ``max_segments``.

Each loop over clusters becomes a masked segment sum. The reference's
quirks are kept:

- intra: the sum over clusters of the mean squared deviation from the
  cluster mean (``F.mse_loss``'s mean over N*C elements), over the total
  cluster count;
- inter: the sum, over rows with more than one cluster, of pairwise
  1/(1e-5 + L2(mean_i, mean_j)), divided by ``len(cluster_means) *
  (num_clusters - 1)`` where ``num_clusters`` is the cluster count of the
  LAST such row (utils.py:317); the distance's square root sits behind a
  double ``where`` and a floor of 1e-12, so coincident means give a finite
  gradient;
- contrastive: ``fill_diagonal_(0)`` on a cluster's [N, T] positive mask
  clears absolute columns 0..N-1 (utils.py:259), the true self-pair only
  when the cluster starts at frame 0.

Inside ``parallel.mesh.split_rows`` the cluster loss's counts are the
global batch's (the existing clusters, the rows with more than one, the
cluster count of the global batch's last such row), and each rank's value
is scaled so that the ranks' mean is the global loss. On a cut sequence
(``seq_axis()``) a segment may cross the cut: each (row, segment)'s frame
count, the sums behind its mean and its squared deviations are summed over
sp (with gradients) before they are divided, so every sp rank holds each
row's whole statistics, and the per-row counts reduce over the dp group
alone (``rank_table``'s per-row group).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from r3d_tpu_torch.parallel.mesh import global_count, rank_table, seq_axis
from r3d_tpu_torch.parallel.tensor import sum_over


def segment_ids_from_labels(labels: np.ndarray, valid: Optional[np.ndarray],
                            max_segments: int) -> np.ndarray:
    """Per-frame run index from per-frame labels, on the host
    (train_unsupervised.get_cluster_intervals:34-64): a new segment starts
    wherever the label changes. The reference runs it on the raw padded
    label map, which ``valid=None`` matches; with a mask, invalid frames get
    -1. Capped at ``max_segments - 1``."""
    labels = np.asarray(labels)
    if valid is None:
        changes = np.zeros(labels.shape, dtype=np.int32)
        changes[:, 1:] = (labels[:, 1:] != labels[:, :-1]).astype(np.int32)
        return np.minimum(np.cumsum(changes, axis=1), max_segments - 1).astype(np.int32)
    out = np.full(labels.shape, -1, dtype=np.int32)
    for b in range(labels.shape[0]):
        seg, prev = -1, None
        for t in range(labels.shape[1]):
            if not valid[b, t]:
                continue
            if prev is None or labels[b, t] != prev:
                seg += 1
                prev = labels[b, t]
            out[b, t] = min(seg, max_segments - 1)
    return out


def segment_ids_from_labels_torch(labels: torch.Tensor, max_segments: int) -> torch.Tensor:
    """``segment_ids_from_labels(valid=None)`` of [B, T] labels on their
    device: the cached route derives the ids from the gathered batch."""
    changes = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    changes[:, 1:] = (labels[:, 1:] != labels[:, :-1]).to(torch.int32)
    return torch.cumsum(changes, 1).clamp_max(max_segments - 1).to(torch.int32)


def _onehot(seg_ids: torch.Tensor, max_segments: int, dtype) -> torch.Tensor:
    """[B, T] ids -> [B, T, K], all zero where the id is -1."""
    ks = torch.arange(max_segments, device=seg_ids.device)
    return (seg_ids[..., None] == ks).to(dtype)


def temporal_cluster_loss(predictions: torch.Tensor, seg_ids: torch.Tensor,
                          max_segments: int) -> torch.Tensor:
    """utils.py:271-321 on dense segment ids; predictions [B, T, C] (under
    sp the rank's T frames)."""
    B, T, C = predictions.shape
    K = max_segments
    sp = seq_axis()
    frames = None if sp is None else sp.group   # the row's other frames
    onehot = _onehot(seg_ids, K, predictions.dtype)
    counts = sum_over(onehot.sum(1), frames)                          # [B, K]
    sums = sum_over(torch.einsum("btk,btc->bkc", onehot, predictions), frames)
    means = sums / counts.clamp_min(1.0)[..., None]
    exists = counts > 0
    valid = seg_ids >= 0

    # each frame's cluster mean (an invalid frame reads cluster 0's, masked
    # below) as a product with the one-hot ids: the same values as a gather,
    # with a backward that sums in a fixed order on the card, where a
    # gather's backward scatters with atomics
    safe = seg_ids.clamp(0, K - 1)
    frame_means = torch.einsum("btk,bkc->btc", _onehot(safe, K, predictions.dtype), means)
    sq_dev = ((predictions - frame_means) ** 2).sum(-1)
    sq_dev = torch.where(valid, sq_dev, torch.zeros((), dtype=sq_dev.dtype, device=sq_dev.device))
    per_cluster = (sum_over(torch.einsum("btk,bt->bk", onehot, sq_dev), frames)
                   / (counts * C).clamp_min(1.0))
    zero = torch.zeros((), dtype=predictions.dtype, device=predictions.device)
    n_exists = global_count(exists.sum())
    if n_exists is None:
        n_exists = exists.sum().clamp_min(1)
    intra = torch.where(exists, per_cluster, zero).sum() / n_exists

    n_b = exists.sum(-1)                                               # [B]
    multi = n_b > 1
    sq = ((means[:, :, None, :] - means[:, None, :, :]) ** 2).sum(-1)   # [B, K, K]
    ks = torch.arange(K, device=predictions.device)
    pair = (exists[:, :, None] & exists[:, None, :] & (ks[:, None] < ks[None, :])
            & multi[:, None, None])
    one = torch.ones((), dtype=sq.dtype, device=sq.device)
    dist = torch.sqrt(torch.where(pair, sq.clamp_min(1e-12), one))
    inter_sum = torch.where(pair, 1.0 / (1e-5 + dist), zero).sum()
    idxs = torch.arange(B, device=predictions.device)
    last_multi = torch.where(multi, idxs, -1).max()
    last_count = torch.where(last_multi >= 0, n_b[last_multi.clamp_min(0)], 2)
    # every rank's (rows with more than one cluster, its last such row's
    # count): the global batch's last such row is the last rank's that has one
    table = rank_table(torch.stack([multi.sum(), last_count]))
    n_multi = table[:, 0].sum()
    ranks = torch.arange(table.shape[0], device=predictions.device)
    last_rank = torch.where(table[:, 0] > 0, ranks, 0).max()
    last_count = torch.where(n_multi > 0, table[last_rank, 1], 2)
    denom = (n_multi * (last_count - 1)).clamp_min(1) / table.shape[0]
    inter = torch.where(n_multi > 0, inter_sum / denom, zero)
    return intra + inter


def temporal_contrastive_loss(predictions: torch.Tensor, seg_ids: torch.Tensor,
                              max_segments: int, temperature: float = 0.07) -> torch.Tensor:
    """utils.py:229-268 on dense segment ids: per cluster, its frames
    against every frame of the sequence, -log(exp(sim) / rowsum + 1e-5) over
    the same-cluster pairs (less the diagonal quirk), averaged by the
    positive count; summed over clusters, divided by the batch."""
    B, T, C = predictions.shape
    K = max_segments
    x = predictions / predictions.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    exp_sim = torch.exp(torch.einsum("btc,bsc->bts", x, x) / temperature)
    valid = seg_ids >= 0
    log_ratio = -torch.log(exp_sim / exp_sim.sum(-1, keepdim=True) + 1e-5)
    same = (seg_ids[:, :, None] == seg_ids[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    k_ids = seg_ids.clamp(0, K - 1).long()
    t_idx = torch.arange(T, device=predictions.device)
    in_k = (k_ids[:, None, :] == torch.arange(K, device=predictions.device)[None, :, None]) \
        & valid[:, None, :]
    first_t = torch.where(in_k, t_idx[None, None, :], T).min(-1).values     # [B, K]
    start_t = torch.gather(first_t, 1, k_ids)                                # [B, T]
    quirk = t_idx[None, None, :] == (t_idx[None, :] - start_t)[:, :, None]
    pos_mask = (same & ~quirk).to(predictions.dtype)
    onehot = _onehot(k_ids, K, predictions.dtype) * valid[..., None].to(predictions.dtype)
    num = torch.einsum("btk,bts->bk", onehot, log_ratio * pos_mask)
    den = torch.einsum("btk,bts->bk", onehot, pos_mask)
    return (num / (den + 1e-5)).sum() / B
