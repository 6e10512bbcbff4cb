"""Anticipation decode: transcript + durations -> frame-level prediction.

Counterpart of ``r3d_tpu/eval/decode.py:25``:

1. argmax actions over queries;
2. find the first NONE; durations from it onward are masked before
   ``normalize_duration`` (exp -> mask -> L1); if no NONE, no masking;
3. integer lengths ``(0.5 + future_len * dur).long()``;
4. paint frames: interval i covers [cum_i, cum_{i+1}); the last action also
   paints everything from its start to the end of the horizon.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def decode_anticipation(
    action_logits: np.ndarray,   # [Q, n_class]
    durations: np.ndarray,       # [Q]
    future_len: int,
    none_idx: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frame_labels [future_len] int, normalized_durations [Q])."""
    actions = np.argmax(action_logits, axis=-1)
    Q = actions.shape[0]

    none_positions = np.nonzero(actions == none_idx)[0]
    if none_positions.size > 0:
        mask = np.arange(Q) < int(none_positions[0])
    else:
        mask = np.ones(Q, dtype=bool)

    x = np.exp(durations) * mask
    norm_dur = x / max(float(np.abs(x).sum()), 1e-12)

    pred_len = (0.5 + future_len * norm_dur).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(pred_len)])
    if future_len <= 0:
        return np.zeros((0,), dtype=np.int64), norm_dur
    idx = np.searchsorted(bounds[1:], np.arange(future_len), side="right")
    return actions[np.clip(idx, 0, Q - 1)], norm_dur
