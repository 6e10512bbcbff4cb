"""MoC (mean over classes) evaluation protocol.

The port's own copy of ``r3d_tpu/eval/moc.py``: the reference's
``eval_file`` (utils.py:341-356) and the accumulation loop every predict
file runs (evaluation/predict_utkinects.py:363-390), on integer label
arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def eval_file_counts(gt: np.ndarray, recognized: np.ndarray, obs_percentage: float,
                     n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class true/false counts over the anticipated window: ``gt`` the
    whole video's labels, ``recognized`` the past labels and the decoded
    future (utils.py:341-356)."""
    last_frame = min(len(recognized), len(gt))
    start = int(obs_percentage * len(gt))
    g = gt[start:last_frame]
    r = recognized[start:last_frame]
    n_T = np.zeros(n_classes)
    n_F = np.zeros(n_classes)
    correct = g == r
    np.add.at(n_T, g[correct], 1)
    np.add.at(n_F, g[~correct], 1)
    return n_T, n_F


def moc_from_counts(n_T: np.ndarray, n_F: np.ndarray) -> float:
    """Mean over the classes with at least one frame
    (predict_utkinects.py:378-387)."""
    total = n_T + n_F
    present = total != 0
    if not np.any(present):
        return 0.0
    return float(np.mean(n_T[present] / total[present]))


class MoCAccumulator:
    """T/F counters over (eval_p, class), as every predict file accumulates
    them (predict_utkinects.py:239-240, 364-370)."""

    def __init__(self, eval_p: Sequence[float], n_classes: int):
        self.eval_p = list(eval_p)
        self.n_classes = n_classes
        self.T = np.zeros((len(self.eval_p), n_classes))
        self.F = np.zeros((len(self.eval_p), n_classes))

    def add_video(self, gt: np.ndarray, prediction: np.ndarray, obs_p: float) -> None:
        vid_len = len(gt)
        for i, p in enumerate(self.eval_p):
            eval_len = int((obs_p + p) * vid_len)
            t, f = eval_file_counts(gt, prediction[:eval_len], obs_p, self.n_classes)
            self.T[i] += t
            self.F[i] += f

    def results(self, obs_p: float) -> Dict[str, float]:
        return {f"obs{int(100 * obs_p)}_pred{int(100 * p)}": moc_from_counts(self.T[i], self.F[i])
                for i, p in enumerate(self.eval_p)}

    def print_results(self, obs_p: float) -> List[str]:
        """Reference-format result lines (predict_utkinects.py:387-389)."""
        lines = []
        for i, p in enumerate(self.eval_p):
            moc = moc_from_counts(self.T[i], self.F[i])
            line = f"obs. {int(100 * obs_p)}% pred. {int(100 * p)}% --> MoC: {moc:.4f}"
            lines.append(line)
            print(line)
        print("--------------------------------")
        return lines
