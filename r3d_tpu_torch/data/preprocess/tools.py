"""Data-prep tools of the port.

Counterpart of ``r3d_tpu/data/preprocess/tools.py``; so far only what the
gaze stream reads at load, ``gaze_csv_to_query``. The other tools (gt and
split writers, frame extraction, CLIP features) are ROADMAP item A15.
"""

from __future__ import annotations

import csv
from typing import List

import numpy as np


def gaze_csv_to_query(csv_path: str) -> np.ndarray:
    """Gaze CSV -> [N, 2] min-max-normalised (x, y) stream
    (basedataset_darai_gaze.py:169-186): the first column whose name holds
    an x, and the first whose name holds a y, each normalised as ``(v -
    min) / (max - min)`` in float64 (the reference's pandas dtype), stacked
    and cast to float32. Rows that do not parse are skipped. The caller
    windows this raw stream as ``[:int(obs_perc * N)]``: gaze is not
    subsampled by ``sample_rate`` and its length is not the frame count."""
    xs: List[float] = []
    ys: List[float] = []
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        fx = [c for c in reader.fieldnames or [] if "x" in c.lower()]
        fy = [c for c in reader.fieldnames or [] if "y" in c.lower()]
        if not fx or not fy:
            raise ValueError(f"no gaze x/y columns in {csv_path}")
        for row in reader:
            try:
                xs.append(float(row[fx[0]]))
                ys.append(float(row[fy[0]]))
            except (ValueError, TypeError):
                continue
    if not xs:
        return np.zeros((0, 2), np.float32)
    x = np.array(xs, np.float64)
    y = np.array(ys, np.float64)
    tiny = np.finfo(np.float64).tiny
    x = (x - x.min()) / max(float(x.max() - x.min()), tiny)
    y = (y - y.min()) / max(float(y.max() - y.min()), tiny)
    return np.stack([x, y], axis=1).astype(np.float32)
