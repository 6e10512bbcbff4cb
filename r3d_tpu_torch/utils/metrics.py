"""Structured metrics logging.

Counterpart of ``r3d_tpu/utils/metrics.py``: every epoch record lands in a
JSONL stream (one object per record) beside the checkpoints. The
TensorBoard mirror is not ported yet (ROADMAP queue A, item A15).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = "run", tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError("the TensorBoard writer is not ported yet "
                                      "(ROADMAP queue A, item A15)")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._f = open(self.path, "a")

    def log(self, record: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"time": time.time(), **record}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class Timer:
    """Step-time and clips-per-second meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._clips = 0
        self._steps = 0

    def tick(self, n_clips: int):
        self._clips += n_clips
        self._steps += 1

    @property
    def clips_per_sec(self) -> float:
        dt = time.time() - self._t0
        return self._clips / dt if dt > 0 else 0.0

    @property
    def step_ms(self) -> float:
        dt = time.time() - self._t0
        return 1e3 * dt / self._steps if self._steps else 0.0
