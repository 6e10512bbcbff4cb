"""Structured metrics logging.

Counterpart of ``r3d_tpu/utils/metrics.py``: every epoch record lands in a
JSONL stream (one object per record) beside the checkpoints, and with
``tensorboard=True`` each numeric field of a record that has a step also
goes to a TensorBoard event file under ``log_dir/tb/<run_name>``
(``utils/tbwriter.py``). On a process group only rank 0 writes either.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from r3d_tpu_torch.parallel.mesh import is_writer
from r3d_tpu_torch.utils.tbwriter import SummaryWriter


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = "run", tensorboard: bool = False):
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._f = self._tb = None
        if is_writer():
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(self.path, "a")
            if tensorboard:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb", run_name))

    def log(self, record: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._f is None:
            return
        rec = {"time": time.time(), **record}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None and step is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)):
                    self._tb.scalar(k, v, step)
            # flushed per record like the JSONL stream: TensorBoard tails the
            # file during the run, and an unclean exit keeps every scalar
            self._tb.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


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
