"""Bucketed static shapes: a sequence pads up to the smallest bucket that
holds it. Counterpart of ``r3d_tpu/data/pipeline.py:27``."""

from __future__ import annotations

from typing import Sequence


def bucket_length(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (the last bucket truncates longer
    sequences)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
