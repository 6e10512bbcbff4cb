"""Depth-stream preprocessing (reference data/*-preprocess-depth.py,
data/utkinect-xmltodepth.py, data/basedataset_utkinects.py:49-76).

Counterpart of ``r3d_tpu/data/preprocess/depth.py``, in NumPy:

- ``kinect_xml_to_depth``: one UTKinect Kinect depth frame, stored as XML
  (``<tag><width/><height/><data/></tag>``), to an [H, W] array;
- ``normalize_depth_minmax``: min-max to [0, scale];
- ``preprocess_depth_sequence``: a [T, H, W] stack resized to ``target_hw``
  and min-max normalized per frame. The resize is ``jax.image.resize``'s
  bilinear one, antialiased where it shrinks: a triangle kernel widened by
  the shrink factor, its weights normalized per output sample, computed in
  float32 and applied as one product per axis.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Tuple

import numpy as np


def kinect_xml_to_depth(file_path: str) -> np.ndarray:
    """Parse one Kinect XML depth frame -> [H, W] float array."""
    root = ET.parse(file_path).getroot()
    tag = os.path.basename(file_path).replace(".xml", "")
    node = root.find(tag)
    if node is None:
        raise ValueError(f"missing node {tag!r} in {file_path}")
    width = int(node.find("width").text)
    height = int(node.find("height").text)
    data = node.find("data")
    if data is None or not data.text:
        raise ValueError(f"empty depth data in {file_path}")
    values = np.fromstring(data.text.strip(), sep=" ")
    if values.size != width * height:
        raise ValueError(f"size mismatch: expected {width * height}, got {values.size}")
    return values.reshape(height, width)


def normalize_depth_minmax(depth: np.ndarray, scale: float = 255.0) -> np.ndarray:
    """Min-max normalize to [0, scale] (utkinect-preprocess-depth.py:30-78)."""
    lo, hi = float(depth.min()), float(depth.max())
    if hi - lo < 1e-12:
        return np.zeros_like(depth, dtype=np.float32)
    return ((depth - lo) / (hi - lo) * scale).astype(np.float32)


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of one axis (``jax.image``'s
    ``compute_weight_mat`` with the triangle kernel, antialiased,
    translation 0), rounded as XLA computes them: the sample positions with
    one rounding (a fused multiply-add), the kernel's stretch as a product
    with its reciprocal."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    centres = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    sample_f = (centres.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
         * (np.float32(1) / kernel_scale))
    w = np.maximum(np.float32(0), np.float32(1) - x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def preprocess_depth_sequence(frames: np.ndarray, target_hw: Tuple[int, int] = (160, 120),
                              normalize_scale: float = 255.0) -> np.ndarray:
    """[T, H, W] -> [T, *target_hw] float32: the bilinear resize, then each
    frame min-max normalized to [0, normalize_scale] (0 where it is flat)."""
    y = np.asarray(frames, np.float32)
    T, H, W = y.shape
    th, tw = target_hw
    if th != H:
        y = np.einsum("thw,hk->tkw", y, _bilinear_weights(H, th))
    if tw != W:
        y = np.einsum("thw,wk->thk", y, _bilinear_weights(W, tw))
    lo = y.min(axis=(1, 2), keepdims=True)
    hi = y.max(axis=(1, 2), keepdims=True)
    span = hi - lo
    out = (y - lo) / np.where(span < 1e-12, np.float32(1), span) * np.float32(normalize_scale)
    return np.where(span < 1e-12, np.float32(0), out).astype(np.float32)
