"""Serving: an inference session over a FUTR model on one card.

Counterpart of ``r3d_tpu/serving.py`` (``InferenceSession`` and
``ServingQueue``):

    session = InferenceSession(config, state_dict, n_class)   # CUDA by default
    result = session.anticipate(features, depth)               # one video
    results = session.anticipate_batch(list_of_videos)

Observed windows pad to the config's buckets with exact key masking,
requests microbatch per bucket (batch padded to the next power of two), and
decode runs on the host. Inputs ship in the config's storage dtype (bf16 on
``utkinects`` and ``50salads``). The fusion models (``futr_fusion_bn``) take
features and depth, the others (``futr``, ``futr_baseline``) features only.
``ServingQueue`` coalesces concurrent requests into ``anticipate_batch``
calls.

``InferenceSession.from_checkpoint(config, ckpt_dir, seed, n_class)``
serves a seed's best checkpoint (``train/checkpoint.py``).

Not ported yet (ROADMAP): ``quantize='int8'``, ``input_dtype='uint8'``,
``mesh``, ``export`` / ``ExportedSession``.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from r3d_tpu_torch.config import Config
from r3d_tpu_torch.data.pipeline import bucket_length
from r3d_tpu_torch.eval.decode import decode_anticipation
from r3d_tpu_torch.models import build_model, is_fusion_model
from r3d_tpu_torch.models.layers import DTYPES


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; CUDA raises where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "device='cpu' to run the plain PyTorch path")
    return device


class InferenceSession:
    def __init__(self, config: Config, weights: Union[Mapping[str, torch.Tensor], nn.Module],
                 n_class: int, max_batch: int = 8,
                 device: Union[str, torch.device] = "cuda"):
        """``weights``: the model's ``state_dict`` (e.g. from
        ``convert.state_dict_from_flax``) or a built module."""
        self.device = resolve_device(device)
        self.config = config
        self.n_class = n_class
        self.max_batch = max_batch
        self.is_fusion = is_fusion_model(config.model.model)
        if isinstance(weights, nn.Module):
            model = weights
        else:
            model = build_model(config.model, n_class, config.data.depth_shape)
            model.load_state_dict(weights)
        self.model = model.to(self.device).eval()
        self.in_dtype = DTYPES[config.data.feature_dtype]

    @classmethod
    def from_checkpoint(cls, config: Config, ckpt_dir: str, seed: int, n_class: int,
                        **kw) -> "InferenceSession":
        """A session over the model of checkpoint ``seed_{seed}_best`` in
        ``ckpt_dir``; ``kw`` as for the constructor."""
        from r3d_tpu_torch.train.checkpoint import Checkpointer

        model = build_model(config.model, n_class, config.data.depth_shape)
        Checkpointer(ckpt_dir).restore_model(f"seed_{seed}_best", model)
        return cls(config, model, n_class, **kw)

    def _collate(self, videos: Sequence[Dict[str, np.ndarray]], S: int
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """One chunk of videos -> host tensors (feats [B, S, D], depth
        [B, S, ...] or None, mask [B, S] with True = pad), B the next power
        of two. Overlong videos truncate to the bucket; row 0 of every
        batch row stays unmasked."""
        B = 1
        while B < len(videos):
            B *= 2
        pin = self.device.type == "cuda"
        feats = torch.zeros((B, S) + videos[0]["features"].shape[1:],
                            dtype=self.in_dtype, pin_memory=pin)
        mask = torch.ones((B, S), dtype=torch.bool)
        mask[:, 0] = False
        depth = None
        if self.is_fusion:
            depth = torch.zeros((B, S) + videos[0]["depth"].shape[1:],
                                dtype=self.in_dtype, pin_memory=pin)
        for j, v in enumerate(videos):
            r = min(v["features"].shape[0], S)
            feats[j, :r] = torch.from_numpy(np.ascontiguousarray(v["features"][:r]))
            mask[j, :r] = False
            mask[j, r:] = True
            if depth is not None:
                depth[j, :r] = torch.from_numpy(np.ascontiguousarray(v["depth"][:r]))
        return feats, depth, mask

    def _run(self, feats, depth, mask) -> Dict[str, torch.Tensor]:
        """One padded chunk -> model outputs on the device (not synced)."""
        args = (feats, depth, mask) if self.is_fusion else (feats, mask)
        with torch.inference_mode():
            return self.model(*(t.to(self.device, non_blocking=True) for t in args))

    def anticipate_batch(
        self,
        videos: Sequence[Dict[str, np.ndarray]],
        future_len: Optional[int] = None,
    ) -> List[Dict[str, np.ndarray]]:
        """videos: dicts with 'features' [S, D] (+ 'depth' [S, ...]).

        Returns per video: transcript actions + durations, decoded frame
        labels over ``future_len`` (default: observed length), seg labels.
        """
        none_idx = self.n_class - 1
        order: Dict[int, List[int]] = collections.defaultdict(list)
        for i, v in enumerate(videos):
            order[bucket_length(v["features"].shape[0],
                                self.config.data.seq_buckets)].append(i)

        results: List[Optional[Dict]] = [None] * len(videos)
        # a small window of chunks in flight: chunk j+1's copy and launch
        # overlap chunk j's compute, and device memory stays O(window)
        max_in_flight = 2
        pending: List = []

        def fetch_one():
            chunk, out = pending.pop(0)
            actions = out["action"].float().cpu().numpy()
            durs = out["duration"].float().cpu().numpy()
            segs = out["seg"].float().argmax(-1).cpu().numpy() if "seg" in out else None
            for j, i in enumerate(chunk):
                r = videos[i]["features"].shape[0]
                horizon = future_len if future_len is not None else r
                frames, norm_dur = decode_anticipation(actions[j], durs[j], horizon, none_idx)
                # overlong inputs were truncated to the last bucket on the way in
                r_seg = None if segs is None else min(r, segs.shape[1])
                results[i] = {
                    "transcript": np.argmax(actions[j], -1),
                    "durations": norm_dur,
                    "future_frames": frames,
                    "seg": None if segs is None else segs[j, :r_seg],
                }

        for S, idxs in order.items():
            for start in range(0, len(idxs), self.max_batch):
                chunk = idxs[start:start + self.max_batch]
                batch = self._collate([videos[i] for i in chunk], S)
                pending.append((chunk, self._run(*batch)))
                if len(pending) >= max_in_flight:
                    fetch_one()
        while pending:
            fetch_one()
        return results  # type: ignore[return-value]

    def anticipate(self, features: np.ndarray,
                   depth: Optional[np.ndarray] = None,
                   future_len: Optional[int] = None) -> Dict[str, np.ndarray]:
        video = {"features": features}
        if depth is not None:
            video["depth"] = depth
        return self.anticipate_batch([video], future_len)[0]


class ServingQueue:
    """Concurrent-request batching front end over an InferenceSession.

    ``submit()`` returns a Future; a background thread coalesces pending
    requests into ``anticipate_batch`` calls (up to ``session.max_batch``
    per drain, waiting at most ``max_wait_ms`` after the first request).
    """

    def __init__(self, session: InferenceSession, max_wait_ms: float = 5.0):
        self.session = session
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, features: np.ndarray,
               depth: Optional[np.ndarray] = None,
               future_len: Optional[int] = None) -> Future:
        """Enqueue one video; the Future's result is what ``anticipate``
        returns."""
        fut: Future = Future()
        video = {"features": features}
        if depth is not None:
            video["depth"] = depth
        # closed-check and put under one lock: a request enqueued after the
        # close sentinel would never resolve
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("ServingQueue is closed")
            self._q.put((video, future_len, fut))
        return fut

    def anticipate(self, features, depth=None, future_len=None):
        """Blocking convenience wrapper around submit()."""
        return self.submit(features, depth, future_len).result()

    def _loop(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if item is None:
                return
            batch = [item]
            deadline = time.time() + self.max_wait_s
            while len(batch) < self.session.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._drain(batch)
                    return
                batch.append(nxt)
            self._drain(batch)

    def _drain(self, batch):
        # anticipate_batch takes one future_len per call: group by it
        groups: Dict = collections.defaultdict(list)
        for video, future_len, fut in batch:
            groups[future_len].append((video, fut))
        for future_len, items in groups.items():
            try:
                results = self.session.anticipate_batch([v for v, _ in items], future_len)
            except Exception as e:  # surfaced on each request's future
                for _, fut in items:
                    try:
                        fut.set_exception(e)
                    except InvalidStateError:
                        pass  # client cancelled concurrently
                continue
            # the set itself is guarded: a client may cancel between any
            # check and the set, and an exception here would kill the drain
            # thread and hang every later submit()
            for (_, fut), res in zip(items, results):
                try:
                    fut.set_result(res)
                except InvalidStateError:
                    pass

    def close(self):
        """Stop accepting requests and drain the queue."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._thread.join()
