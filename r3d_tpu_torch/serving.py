"""Serving: an inference session over a FUTR model on one card.

Counterpart of ``r3d_tpu/serving.py`` (``InferenceSession``,
``ServingQueue`` and ``ExportedSession``):

    session = InferenceSession(config, state_dict, n_class)   # CUDA by default
    result = session.anticipate(features, depth)               # one video
    results = session.anticipate_batch(list_of_videos)

Observed windows pad to the config's buckets with exact key masking,
requests microbatch per bucket (batch padded to the next power of two), and
decode runs on the host. Inputs ship in the config's storage dtype (bf16 on
``utkinects`` and ``50salads``). The fusion models (``futr_fusion_bn``) take
features and depth, the others (``futr``, ``futr_baseline``) features only.
``ServingQueue`` coalesces concurrent requests into ``anticipate_batch``
calls, over any kind of session.

The session holds the model's tensors (parameters and buffers) in
``weights`` on the card and runs each chunk through ``ChunkProgram``: the
model called with those tensors (``torch.func.functional_call``), so that
the same module, traced, is the exported program. Two options, singly or
together, as JAX's:

- ``quantize="int8"``: the matmul weights are held as int8 with fp32
  per-output-channel scales (``ops/quant.py``) and dequantized in the
  forward at each chunk, one ``q * scale`` launch a weight;
- ``input_dtype="uint8"`` (the fusion models): the depth stream ships as
  uint8 with a per-video (lo, scale) (``quantize_depth`` on the host; uint8
  input passes through under the [0, 1] convention) and is dequantized on
  the card in fp32, ``u * scale + lo``, then cast to the storage dtype. The
  pad rows dequantize to 0.

``export(path)`` writes one ``torch.export`` program a (bucket,
power-of-two batch) shape and the weights once beside them;
``ExportedSession.load(path)`` serves that artifact without the model code.
The programs call the serving kernels (K1, K3, K6) as registered operators
(``ops/fuser_kernel.py``, ``ops/attention.py``, ``ops/cross_attention.py``),
and the routes were chosen when the program was traced: an artifact keeps
the route of the environment it was exported in (``R3D_CROSS_NATIVE``,
recorded in ``meta.json``).

``InferenceSession.from_checkpoint(config, ckpt_dir, seed, n_class)``
serves a seed's best checkpoint (``train/checkpoint.py``).

``mesh`` (``parallel.make_mesh``; JAX's ``r3d_tpu/serving.py:86-97,
282-319``): every rank of the group builds the same session and is sent
the same requests. The weights are the rank's slices under the TP and EP
rules (``parallel.mesh.place_model``; the decoder runs as the GPipe forward
on a pp axis), a chunk's padded batch is cut over dp where dp divides it
(else every rank runs it whole), each rank runs its rows (the sequence
whole, on an sp axis too) and the chunk's outputs are gathered over dp, so
every rank decodes the plain session's results. ``quantize`` and
``export`` are single-device and raise ``ValueError`` on a mesh, as JAX's.
A ``ServingQueue`` over a mesh session lets global rank 0 decide how many
requests each drain takes and broadcasts the count, so every rank forms
the same chunks whatever its own timing.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
import types
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from r3d_tpu_torch.config import Config
from r3d_tpu_torch.data.pipeline import bucket_length
from r3d_tpu_torch.eval.decode import decode_anticipation
# registers the serving kernels' operators, which an exported program calls
from r3d_tpu_torch.ops import attention as _attention  # noqa: F401
from r3d_tpu_torch.ops import cross_attention as _cross_attention  # noqa: F401
from r3d_tpu_torch.ops import fuser_kernel as _fuser_kernel  # noqa: F401
from r3d_tpu_torch.ops.quant import Weights, dequantize_state_dict, quantize_state_dict
from r3d_tpu_torch.parallel.mesh import (
    batch_sharding,
    cut,
    dp_group,
    gather_rows,
    place_model,
    split_mesh,
)

WEIGHTS_FILE = "weights.pt"
META_FILE = "meta.json"


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; CUDA raises where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "device='cpu' to run the plain PyTorch path")
    return device


def dequantize_depth(depth_u8: torch.Tensor, qp: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """uint8 depth [B, S, ...] and each row's (lo, scale), ``qp`` [B, 2]
    fp32 -> ``u * scale + lo`` in fp32, cast to ``dtype``: JAX's
    ``_maybe_dequant_input``. One ``addcmul`` launch (uint8 promotes to
    fp32 inside it), which rounds once, as a fused multiply-add: XLA
    contracts JAX's product and sum into one, and the tests hold the two
    bit-equal."""
    shape = (qp.shape[0],) + (1,) * (depth_u8.ndim - 1)
    return torch.addcmul(qp[:, 0].reshape(shape), depth_u8, qp[:, 1].reshape(shape)).to(dtype)


class ChunkProgram(nn.Module):
    """One padded chunk through ``model`` with the weights as an argument:
    what a session runs and what ``InferenceSession.export`` traces. It has
    no parameters or buffers of its own, so an exported program holds none
    of the weights."""

    def __init__(self, model: nn.Module, feature_dtype: torch.dtype):
        super().__init__()
        # not a submodule: the model's own tensors are replaced by the
        # argument and must not become the program's state
        object.__setattr__(self, "model", model)
        self.feature_dtype = feature_dtype

    def forward(self, weights: Weights, feats, depth, qp, mask) -> Dict[str, torch.Tensor]:
        """``weights``: every parameter and buffer, an int8 weight as its
        (q, scale). ``qp`` [B, 2] fp32 is each video's (lo, scale) of uint8
        ``depth``, or None for float depth; ``depth`` is None for a model
        without depth."""
        if qp is not None:
            depth = dequantize_depth(depth, qp, self.feature_dtype)
        args = (feats, mask) if depth is None else (feats, depth, mask)
        return functional_call(self.model, dequantize_state_dict(weights), args)


def export_batches(max_batch: int) -> List[int]:
    """The padded batch sizes ``anticipate_batch`` can send: powers of two
    from 1 until one reaches ``max_batch`` (past it where ``max_batch`` is
    not a power of two)."""
    batches = [1]
    while batches[-1] < max_batch:
        batches.append(2 * batches[-1])
    return batches


def _to(value, device):
    if isinstance(value, tuple):
        return tuple(t.to(device) for t in value)
    return value.to(device)


class InferenceSession:
    def __init__(self, config: Config, weights: Union[Mapping[str, torch.Tensor], nn.Module],
                 n_class: int, max_batch: int = 8,
                 device: Union[str, torch.device] = "cuda",
                 quantize: Optional[str] = None, input_dtype: Optional[str] = None,
                 mesh=None):
        """``weights``: the model's ``state_dict`` (e.g. from
        ``convert.state_dict_from_flax``) or a built module. ``quantize``:
        None or ``"int8"`` (int8 weight-only, ``ops/quant.py``).
        ``input_dtype``: None or ``"uint8"`` (uint8 depth with a per-video
        affine; fusion models only). ``mesh``: serve over the group's
        mesh (a collective of every rank: each builds the session and is
        sent the same requests)."""
        from r3d_tpu_torch.convert import flax_kernels
        from r3d_tpu_torch.models import build_model, is_fusion_model

        if mesh is not None and quantize is not None:
            raise ValueError("quantize is a single-device serving path (the TP rules key on "
                             "param paths the quantized tree restructures); build the session "
                             "without a mesh to quantize")
        self.mesh = mesh
        self.is_fusion = is_fusion_model(config.model.model)
        if input_dtype not in (None, "uint8"):
            raise ValueError(f"unknown input_dtype {input_dtype!r} (supported: None, 'uint8')")
        if input_dtype == "uint8" and not self.is_fusion:
            raise ValueError("input_dtype='uint8' quantizes the depth stream; model "
                             f"{config.model.model!r} takes no depth input")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (supported: None, 'int8')")
        self.device = resolve_device(device)
        self.config = config
        self.n_class = n_class
        self.max_batch = max_batch
        self.quantize = quantize
        self.input_dtype = input_dtype
        self.in_dtype = getattr(torch, config.data.feature_dtype)
        if isinstance(weights, nn.Module):
            model = weights
        else:
            model = build_model(config.model, n_class, config.data.depth_shape)
            model.load_state_dict(weights)
        if mesh is not None:
            place_model(model.to(self.device), mesh)
        tensors = {name: t.detach() for name, t in
                   (*model.named_parameters(), *model.named_buffers())}
        if quantize is not None:
            tensors = quantize_state_dict(tensors, flax_kernels(model))
        self.weights: Weights = {name: _to(t, self.device) for name, t in tensors.items()}
        self.program = ChunkProgram(model.eval(), self.in_dtype)
        if not isinstance(weights, nn.Module):
            model.to("meta")   # its own copy: the session's tensors are ``weights``

    @classmethod
    def from_checkpoint(cls, config: Config, ckpt_dir: str, seed: int, n_class: int,
                        **kw) -> "InferenceSession":
        """A session over the model of checkpoint ``seed_{seed}_best`` in
        ``ckpt_dir``; ``kw`` as for the constructor (``quantize``,
        ``input_dtype``, ...)."""
        from r3d_tpu_torch.models import build_model
        from r3d_tpu_torch.train.checkpoint import Checkpointer

        model = build_model(config.model, n_class, config.data.depth_shape)
        Checkpointer(ckpt_dir).restore_model(f"seed_{seed}_best", model)
        return cls(config, model, n_class, **kw)

    @staticmethod
    def quantize_depth(d: np.ndarray) -> Tuple[np.ndarray, float, float]:
        """Host-side affine min-max depth quantization -> (uint8, lo, scale),
        as JAX's. uint8 input passes through under the [0, 1] convention
        (depth is min-max normalised to [0, 1] upstream), at no host cost."""
        if d.dtype == np.uint8:
            return d, 0.0, 1.0 / 255.0
        d = np.asarray(d, np.float32)
        lo = float(d.min()) if d.size else 0.0
        hi = float(d.max()) if d.size else 0.0
        scale = max((hi - lo) / 255.0, 1e-12)
        u = np.clip(np.rint((d - lo) * (1.0 / scale)), 0, 255).astype(np.uint8)
        return u, lo, scale

    def _collate(self, videos: Sequence[Dict[str, np.ndarray]], S: int) -> Tuple:
        """One chunk of videos -> host tensors (feats [B, S, D], depth
        [B, S, ...] or None, mask [B, S] with True = pad) and, for a uint8
        session, qp [B, 2] (each row's (lo, scale); pad rows (0, 1/255)). B
        is the next power of two. Overlong videos truncate to the bucket;
        row 0 of every batch row stays unmasked."""
        B = 1
        while B < len(videos):
            B *= 2
        pin = self.device.type == "cuda"
        feats = torch.zeros((B, S) + videos[0]["features"].shape[1:],
                            dtype=self.in_dtype, pin_memory=pin)
        mask = torch.ones((B, S), dtype=torch.bool)
        mask[:, 0] = False
        depth = qp = None
        if self.is_fusion:
            d_dtype = torch.uint8 if self.input_dtype == "uint8" else self.in_dtype
            depth = torch.zeros((B, S) + videos[0]["depth"].shape[1:], dtype=d_dtype,
                                pin_memory=pin)
            if self.input_dtype == "uint8":
                qp_np = np.zeros((B, 2), np.float32)
                qp_np[:, 1] = 1.0 / 255.0
        for j, v in enumerate(videos):
            r = min(v["features"].shape[0], S)
            feats[j, :r] = torch.from_numpy(np.ascontiguousarray(v["features"][:r]))
            mask[j, :r] = False
            mask[j, r:] = True
            if depth is None:
                continue
            if self.input_dtype == "uint8":
                u, lo, scale = self.quantize_depth(v["depth"][:r])
                depth[j, :r] = torch.from_numpy(np.ascontiguousarray(u))
                qp_np[j] = (lo, scale)
            else:
                depth[j, :r] = torch.from_numpy(np.ascontiguousarray(v["depth"][:r]))
        if self.input_dtype == "uint8":
            return feats, depth, mask, torch.from_numpy(qp_np)
        return feats, depth, mask

    def _run(self, feats, depth, mask, qp=None) -> Dict[str, torch.Tensor]:
        """One padded chunk -> model outputs on the device (not synced); on
        a mesh this rank's rows of it run and the outputs are gathered over
        dp."""
        rows = None if self.mesh is None else batch_sharding(self.mesh, feats.shape[0])
        args = [None if t is None else cut(t, rows).to(self.device, non_blocking=True)
                for t in (feats, depth, qp, mask)]
        with torch.inference_mode(), split_mesh(self.mesh, rows is not None, False):
            out = self._forward(*args)
            if rows is not None:
                out = {k: gather_rows(out[k], dp_group(self.mesh))
                       for k in ("action", "duration", "seg") if k in out}
        return out

    def _forward(self, feats, depth, qp, mask) -> Dict[str, torch.Tensor]:
        return self.program(self.weights, feats, depth, qp, mask)

    def _example(self, S: int, B: int) -> Tuple:
        """Device tensors of one (bucket, batch) chunk's shapes and dtypes,
        what ``export`` traces with (their values are not read)."""
        data = self.config.data
        feats = torch.empty((B, S, self.config.model.input_dim), dtype=self.in_dtype,
                            device=self.device)
        depth = qp = None
        if self.is_fusion:
            d_dtype = torch.uint8 if self.input_dtype == "uint8" else self.in_dtype
            depth = torch.empty((B, S) + tuple(data.depth_shape), dtype=d_dtype,
                                device=self.device)
            if self.input_dtype == "uint8":
                qp = torch.zeros((B, 2), dtype=torch.float32, device=self.device)
        mask = torch.zeros((B, S), dtype=torch.bool, device=self.device)
        return feats, depth, qp, mask

    def export(self, path: str) -> None:
        """Write a deployment artifact to ``path``: ``fwd_{S}_{B}.pt2``, one
        ``torch.export`` program of ``ChunkProgram`` for each bucket S and
        each batch of ``export_batches(max_batch)`` (no decompositions run,
        so a program calls the ATen operators and the port's kernel
        operators the live forward calls); ``weights.pt``, the session's
        weights once (int8 as (q, scale)), which every program takes as its
        first argument; ``meta.json``, what ``ExportedSession`` needs to
        collate and decode, the route flags and the device type it was
        traced on. Export on the device type you will serve on."""
        if self.mesh is not None:
            raise ValueError("export() is single-device (the artifact embeds replicated "
                             "params); build the session without a mesh to export")
        os.makedirs(path, exist_ok=True)
        data = self.config.data
        torch.save({name: _to(t, "cpu") for name, t in self.weights.items()},
                   os.path.join(path, WEIGHTS_FILE))
        shapes = []
        for S in data.seq_buckets:
            for B in export_batches(self.max_batch):
                ep = torch.export.export(self.program, (self.weights, *self._example(S, B)),
                                         strict=False)
                ep.example_inputs = None   # else saved with the program: the weights and a chunk
                torch.export.save(ep, os.path.join(path, f"fwd_{S}_{B}.pt2"))
                shapes.append([S, B])
        meta = {
            "shapes": shapes, "seq_buckets": list(data.seq_buckets),
            "max_batch": self.max_batch, "n_class": self.n_class, "is_fusion": self.is_fusion,
            "feature_dtype": data.feature_dtype, "input_dim": self.config.model.input_dim,
            "depth_shape": list(data.depth_shape), "input_dtype": self.input_dtype,
            "quantize": self.quantize, "device": self.device.type,
            # the environment's route flags (ops/cross_attention.py), read while tracing
            "R3D_CROSS_NATIVE": os.environ.get("R3D_CROSS_NATIVE"),
            "R3D_FORCE_PALLAS": os.environ.get("R3D_FORCE_PALLAS"),
        }
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(meta, f)

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
    Over a session on a mesh every rank is sent the same requests in the
    same order: global rank 0 drains by its timing and broadcasts how many
    requests it took, and every other rank takes that many (its first one
    awaited before it joins the broadcast).
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
        spmd = getattr(self.session, "mesh", None) is not None
        follow = spmd and torch.distributed.get_rank() != 0
        while True:
            try:
                item = self._q.get(timeout=None if follow else 0.1)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if item is None:
                return
            batch = [item]
            if follow:   # take as many requests as rank 0 did
                batch += [self._q.get() for _ in range(_agree(0) - 1)]
                self._drain(batch)
                continue
            deadline = time.time() + self.max_wait_s
            closing = False
            while len(batch) < self.session.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    closing = True
                    break
                batch.append(nxt)
            if spmd:
                _agree(len(batch))
            self._drain(batch)
            if closing:
                return

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


def _agree(n: int) -> int:
    """Global rank 0's ``n`` on every rank (a broadcast)."""
    box = [n]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


class ExportedSession(InferenceSession):
    """Serve an ``InferenceSession.export`` artifact: the weights on the
    device once, the programs loaded lazily per (bucket, batch) shape, no
    model code and no checkpoint machinery. The same ``anticipate`` /
    ``anticipate_batch`` API, and ``ServingQueue`` serves it."""

    def __init__(self, path: str, device: Union[str, torch.device] = "cuda"):
        self.mesh = None
        self.device = resolve_device(device)
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        if meta["device"] != self.device.type:
            raise ValueError(f"the artifact at {path} was exported on {meta['device']}; "
                             f"load it on that device type, not {self.device.type}")
        self.n_class = meta["n_class"]
        self.max_batch = meta["max_batch"]
        self.is_fusion = meta["is_fusion"]
        self.quantize = meta["quantize"]
        self.input_dtype = meta["input_dtype"]
        self.in_dtype = getattr(torch, meta["feature_dtype"])
        # the config surface that collate and decode read
        self.config = types.SimpleNamespace(data=types.SimpleNamespace(
            seq_buckets=tuple(meta["seq_buckets"]), feature_dtype=meta["feature_dtype"],
            depth_shape=tuple(meta["depth_shape"])))
        self.weights = torch.load(os.path.join(path, WEIGHTS_FILE), map_location=self.device,
                                  weights_only=True)
        self._files = {(S, B): os.path.join(path, f"fwd_{S}_{B}.pt2") for S, B in meta["shapes"]}
        self._programs: Dict[Tuple[int, int], nn.Module] = {}

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda") -> "ExportedSession":
        return cls(path, device)

    def _forward(self, feats, depth, qp, mask) -> Dict[str, torch.Tensor]:
        key = (feats.shape[1], feats.shape[0])
        if key not in self._files:
            raise ValueError(f"the artifact has no program for bucket {key[0]} and batch {key[1]}")
        if key not in self._programs:
            self._programs[key] = torch.export.load(self._files[key]).module()
        return self._programs[key](self.weights, feats, depth, qp, mask)

    def export(self, path: str) -> None:
        raise NotImplementedError("already an exported artifact")
