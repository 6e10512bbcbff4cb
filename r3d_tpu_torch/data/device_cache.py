"""Device-resident dataset cache: whole-epoch training with no per-step
batch copy.

Counterpart of ``r3d_tpu/data/device_cache.py``. The featurized
anticipation datasets are small (UTKinect: about 200 videos of 150-450
frames; 2,048-d features and 160x120 depth frames in bf16 are 2-4 GB), so
the dataset lands in the card's memory once and every batch is assembled
there:

- per-video tensors (features, labels, depth, query) padded to the longest
  video; the observation-ratio replication of the train table becomes an
  index table of (video, observed rows) views instead of copies;
- a batch is a gather of rows ``arange(S) * sample_rate`` of each view's
  video, masked to the view's observed window: exactly the arrays the host
  collate (``pipeline.pad_batch``) builds, value for value;
- an epoch needs from the host only a small [steps, B] index table
  (``Trainer.make_cached_train_fn``).

Transcripts (run-length encodings of the future window) stay a host
precompute per view. JAX's flattened [V, L, H*W] gather is a layout trick
of its compiler; here a gather is one advanced-indexing kernel over the
stored layout, and the values gathered are the same.

``HybridCache`` keeps the units that fit a budget on the card and streams
the rest through the host collate, in the host loader's exact batch order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from r3d_tpu_torch.data.pipeline import _DTYPES, bucket_length, query_fill
from r3d_tpu_torch.data.protocol import Example, indices_to_transcript, pad_transcript

MAX_BYTES = 12 << 30     # the JAX package's default cache budget
Device = Union[str, torch.device]


@dataclasses.dataclass
class DeviceCache:
    """Tensors on the card and the host's view and bucket metadata.

    ``data`` keys: ``features`` [V, Lf, D] and ``depth`` [V, Ld, ...] in the
    storage dtype, ``labels`` [V, Ll] int32, ``query`` [V, Lq] (optional),
    ``len_*`` [V] int32, and per view ``view_vid`` [N] (its video),
    ``view_nrows`` [N] (its sampled observed rows), ``view_target``
    [N, n_query] int32 and ``view_dur`` [N, n_query] fp32."""

    data: Dict[str, torch.Tensor]
    n_views: int
    nrows_host: np.ndarray          # [N] for bucket planning
    sample_rate: int
    pad_idx: int
    query_pad_idx: Optional[int]
    buckets: Sequence[int]
    n_query: int
    feature_dtype: str
    nbytes: int


def _over_budget(est: int, max_bytes: int) -> MemoryError:
    return MemoryError(f"device cache would need ~{est >> 20} MiB > budget "
                       f"{max_bytes >> 20} MiB; use the host loader")


def build_video_arrays(videos: List[Dict], feature_dtype: str = "float32",
                       max_bytes: int = MAX_BYTES, device: Device = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """Per-video tensors on ``device`` (features, labels, depth, query and
    their lengths), padded to the longest video: the substrate of the train
    cache (``build_cache``) and of the cached sweep (``assemble_eval``).
    Raises ``MemoryError`` when the estimate exceeds ``max_bytes``."""
    dtype = _DTYPES[feature_dtype]
    itemsize = 2 if feature_dtype == "bfloat16" else 4
    V = len(videos)
    len_feat = np.array([v["features"].shape[0] for v in videos], np.int32)
    len_lab = np.array([len(v["label_idx"]) for v in videos], np.int32)
    with_depth = "depth" in videos[0]
    with_query = videos[0].get("query_idx") is not None
    len_depth = (np.array([v["depth"].shape[0] for v in videos], np.int32)
                 if with_depth else np.zeros(V, np.int32))
    len_query = (np.array([len(v["query_idx"]) for v in videos], np.int32)
                 if with_query else np.zeros(V, np.int32))
    D = videos[0]["features"].shape[1]
    d_shape = tuple(videos[0]["depth"].shape[1:]) if with_depth else ()
    est = (V * int(len_feat.max()) * D * itemsize + V * int(len_lab.max()) * 4
           + (V * int(len_depth.max()) * int(np.prod(d_shape)) * itemsize
              if with_depth else 0))
    if est > max_bytes:
        raise _over_budget(est, max_bytes)

    def stack_padded(key, Lmax, dtype):
        # each video cast on the host (as pad_batch casts its rows) and copied
        # into its slot; the zero padding is made on the card
        first = np.asarray(videos[0][key])
        out = torch.zeros((V, Lmax) + first.shape[1:], dtype=dtype, device=device)
        for i, v in enumerate(videos):
            x = torch.from_numpy(np.ascontiguousarray(v[key])).to(dtype)
            out[i, :len(x)] = x
        return out

    def lengths(x):
        return torch.from_numpy(x).to(device)

    data = {"features": stack_padded("features", int(len_feat.max()), dtype),
            "labels": stack_padded("label_idx", int(len_lab.max()), torch.int32),
            "len_feat": lengths(len_feat), "len_lab": lengths(len_lab)}
    if with_depth:
        data["depth"] = stack_padded("depth", int(len_depth.max()), dtype)
        data["len_depth"] = lengths(len_depth)
    if with_query:
        q0 = np.asarray(videos[0]["query_idx"])
        continuous = q0.ndim > 1 or np.issubdtype(q0.dtype, np.floating)
        data["query"] = stack_padded("query_idx", int(len_query.max()),
                                     torch.float32 if continuous else torch.int32)
        data["len_query"] = lengths(len_query)
    return data


def build_cache(videos: List[Dict], obs_percs: Sequence[float], sample_rate: int,
                n_query: int, pad_idx: int, n_class: int, buckets: Sequence[int],
                feature_dtype: str = "float32", query_pad_idx: Optional[int] = None,
                max_bytes: int = MAX_BYTES, future_frames: Optional[int] = None,
                device: Device = "cuda") -> DeviceCache:
    """``videos``: dicts with 'features' [L, D], 'label_idx' [L] int,
    optional 'depth' [L, ...] and 'query_idx' ([L] int or [L, 2] float).
    One view per (video, ratio of ``obs_percs``), in that order. Raises
    ``MemoryError`` over ``max_bytes``."""
    none_idx = n_class - 1
    data = build_video_arrays(videos, feature_dtype, max_bytes, device)
    view_vid, view_nrows, tgts, durs = [], [], [], []
    for vi, v in enumerate(videos):
        idx = np.asarray(v["label_idx"])
        vid_len = len(idx)
        n_feat = len(v["features"])
        for obs in obs_percs:
            observed = int(obs * vid_len)
            # protocol.make_example_from_indices' future window
            pred = future_frames * sample_rate if future_frames is not None else int(
                0.5 * vid_len)
            past = idx[:observed][::sample_rate]
            # the collate truncates the labels to the feature stream's strided
            # rows; a feature file a few rows short of its labels clamps here
            feat_rows = -(-min(n_feat, observed) // sample_rate)
            future = idx[observed: observed + pred][::sample_rate]
            target, dur = pad_transcript(*indices_to_transcript(future), n_query, pad_idx,
                                         none_idx)
            view_vid.append(vi)
            view_nrows.append(min(len(past), feat_rows))
            tgts.append(target.astype(np.int32))
            durs.append(dur.astype(np.float32))
    nrows_host = np.array(view_nrows, np.int64)
    data.update(view_vid=torch.tensor(view_vid, dtype=torch.int32, device=device),
                view_nrows=torch.from_numpy(nrows_host.astype(np.int32)).to(device),
                view_target=torch.from_numpy(np.stack(tgts)).to(device),
                view_dur=torch.from_numpy(np.stack(durs)).to(device))
    nbytes = sum(t.numel() * t.element_size() for t in data.values())
    return DeviceCache(data=data, n_views=len(view_vid), nrows_host=nrows_host,
                       sample_rate=sample_rate, pad_idx=pad_idx, query_pad_idx=query_pad_idx,
                       buckets=tuple(buckets), n_query=n_query, feature_dtype=feature_dtype,
                       nbytes=nbytes)


def probe_footprint(source, cfg, max_bytes: int) -> None:
    """Estimate the cache's footprint from the npy headers before loading
    anything, so an oversized dataset is refused without filling host
    memory first. Best effort: unreadable headers defer to the check after
    loading."""
    if cfg.raw_frames:
        return
    try:
        est = 0
        itemsize = 2 if cfg.feature_dtype == "bfloat16" else 4
        lf, ld = [], []
        seen_depth = set()
        for vid, seq in source.units():
            vid_file = vid.split("/")[-1]
            lf.append(np.load(source._feature_file(vid_file, seq), mmap_mode="r").shape)
            if source.depth_path is not None:
                # multi-sequence units share one whole-video depth file: count
                # it once, not once a unit
                dpath = source._depth_file(vid_file, seq)
                if dpath not in seen_depth:
                    seen_depth.add(dpath)
                    ld.append(np.load(dpath, mmap_mode="r").shape)
        if lf:
            rows = (lambda s: s[-1]) if cfg.features_transposed else (lambda s: s[0])
            row_elems = lf[0][0] if cfg.features_transposed else int(np.prod(lf[0][1:]))
            est += len(lf) * max(rows(s) for s in lf) * row_elems * itemsize
        if ld:
            est += len(ld) * max(s[0] for s in ld) * int(np.prod(ld[0][1:])) * itemsize
    except (OSError, ValueError):
        return
    if est > max_bytes:
        raise _over_budget(est, max_bytes)


def videos_from_source(source, cfg, units=None) -> List[Dict]:
    """The arrays of every (vid, seq) unit (or of ``units``), for
    ``build_video_arrays``."""
    videos = []
    for vid, seq in source.units() if units is None else units:
        v = source.load_video(vid, seq)
        d = {"features": np.asarray(v["features"], np.float32),
             "label_idx": np.asarray(v["label_idx"])}
        if v.get("depth") is not None:
            d["depth"] = np.asarray(v["depth"], np.float32)
        if v.get("query_idx") is not None:
            d["query_idx"] = v["query_idx"]
        videos.append(d)
    return videos


def arrays_from_source(source, cfg, max_bytes: int = MAX_BYTES, device: Device = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """Probe, then load the video tensors of the cached sweep."""
    probe_footprint(source, cfg, max_bytes)
    return build_video_arrays(videos_from_source(source, cfg), cfg.feature_dtype, max_bytes,
                              device)


def _cache_kwargs(source, cfg, n_query: int, max_bytes: int, device: Device) -> Dict:
    return dict(obs_percs=cfg.train_obs_percs, sample_rate=cfg.sample_rate, n_query=n_query,
                pad_idx=source.pad_idx, n_class=source.n_class, buckets=cfg.seq_buckets,
                feature_dtype=cfg.feature_dtype,
                query_pad_idx=len(source.query_dict) if source.query_dict is not None else None,
                max_bytes=max_bytes, future_frames=cfg.future_frames, device=device)


def _refuse_gaze(cfg) -> None:
    # the gaze stream windows by its raw length, not by the frame window:
    # the in-step gather has no gaze gather (r3d_tpu/data/device_cache.py:283)
    if cfg.gaze_dir is not None:
        raise ValueError("device cache does not support gaze query streams")


def cache_from_source(source, cfg, n_query: int, max_bytes: int = MAX_BYTES,
                      device: Device = "cuda") -> DeviceCache:
    """The cache of a ``datasets.VideoSource`` (flat or multi-sequence);
    a gaze stream raises ``ValueError`` (the host loader takes it)."""
    _refuse_gaze(cfg)
    probe_footprint(source, cfg, max_bytes)
    return build_cache(videos_from_source(source, cfg),
                       **_cache_kwargs(source, cfg, n_query, max_bytes, device))


def _frames(S: int, seq: Optional[slice], device) -> torch.Tensor:
    """The window positions a batch of bucket ``S`` holds: all of them, or
    the sp rank's ``seq`` of them."""
    return torch.arange(S, device=device) if seq is None else torch.arange(
        seq.start, seq.stop, device=device)


def _gather_window(arr: torch.Tensor, vid: torch.Tensor, in_view: torch.Tensor,
                   frames: torch.Tensor, sample_rate: int, fill) -> torch.Tensor:
    """[B] video ids -> [B, len(frames), ...] strided observed windows: rows
    ``frames * sample_rate`` of each video, ``fill`` outside ``in_view``
    and past the stored length. Rows past a video's own length are zeros in
    the padded storage, as the host collate leaves them. One gather kernel
    and one in-place fill: no second copy of the batch."""
    L = arr.shape[1]
    rows = frames * sample_rate
    ok = in_view & (rows < L)[None, :]
    g = arr[vid[:, None], rows.clamp(max=L - 1)[None, :]]
    g.masked_fill_(~ok.view(ok.shape + (1,) * (g.ndim - 2)), fill)
    return g


def assemble(data: Dict[str, torch.Tensor], view_ids: torch.Tensor, S: int, sample_rate: int,
             pad_idx: int, query_pad_idx: Optional[int], seq: Optional[slice] = None
             ) -> Dict[str, torch.Tensor]:
    """The batch of views ``view_ids`` [B] at bucket length ``S``: the
    arrays ``pipeline.pad_batch`` builds (same dtypes, same pads), on the
    cache's device; with ``seq`` (an sp rank's frames) only those frames of
    the sequence streams are gathered. ``j < nrows`` puts row ``j *
    sample_rate`` inside the observed window and the label stream, so one
    mask serves every stream."""
    vid = data["view_vid"][view_ids].long()
    nrows = data["view_nrows"][view_ids]
    frames = _frames(S, seq, vid.device)
    in_view = frames[None, :] < nrows[:, None]

    def gather(arr, fill):
        return _gather_window(arr, vid, in_view, frames, sample_rate, fill)

    batch = {"features": gather(data["features"], 0),
             "past_label": gather(data["labels"], pad_idx),
             "trans_future_target": data["view_target"][view_ids],
             "trans_future_dur": data["view_dur"][view_ids]}
    if "depth" in data:
        batch["depth_features"] = gather(data["depth"], 0)
    if "query" in data:
        q = data["query"]
        qfill = 0.0 if q.is_floating_point() else query_fill(pad_idx, query_pad_idx)
        batch["query_label"] = gather(q, qfill)
    return batch


def assemble_eval(data: Dict[str, torch.Tensor], vid: torch.Tensor, real_s: torch.Tensor,
                  S: int, sample_rate: int, seq: Optional[slice] = None
                  ) -> Dict[str, torch.Tensor]:
    """The sweep's observed windows (``Predictor._forward_batch``'s host
    padding, on the card): ``vid`` and ``real_s`` are [B] video indices and
    valid strided-row counts; returns features, mask (True = pad) and depth
    or query, [B, S, ...] (the frames ``seq`` of them, where given). Filler
    rows (``real_s == 0``) keep frame 0 unmasked, as the host path does."""
    frames = _frames(S, seq, vid.device)
    in_view = frames[None, :] < real_s[:, None]
    mask = ~in_view
    if seq is None or seq.start == 0:
        mask[:, 0] = False
    out = {"features": _gather_window(data["features"], vid, in_view, frames, sample_rate, 0),
           "mask": mask}
    if "depth" in data:
        out["depth"] = _gather_window(data["depth"], vid, in_view, frames, sample_rate, 0)
    if "query" in data:   # the host sweep zero-fills query padding
        out["query"] = _gather_window(data["query"], vid, in_view, frames, sample_rate, 0)
    return out


def epoch_plan(cache: DeviceCache, batch_size: int, seed: int, epoch: int,
               shuffle: bool = True, drop_remainder: bool = True
               ) -> List[Tuple[int, np.ndarray]]:
    """The host loader's epoch (``BucketedLoader._order`` without length
    grouping, then consecutive batches): views shuffled by
    ``RandomState(seed + epoch)``, each batch at the smallest bucket that
    holds its longest view. Returns [(S, view ids [B] int64), ...]."""
    order = np.arange(cache.n_views)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    plan = []
    for i in range(0, len(order), batch_size):
        chunk = order[i: i + batch_size]
        if drop_remainder and len(chunk) < batch_size:
            continue
        plan.append((bucket_length(int(cache.nrows_host[chunk].max()), cache.buckets),
                     chunk.astype(np.int64)))
    return plan


@dataclasses.dataclass
class HybridCache:
    """A partial cache for datasets over the budget: the units that fit
    live in a ``DeviceCache``, the rest stream through the host collate.
    Batches keep the host loader's exact shuffle (``hybrid_epoch_plan``):
    each batch's cached rows are gathered on the card and its host rows ship
    as a compact [Bh, ...] batch that lands in their batch positions, so
    ``fit_hybrid == fit``."""

    cache: DeviceCache
    n_views: int                     # every (unit, ratio) view
    view_cached_id: np.ndarray       # [N] id in the cache's views, or -1 for a host view
    host_example: Callable[[int], Example]   # global view id -> Example (host views)
    n_obs: int
    with_depth: bool
    with_query: bool = False

    @property
    def host_frac(self) -> float:
        return float(np.mean(self.view_cached_id < 0))


def _unit_probe(source, cfg):
    """Each unit's feature, depth and label rows from npy headers and gt
    line counts, loading no data. Returns (units, feature rows, feature row
    bytes, depth rows, depth row bytes, label rows)."""
    itemsize = 2 if cfg.feature_dtype == "bfloat16" else 4
    units = list(source.units())
    feat_rows, depth_rows, label_rows = [], [], []
    feat_rb = depth_rb = 0
    for vid, seq in units:
        vid_file = vid.split("/")[-1]
        f = np.load(source._feature_file(vid_file, seq), mmap_mode="r")
        feat_rows.append(int(f.shape[-1] if cfg.features_transposed else f.shape[0]))
        feat_rb = (f.shape[0] if cfg.features_transposed
                   else int(np.prod(f.shape[1:]))) * itemsize
        with open(source._gt_file(vid_file, seq), "rb") as fh:
            label_rows.append(sum(1 for _ in fh))   # >= the valid label rows
        if source.depth_path is not None:
            d = np.load(source._depth_file(vid_file, seq), mmap_mode="r")
            depth_rows.append(int(d.shape[0]))
            depth_rb = int(np.prod(d.shape[1:])) * itemsize
    return (units, np.array(feat_rows), feat_rb, np.array(depth_rows), depth_rb,
            np.array(label_rows))


def hybrid_cache_from_source(source, cfg, n_query: int, max_bytes: int = MAX_BYTES,
                             policy: str = "longest", device: Device = "cuda") -> HybridCache:
    """Cache units greedily by ``policy`` until the padded estimate reaches
    ``max_bytes``: 'longest' first (the host rows left are short and ship at
    their own small bucket; the JAX package's measured default) or
    'ascending' (shortest first: the most resident views). Raises
    ``MemoryError`` when no unit fits, which for 'longest' means the longest
    one does not."""
    if policy not in ("ascending", "longest"):
        raise ValueError(f"unknown hybrid cache policy {policy!r} "
                         "(supported: 'ascending', 'longest')")
    _refuse_gaze(cfg)
    if cfg.raw_frames or cfg.multi_sequence:
        # multi-sequence units slice a whole-video depth stack at load: the
        # header probe cannot see their windows
        raise ValueError("hybrid cache supports the flat on-disk layout")
    units, frows, frb, drows, drb, lrows = _unit_probe(source, cfg)
    order = np.argsort(frows, kind="stable")
    if policy == "longest":
        order = order[::-1]
    cached_pos: List[int] = []
    fmax = dmax = lmax = 0
    for j in order:
        fmax_j = max(fmax, int(frows[j]))
        dmax_j = max(dmax, int(drows[j])) if len(drows) else 0
        lmax_j = max(lmax, int(lrows[j]))
        if (len(cached_pos) + 1) * (fmax_j * frb + dmax_j * drb + lmax_j * 4) > max_bytes:
            break
        cached_pos.append(int(j))
        fmax, dmax, lmax = fmax_j, dmax_j, lmax_j
    if not cached_pos:
        raise MemoryError("hybrid cache: not even the smallest unit fits the budget")
    cached_pos = sorted(cached_pos)   # source.units() order
    videos = videos_from_source(source, cfg, [units[u] for u in cached_pos])
    cache = build_cache(videos, **_cache_kwargs(source, cfg, n_query, max_bytes, device))
    n_obs = len(cfg.train_obs_percs)
    view_cached_id = np.full(len(units) * n_obs, -1, np.int32)
    for j, u in enumerate(cached_pos):
        view_cached_id[u * n_obs: (u + 1) * n_obs] = np.arange(j * n_obs, (j + 1) * n_obs)
    obs_percs = tuple(cfg.train_obs_percs)

    def host_example(g: int) -> Example:
        vid, seq = units[g // n_obs]
        return source.make_example(vid, obs_percs[g % n_obs], cfg.sample_rate, n_query,
                                   seq=seq)

    return HybridCache(cache=cache, n_views=len(units) * n_obs, view_cached_id=view_cached_id,
                       host_example=host_example, n_obs=n_obs,
                       with_depth=source.depth_path is not None,
                       with_query=source.query_dict is not None)


def hybrid_epoch_plan(h: HybridCache, batch_size: int, seed: int, epoch: int
                      ) -> List[np.ndarray]:
    """The host loader's epoch order (shuffle by ``RandomState(seed +
    epoch)``, no length grouping) in consecutive ``batch_size`` chunks of
    global view ids: the batches of ``fit``."""
    order = np.arange(h.n_views)
    np.random.RandomState(seed + epoch).shuffle(order)
    return [order[i: i + batch_size].astype(np.int64) for i in range(0, len(order), batch_size)]
