"""On-disk dataset source.

Counterpart of ``r3d_tpu/data/datasets.py``: one loader class for the
reference's dataset files, its fork points ``DataConfig`` fields:

- ``gt_format``: 'plain' = one label per line; 'csv' = ``img,L2[,L3]`` rows,
  keeping rows of exactly 3 fields;
- ``features_transposed``: features stored [C, S] on disk;
- ``train_obs_percs``: the observation ratios a train or val table repeats
  each video at;
- ``depth_features_dir``: an optional second stream (raw depth frames),
  ``multi_sequence`` with its ``depth_dir_rewrite`` and ``normalize_depth``;
- ``query_mapping_file``: an integer query stream (the query models' ids),
  with ``l1_relabel`` (50salads: L1 targets from the L2 gt, the L2 labels
  the queries) or ``label_from_filename`` (Breakfast: the activity in the
  file name the target, the gt's fine labels the queries);
- ``gaze_dir``: a float query stream, each video's gaze CSV
  (``preprocess/tools.gaze_csv_to_query``, [N, 2]); a video without one is
  left out, and an example's window is ``[:int(obs_perc * N)]`` of the raw
  gaze, not strided by ``sample_rate`` (basedataset_darai_gaze.py:152-188).

- ``raw_frames``: jpg frames resized to ``raw_frame_wh`` and scaled to
  [0, 1], depth from one Kinect XML a frame (basedataset_utkinects_raw.py).

Videos parse their labels once into int arrays. Feature arrays stay cached
in host memory (``cache='ram'``), or each example streams its observed
window from disk through the native C++ loader (``cache='native'``,
``data/native.py``), for datasets larger than host memory. The native path
serves whole flat videos (no ``seq``, not ``multi_sequence``, not
``raw_frames``); every other example, and one whose feature file the loader
cannot read, takes the NumPy path, as JAX's does
(``r3d_tpu/data/datasets.py:314-364``). ``native.STATS`` counts both.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from r3d_tpu_torch.config import DataConfig
from r3d_tpu_torch.data import native
from r3d_tpu_torch.data.mapping import read_mapping_dict
from r3d_tpu_torch.data.pipeline import BucketedLoader
from r3d_tpu_torch.data.preprocess.tools import gaze_csv_to_query
from r3d_tpu_torch.data.protocol import Example, make_example_from_indices
from r3d_tpu_torch.data.salads50 import relabel_sequence


def _dataset_dir(cfg: DataConfig) -> str:
    # main_utkinects.py:77-84: the 'utkinects' config lives in datasets/utkinect
    name = {"utkinects": "utkinect"}.get(cfg.dataset, cfg.dataset)
    return os.path.join(cfg.data_root, name)


def read_split(cfg: DataConfig, split_name: str) -> List[str]:
    path = os.path.join(_dataset_dir(cfg), cfg.splits_dir, split_name)
    with open(path) as f:
        return [l for l in f.read().split("\n") if l.strip()]


def read_gt_file(path: str, gt_format: str
                 ) -> Tuple[List[str], Optional[List[str]], Optional[List[str]]]:
    """Returns (frame_labels, image_paths, l3_labels)."""
    with open(path) as f:
        lines = f.readlines()
    if gt_format == "csv":
        valid = [l.strip() for l in lines if len(l.strip().split(",")) == 3]
        images = [l.split(",")[0] for l in valid]
        labels = [l.split(",")[1] for l in valid]
        l3 = [l.split(",")[2] for l in valid]
        return labels, images, l3
    labels = [l for l in "".join(lines).split("\n")][:-1]
    return labels, None, None


class VideoSource:
    """Lazy per-video loader and the train table over observation ratios.

    Labels parse once per video into int arrays; feature arrays stay cached
    in host memory (``cache='ram'``) or stream per example through the
    native loader (``cache='native'``, which builds it here and raises
    ``native.NativeBuildError`` where it cannot be built)."""

    def __init__(self, cfg: DataConfig, vid_list: List[str], actions_dict: Dict[str, int],
                 n_class: int, pad_idx: int, query_dict: Optional[Dict[str, int]] = None,
                 cache: str = "ram"):
        if cache == "native":
            native.get_lib()
        self.cfg = cfg
        self.vid_list = vid_list
        self.actions_dict = actions_dict
        self.n_class = n_class
        self.pad_idx = pad_idx
        self.query_dict = query_dict
        self.cache = cache
        root = _dataset_dir(cfg)
        self.features_path = os.path.join(root, cfg.features_dir)
        self.gt_path = os.path.join(root, cfg.gt_dir)
        self.depth_path = (os.path.join(root, cfg.depth_features_dir)
                           if cfg.depth_features_dir else None)
        self._cache: Dict[str, Dict] = {}
        self._meta: Dict[str, Dict] = {}

    @staticmethod
    def _base(vid_file: str) -> str:
        return os.path.splitext(vid_file)[0]

    def _gt_file(self, vid_file: str, seq: Optional[int] = None) -> str:
        if seq is None:
            return os.path.join(self.gt_path, vid_file)
        return os.path.join(self.gt_path, f"{self._base(vid_file)}_{seq}.txt")

    def _feature_file(self, vid_file: str, seq: Optional[int] = None) -> str:
        base = vid_file.split(".")[0] if seq is None else f"{self._base(vid_file)}_{seq}"
        return os.path.join(self.features_path, base + ".npy")

    def _gaze_file(self, vid_file: str) -> str:
        # one gaze CSV per video: the reference resolves it from each gt
        # row's image path, which encodes only (activity, video id), so its
        # per-row existence check is per video (basedataset_darai_gaze.py:97-109)
        return os.path.join(_dataset_dir(self.cfg), self.cfg.gaze_dir,
                            vid_file.split(".")[0] + ".csv")

    def _depth_file(self, vid_file: str, seq: Optional[int] = None) -> str:
        if seq is None and not self.cfg.multi_sequence:
            return os.path.join(self.depth_path, vid_file.split(".")[0] + ".npy")
        # multi-sequence: the depth stream is always the seq-1 file with the
        # camera->depth directory rewrite (basedataset_darai_depth.py:46-50)
        path = os.path.join(self.depth_path, f"{self._base(vid_file)}_1.npy")
        for old, new in self.cfg.depth_dir_rewrite:
            if old in path:
                path = path.replace(old, new)
                break
        return path

    def units(self) -> List[Tuple[str, Optional[int]]]:
        """The (vid, seq) pairs this source serves.

        Flat layouts: one unit per split entry. Multi-sequence layouts
        (basedataset_darai_depth.py:44-82): walk {base}_{seq}.txt/.npy from
        seq=1 until a file is missing or the gt has <= sample_rate lines; a
        video with no (rewritten) depth file contributes nothing when a
        depth stream is configured, and none without its gaze CSV when a
        gaze stream is (the reference's rows of such a video all fail its
        existence check, basedataset_darai_gaze.py:152-158)."""
        def gaze_ok(vid_file: str) -> bool:
            return self.cfg.gaze_dir is None or os.path.exists(self._gaze_file(vid_file))

        if not self.cfg.multi_sequence:
            return [(v, None) for v in self.vid_list if gaze_ok(v.split("/")[-1])]
        out: List[Tuple[str, Optional[int]]] = []
        for vid in self.vid_list:
            vid_file = vid.split("/")[-1]
            if not gaze_ok(vid_file) or (self.depth_path is not None and not os.path.exists(
                    self._depth_file(vid_file, seq=1))):
                continue
            seq = 1
            while True:
                gt = self._gt_file(vid_file, seq)
                if not (os.path.exists(gt) and os.path.exists(self._feature_file(vid_file, seq))):
                    break
                with open(gt) as f:
                    n_lines = len(f.readlines())
                if n_lines <= self.cfg.sample_rate:
                    break
                out.append((vid, seq))
                seq += 1
        return out

    @staticmethod
    def _meta_key(vid_file: str, seq: Optional[int]) -> str:
        return vid_file if seq is None else f"{vid_file}::{seq}"

    def load_meta(self, vid: str, seq: Optional[int] = None) -> Dict:
        """Parsed labels (int arrays) and paths; small, always cached."""
        vid_file = vid.split("/")[-1]
        key = self._meta_key(vid_file, seq)
        if key in self._meta:
            return self._meta[key]
        labels, images, l3 = read_gt_file(self._gt_file(vid_file, seq), self.cfg.gt_format)
        if self.cfg.label_from_filename:
            # proposed-breakfast: the gt's fine labels are the queries, the
            # activity in the file name every frame's target
            # (basedataset_proposed_breakfast.py:60-66)
            l3 = labels
            labels = [self._base(vid_file).split("_")[-1]] * len(l3)
        elif self.cfg.l1_relabel:
            # proposed-50salads: L1 targets from the L2 gt, the L2 labels
            # the queries
            l3 = labels
            labels = relabel_sequence(labels)
        label_idx = np.array([self.actions_dict[l.replace(" ", "")] for l in labels], np.int64)
        query_idx = None
        if self.query_dict is not None and l3 is not None:
            query_idx = np.array([self.query_dict[q.replace(" ", "")] for q in l3], np.int64)
        if self.cfg.gaze_dir is not None:
            # the video's whole gaze stream, [N, 2] float (its N is not the
            # frame count; basedataset_darai_gaze.py:169-188)
            query_idx = gaze_csv_to_query(self._gaze_file(vid_file))
        meta = {"labels": labels, "label_idx": label_idx, "images": images, "l3": l3,
                "query_idx": query_idx}
        self._meta[key] = meta
        return meta

    def _load_raw_video(self, vid_file: str, meta: Dict) -> Dict:
        """The raw-frame ablation (basedataset_utkinects_raw.py:80-104): the
        video's jpgs sorted by the number in their name, resized to
        ``raw_frame_wh`` and scaled by 1/255; depth from one Kinect XML a
        frame."""
        import cv2

        from r3d_tpu_torch.data.preprocess.depth import kinect_xml_to_depth

        def num(name):
            return int(re.search(r"\d+", name).group())

        base = self._base(vid_file)
        img_folder = os.path.join(self.features_path, base)
        frames = []
        for f in sorted((f for f in os.listdir(img_folder) if f.endswith(".jpg")), key=num):
            img = cv2.imread(os.path.join(img_folder, f), cv2.IMREAD_COLOR)
            frames.append(cv2.resize(img, tuple(self.cfg.raw_frame_wh)) / 255.0)
        video = dict(meta, features=np.array(frames, np.float32))
        if self.depth_path is not None:
            depth_folder = os.path.join(self.depth_path, base)

            def load_depth(f):
                d = kinect_xml_to_depth(os.path.join(depth_folder, f))
                h, w = d.shape
                # the reference passes (h/2, w/2) as cv2's (width, height)
                # dsize, an axis swap it ships with, reproduced exactly
                # (basedataset_utkinects_raw.py:66-70, COMPAT.md)
                d = cv2.resize(d, (int(h / 2), int(w / 2)))
                return np.uint8(cv2.normalize(d, None, 0, 255, cv2.NORM_MINMAX))

            video["depth"] = np.array(
                [load_depth(f) for f in sorted(
                    (f for f in os.listdir(depth_folder) if f.endswith(".xml")), key=num)],
                np.float32)
        return video

    def load_video(self, vid: str, seq: Optional[int] = None) -> Dict:
        vid_file = vid.split("/")[-1]
        key = self._meta_key(vid_file, seq)
        if key in self._cache:
            return self._cache[key]
        meta = self.load_meta(vid, seq)
        if self.cfg.raw_frames:
            video = self._load_raw_video(vid_file, meta)
        else:
            feats = np.load(self._feature_file(vid_file, seq))
            if self.cfg.features_transposed:
                feats = feats.T
            video = dict(meta, features=feats)
            if self.depth_path is not None:
                depth = np.load(self._depth_file(vid_file, seq))
                if self.cfg.multi_sequence and meta["images"]:
                    # align the whole-video depth stack to this sequence's
                    # frame window by the gt's image indices
                    # (basedataset_darai_depth.py:105-113)
                    idxs = [int(os.path.basename(p).split("_")[-1].split(".")[0])
                            for p in meta["images"]]
                    depth = depth[idxs[0]: idxs[-1] + 1]
                if self.cfg.normalize_depth:
                    # NTU: whole-stack min-max -> [0, 255] uint8
                    # (basedataset_nturgbd.py:42-52)
                    lo, hi = depth.min(), depth.max()
                    if hi > lo:
                        depth = (depth - lo) / (hi - lo) * 255
                    depth = depth.astype(np.uint8)
                video["depth"] = depth
        if self.cache == "ram":
            self._cache[key] = video
        return video

    def _gaze_window(self, ex: Example, gaze: np.ndarray, obs_perc: float) -> Example:
        """The observation window over the raw gaze stream, not strided
        (basedataset_darai_gaze.py:186-188)."""
        ex.query_label = gaze[:int(obs_perc * len(gaze))]
        return ex

    def _native_example(self, vid: str, obs_perc: float, sample_rate: int,
                        n_query: int) -> Optional[Example]:
        """A whole flat video's example from the native loader: the observed
        window's ``ceil(observed / sample_rate)`` rows of the features (and
        of the depth stack, through its own probe; None where the loader
        cannot read it, as in JAX), or None where the feature file cannot be
        read natively."""
        vid_file = vid.split("/")[-1]
        meta = self.load_meta(vid)
        idx = meta["label_idx"]
        observed = int(obs_perc * len(idx))
        n_rows = -(-observed // sample_rate) if observed else 0
        path = self._feature_file(vid_file)
        shape = native.probe(path)
        if shape is None or n_rows == 0:
            return None
        dims = shape[0]
        transposed = self.cfg.features_transposed
        row_elems = dims[0] if transposed else int(np.prod(dims[1:]))
        res = native.load_sliced(path, observed, sample_rate, n_rows, row_elems,
                                 transpose=transposed)
        if res is None:
            return None
        feats, n = res
        depth = None
        if self.depth_path is not None:
            dpath = self._depth_file(vid_file)
            dshape = native.probe(dpath)
            dres = (None if dshape is None else native.load_sliced(
                dpath, observed, sample_rate, n_rows, int(np.prod(dshape[0][1:]))))
            if dres is None:
                native.STATS.count("depth_misses")
            else:
                depth = dres[0].reshape((n_rows,) + tuple(dshape[0][1:]))[:n]
        gaze = self.cfg.gaze_dir is not None
        ex = make_example_from_indices(
            feats[:n], idx, obs_perc, sample_rate, n_query, self.pad_idx, self.n_class,
            depth_features=depth, query_idx=None if gaze else meta["query_idx"],
            vid_name=vid, features_presliced=True, future_frames=self.cfg.future_frames)
        return self._gaze_window(ex, meta["query_idx"], obs_perc) if gaze else ex

    def make_example(self, vid: str, obs_perc: float, sample_rate: int, n_query: int,
                     seq: Optional[int] = None) -> Example:
        if self.cache == "native":
            ex = None
            if seq is None and not self.cfg.multi_sequence and not self.cfg.raw_frames:
                ex = self._native_example(vid, obs_perc, sample_rate, n_query)
            if ex is not None:
                native.STATS.count("loads")
                return ex
            native.STATS.count("fallbacks")
        v = self.load_video(vid, seq)
        gaze = self.cfg.gaze_dir is not None
        ex = make_example_from_indices(
            v["features"], v["label_idx"], obs_perc, sample_rate, n_query,
            self.pad_idx, self.n_class, depth_features=v.get("depth"),
            query_idx=None if gaze else v["query_idx"],
            vid_name=vid if seq is None else f"{vid}::{seq}",
            future_frames=self.cfg.future_frames)
        return self._gaze_window(ex, v["query_idx"], obs_perc) if gaze else ex


def build_source(cfg: DataConfig, split_name: str,
                 query_mapping: Optional[str] = None) -> VideoSource:
    root = _dataset_dir(cfg)
    actions_dict = read_mapping_dict(os.path.join(root, cfg.mapping_file))
    n_class = len(actions_dict) + 1      # + NONE (main_utkinects.py:108)
    pad_idx = n_class + 1                # main_utkinects.py:109
    query_mapping = query_mapping or cfg.query_mapping_file
    query_dict = read_mapping_dict(os.path.join(root, query_mapping)) if query_mapping else None
    return VideoSource(cfg, read_split(cfg, split_name), actions_dict, n_class, pad_idx,
                       query_dict)


def build_loader(source: VideoSource, cfg: DataConfig, batch_size: int, n_query: int,
                 mode: str = "train", obs_perc: float = 0.2, shuffle: bool = True,
                 seed: int = 0, pin_memory: bool = False) -> BucketedLoader:
    """The loader over every (unit, ratio): the config's train ratios for
    ``mode`` 'train' and 'val', else ``obs_perc`` alone; ``pin_memory`` for
    batches bound for the card. A source with a query vocabulary collates
    its query stream, padded with that vocabulary's pad id
    ``len(query_dict)`` (the coarse ``pad_idx`` is a valid fine id); a gaze
    source its gaze stream, zero-padded to ``gaze_pad_len`` rows (else the
    largest bucket) with each row's ``query_len``."""
    obs = cfg.train_obs_percs if mode in ("train", "val") else (obs_perc,)
    table = [(u, o) for u in source.units() for o in obs]

    def fn(i: int) -> Example:
        (vid, seq), o = table[i]
        return source.make_example(vid, o, cfg.sample_rate, n_query, seq=seq)

    return BucketedLoader(
        num_examples=len(table), make_example_fn=fn, batch_size=batch_size,
        pad_idx=source.pad_idx, buckets=cfg.seq_buckets, n_query=n_query,
        with_depth=source.depth_path is not None, shuffle=shuffle, seed=seed,
        feature_dtype=cfg.feature_dtype, pin_memory=pin_memory,
        with_query=source.query_dict is not None or cfg.gaze_dir is not None,
        query_pad_idx=len(source.query_dict) if source.query_dict is not None else None,
        query_pad_len=cfg.gaze_pad_len)
