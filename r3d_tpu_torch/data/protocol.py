"""Dataset protocol core: windowing, transcripts, padding.

The port's own copy of ``r3d_tpu/data/protocol.py`` (NumPy only, so the
port needs nothing of the JAX package). Pure NumPy re-implementation of the observable semantics of the reference
``data/basedataset*.py`` ``_make_input`` (basedataset.py:47-105,
basedataset_utkinects.py:85-157):

  1. slice the observed prefix ``obs_perc * vid_len`` and the future window
     ``0.5 * vid_len`` of the per-frame label sequence;
  2. subsample both by ``sample_rate`` (``[::r]``);
  3. convert the future window to a transcript (unique action runs) with
     per-run durations normalized by the window length;
  4. append the NONE class (``n_class - 1``) and pad/truncate the transcript
     to ``n_query`` with ``pad_idx`` (durations get one extra pad slot when
     the transcript fits exactly or is short).

These functions are the correctness anchors for the whole framework: the
models, losses and MoC protocol are all expressed against their outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Example:
    """One training/eval example (a video at one observation ratio)."""

    features: np.ndarray            # [S, C] observed RGB features
    past_label: np.ndarray          # [S] int labels of observed frames
    trans_future_target: np.ndarray  # [n_query] transcript action ids (+NONE, padded)
    trans_future_dur: np.ndarray    # [n_query] normalized durations (padded)
    depth_features: Optional[np.ndarray] = None  # [S, ...] observed depth stream
    query_label: Optional[np.ndarray] = None     # [S] L3 labels (darai/proposed)
    vid_name: str = ""
    obs_perc: float = 0.0


def labels_to_indices(seq: Sequence[str], actions_dict: Dict[str, int]) -> np.ndarray:
    """Per-frame label strings -> int indices (basedataset.py:133-137).

    Spaces inside names are stripped, matching basedataset_utkinects.py:190.
    """
    return np.array([actions_dict[s.replace(" ", "")] for s in seq], dtype=np.int64)


def labels_to_transcript(
    seq: Sequence[str], actions_dict: Dict[str, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Future label window -> (transcript actions, normalized durations).

    Mirrors basedataset.py:139-154 exactly: a run's duration is
    ``(run_start_next - run_start) / len(seq)`` and the final run extends to
    the end of the window.  Requires ``len(seq) >= 1``.
    """
    names = [s.replace(" ", "") for s in seq]
    actions: List[int] = [actions_dict[names[0]]]
    durs: List[float] = []
    current = names[0]
    last_i = 0
    for i, name in enumerate(names):
        if name != current:
            current = name
            actions.append(actions_dict[name])
            durs.append((i - last_i) / len(names))
            last_i = i
    durs.append((len(names) - last_i) / len(names))
    return np.array(actions, dtype=np.int64), np.array(durs, dtype=np.float64)


def indices_to_transcript(idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized labels_to_transcript on an int index array (run-length
    encode): same output as the string version, no Python loop."""
    idx = np.asarray(idx)
    n = len(idx)
    starts = np.flatnonzero(np.concatenate([[True], idx[1:] != idx[:-1]]))
    actions = idx[starts].astype(np.int64)
    bounds = np.concatenate([starts, [n]])
    durs = (bounds[1:] - bounds[:-1]) / n
    return actions, durs.astype(np.float64)


def pad_transcript(
    trans_future: np.ndarray,
    trans_future_dur: np.ndarray,
    n_query: int,
    pad_idx: int,
    none_idx: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Append NONE, then pad/truncate to n_query (basedataset.py:79-96).

    Notes on the reference's exact (slightly asymmetric) behavior, preserved:
    - actions get NONE appended first; durations do not get a NONE slot.
    - If the padded action transcript is SHORT by ``diff``, durations receive
      ``diff + 1`` pads (they start one element shorter than actions).
    - If it fits exactly (diff == 0), durations receive exactly 1 pad.
    - If it is LONG, both are truncated to ``n_query``.
    """
    target = np.append(trans_future, none_idx).astype(np.float64)
    dur = np.asarray(trans_future_dur, dtype=np.float64)
    diff = n_query - len(target)
    if diff > 0:
        target = np.concatenate([target, np.full(diff, pad_idx, dtype=np.float64)])
        dur = np.concatenate([dur, np.full(diff + 1, pad_idx, dtype=np.float64)])
    elif diff < 0:
        target = target[:n_query]
        dur = dur[:n_query]
    else:
        dur = np.concatenate([dur, np.full(1, pad_idx, dtype=np.float64)])
    return target, dur


def make_example_from_indices(
    features: np.ndarray,
    label_idx: np.ndarray,
    obs_perc: float,
    sample_rate: int,
    n_query: int,
    pad_idx: int,
    n_class: int,
    depth_features: Optional[np.ndarray] = None,
    query_idx: Optional[np.ndarray] = None,
    pred_perc: float = 0.5,
    vid_name: str = "",
    features_presliced: bool = False,
    future_frames: Optional[int] = None,
) -> Example:
    """make_example on pre-parsed int label arrays — the hot loader path
    (labels parse once per video, transcripts are vectorized).

    ``features_presliced=True`` means features/depth already carry the
    observed+strided window (the native loader emits them that way)."""
    none_idx = n_class - 1
    vid_len = len(label_idx)
    observed_len = int(obs_perc * vid_len)
    # darai_llm bounds the future window to future_frames*sample_rate gt
    # frames (basedataset_darai_llm.py:428) instead of pred_perc*vid_len
    pred_len = (
        future_frames * sample_rate
        if future_frames is not None
        else int(pred_perc * vid_len)
    )

    past_label = label_idx[:observed_len][::sample_rate]
    feats = features if features_presliced else features[:observed_len][::sample_rate]
    if feats.shape[0] != len(past_label):
        feats = feats[: len(past_label)]
    depth = None
    if depth_features is not None:
        depth = (
            depth_features
            if features_presliced
            else depth_features[:observed_len][::sample_rate]
        )
        if depth.shape[0] != len(past_label):
            depth = depth[: len(past_label)]

    future = label_idx[observed_len : observed_len + pred_len][::sample_rate]
    trans_future, trans_future_dur = indices_to_transcript(future)
    target, dur = pad_transcript(trans_future, trans_future_dur, n_query, pad_idx, none_idx)

    query = None
    if query_idx is not None:
        query = query_idx[:observed_len][::sample_rate]

    return Example(
        features=np.ascontiguousarray(feats, dtype=np.float32),
        past_label=past_label.astype(np.int64),
        trans_future_target=target.astype(np.int64),
        trans_future_dur=dur.astype(np.float32),
        depth_features=None if depth is None else np.ascontiguousarray(depth, np.float32),
        query_label=query,
        vid_name=vid_name,
        obs_perc=obs_perc,
    )


def make_example(
    features: np.ndarray,
    frame_labels: Sequence[str],
    actions_dict: Dict[str, int],
    obs_perc: float,
    sample_rate: int,
    n_query: int,
    pad_idx: int,
    n_class: int,
    depth_features: Optional[np.ndarray] = None,
    query_labels: Optional[Sequence[str]] = None,
    query_dict: Optional[Dict[str, int]] = None,
    pred_perc: float = 0.5,
    vid_name: str = "",
    future_frames: Optional[int] = None,
) -> Example:
    """Build one example from per-frame features + labels.

    ``features`` is [S_total, C] (already frame-major; the reference stores
    features transposed on disk and flips them at load — see loader).
    """
    none_idx = n_class - 1
    vid_len = len(frame_labels)
    observed_len = int(obs_perc * vid_len)
    pred_len = (
        future_frames * sample_rate
        if future_frames is not None
        else int(pred_perc * vid_len)
    )

    feats = features[:observed_len][::sample_rate]
    past_content = list(frame_labels[:observed_len])[::sample_rate]
    past_label = labels_to_indices(past_content, actions_dict)
    # basedataset.py:72-73: clamp features to the label count when they differ
    if feats.shape[0] != len(past_content):
        feats = feats[: len(past_content)]

    depth = None
    if depth_features is not None:
        depth = depth_features[:observed_len][::sample_rate]
        if depth.shape[0] != len(past_content):
            depth = depth[: len(past_content)]

    future_content = list(frame_labels[observed_len : observed_len + pred_len])[::sample_rate]
    trans_future, trans_future_dur = labels_to_transcript(future_content, actions_dict)
    target, dur = pad_transcript(trans_future, trans_future_dur, n_query, pad_idx, none_idx)

    query = None
    if query_labels is not None and query_dict is not None:
        qc = list(query_labels[:observed_len])[::sample_rate]
        query = labels_to_indices(qc, query_dict)

    return Example(
        features=np.asarray(feats, dtype=np.float32),
        past_label=past_label,
        trans_future_target=target.astype(np.int64),
        trans_future_dur=dur.astype(np.float32),
        depth_features=None if depth is None else np.asarray(depth, dtype=np.float32),
        query_label=query,
        vid_name=vid_name,
        obs_perc=obs_perc,
    )
