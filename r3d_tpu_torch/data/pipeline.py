"""Host-side batching with bucketed static shapes.

Counterpart of ``r3d_tpu/data/pipeline.py``: a sequence pads up to the
smallest bucket that holds it, features with 0 and labels with ``pad_idx``
(the reference collate, basedataset.py:118-123), and a loader groups
shuffled examples by bucket and collates them on a background thread.
``pad_batch`` collates each example's rows straight into CPU tensors of
the storage dtype, pinned when the batch is bound for the card; a
``bfloat16`` feature stream is rounded to nearest even, as JAX's
``jnp.bfloat16`` cast rounds (the cast is elementwise and the pads are 0,
so a row cast alone equals the batch cast whole).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from r3d_tpu_torch.data.protocol import Example

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PREFETCH = 2   # collated batches the loader's thread keeps ready


def bucket_length(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (the last bucket truncates longer
    sequences)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def query_fill(pad_idx: int, query_pad_idx: Optional[int]) -> int:
    """The pad id of an integer query stream: the query vocabulary's
    ``query_pad_idx``, else ``pad_idx``."""
    return pad_idx if query_pad_idx is None else query_pad_idx


def pad_batch(examples: List[Example], pad_idx: int, buckets: Sequence[int], n_query: int,
              with_depth: bool = False, feature_dtype: str = "float32",
              pin_memory: bool = False, with_query: bool = False,
              query_pad_idx: Optional[int] = None, query_pad_len: Optional[int] = None
              ) -> Dict[str, torch.Tensor]:
    """Collate examples into fixed-shape CPU tensors: ``features`` [B, S, C]
    and ``depth_features`` [B, S, ...] in ``feature_dtype``, ``past_label``
    [B, S], ``trans_future_target`` [B, n_query] int32,
    ``trans_future_dur`` [B, n_query] fp32 and, ``with_query``,
    ``query_label`` [B, S] int32 padded with ``query_pad_idx`` (``pad_idx``
    when None). A float query stream (gaze, [N, 2]) pads with zeros to its
    own length, ``query_pad_len`` rows (else the largest bucket; longer
    streams are cut), in fp32, with ``query_len`` [B] int32 its true rows:
    its length is not the frame bucket's (basedataset_darai_gaze.py:186).
    ``pin_memory``: the float streams and the query stream in page-locked
    memory, for an asynchronous copy to the card."""
    S = bucket_length(max(e.features.shape[0] for e in examples), buckets)
    B = len(examples)
    dtype = _DTYPES[feature_dtype]
    features = torch.zeros((B, S, examples[0].features.shape[1]), dtype=dtype,
                           pin_memory=pin_memory)
    past_label = np.full((B, S), pad_idx, np.int32)
    target = np.full((B, n_query), pad_idx, np.int32)
    dur = np.full((B, n_query), float(pad_idx), np.float32)
    depth = None
    if with_depth:
        depth = torch.zeros((B, S) + examples[0].depth_features.shape[1:], dtype=dtype,
                            pin_memory=pin_memory)
    query = query_len = None
    query_float = False
    if with_query:
        q0 = np.asarray(examples[0].query_label)
        query_float = q0.ndim > 1 or not np.issubdtype(q0.dtype, np.integer)
        if query_float:
            Sq = int(query_pad_len) if query_pad_len else buckets[-1]
            query = torch.zeros((B, Sq) + q0.shape[1:], dtype=torch.float32,
                                pin_memory=pin_memory)
            query_len = np.zeros((B,), np.int32)
        else:
            query = torch.full((B, S), query_fill(pad_idx, query_pad_idx),
                               dtype=torch.int32, pin_memory=pin_memory)
    for i, e in enumerate(examples):
        s = min(e.features.shape[0], S)
        features[i, :s] = torch.from_numpy(e.features[:s])
        past_label[i, :s] = e.past_label[:s]
        q = min(len(e.trans_future_target), n_query)
        target[i, :q] = e.trans_future_target[:q]
        dur[i, :q] = e.trans_future_dur[:q]
        if with_depth:
            depth[i, :s] = torch.from_numpy(e.depth_features[:s])
        if query_float:
            sq = min(len(e.query_label), query.shape[1])
            query[i, :sq] = torch.from_numpy(np.asarray(e.query_label[:sq], np.float32))
            query_len[i] = sq
        elif with_query:
            query[i, :s] = torch.from_numpy(np.asarray(e.query_label[:s], np.int32))
    batch = {
        "features": features,
        "past_label": torch.from_numpy(past_label),
        "trans_future_target": torch.from_numpy(target),
        "trans_future_dur": torch.from_numpy(dur),
    }
    if with_depth:
        batch["depth_features"] = depth
    if with_query:
        batch["query_label"] = query
    if query_len is not None:
        batch["query_len"] = torch.from_numpy(query_len)
    return batch


class BucketedLoader:
    """Iterates (shuffled) examples grouped into same-bucket batches.

    ``make_example_fn(index) -> Example`` is called lazily; a background
    thread keeps ``PREFETCH`` collated batches ready. The order (shuffle by
    ``RandomState(seed + epoch)``, then a stable sort by bucket) is the JAX
    loader's, so both see the same batches. ``epoch`` counts the iterations
    begun so far. ``pin_memory``: collate into page-locked memory (set it
    when the batches go to the card).
    """

    def __init__(self, num_examples: int, make_example_fn: Callable[[int], Example],
                 batch_size: int, pad_idx: int, buckets: Sequence[int], n_query: int,
                 with_depth: bool = False, shuffle: bool = True, seed: int = 0,
                 example_lengths: Optional[Sequence[int]] = None,
                 feature_dtype: str = "float32", pin_memory: bool = False,
                 with_query: bool = False, query_pad_idx: Optional[int] = None,
                 query_pad_len: Optional[int] = None):
        self.num_examples = num_examples
        self.make_example_fn = make_example_fn
        self.batch_size = batch_size
        self.pad_idx = pad_idx
        self.buckets = tuple(buckets)
        self.n_query = n_query
        self.with_depth = with_depth
        self.feature_dtype = feature_dtype
        self.shuffle = shuffle
        self.seed = seed
        self.example_lengths = example_lengths
        self.pin_memory = pin_memory
        self.with_query = with_query
        self.query_pad_idx = query_pad_idx
        self.query_pad_len = query_pad_len
        self.epoch = 0

    def __len__(self) -> int:
        return -(-self.num_examples // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(self.num_examples)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.example_lengths is not None:
            lengths = np.asarray(self.example_lengths)
            keys = np.array([bucket_length(l, self.buckets) for l in lengths[idx]])
            idx = idx[np.argsort(keys, kind="stable")]
        return idx

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order = self._order()
        self.epoch += 1   # as JAX's loader: on starting an iteration
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = object()

        def worker():
            try:
                for b in batches:
                    q.put(pad_batch([self.make_example_fn(int(i)) for i in b], self.pad_idx,
                                    self.buckets, self.n_query, self.with_depth,
                                    self.feature_dtype, self.pin_memory, self.with_query,
                                    self.query_pad_idx, self.query_pad_len))
                q.put(stop)
            except BaseException as e:  # surfaced in the consumer: a swallowed
                q.put(e)                # error would silently cut the epoch short

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
