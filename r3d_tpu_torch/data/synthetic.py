"""Synthetic video source for tests and benchmarks.

The port's own copy of ``r3d_tpu/data/synthetic.py``: the same seed gives
the same videos.

Generates run-structured per-frame labels with class-informative features so
a model can actually learn the anticipation task (smoke-convergence tests,
SURVEY.md §4) without any dataset on disk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from r3d_tpu_torch.data.protocol import Example, make_example


class SyntheticSource:
    """In-memory videos: Markov-ish label runs + features = class embedding
    + noise; optional depth stream carrying the same signal."""

    def __init__(
        self,
        n_videos: int = 12,
        n_actions: int = 6,
        vid_len_range: Tuple[int, int] = (80, 160),
        input_dim: int = 64,
        depth_shape: Optional[Tuple[int, int]] = None,
        n_query_classes: int = 0,   # >0: emit a per-frame L3 query stream
        seed: int = 0,
    ):
        rng = np.random.RandomState(seed)
        self.n_actions = n_actions
        self.actions_dict = {f"act{i}": i for i in range(n_actions)}
        self.n_class = n_actions + 1  # + NONE
        self.pad_idx = self.n_class + 1
        self.input_dim = input_dim
        self.depth_shape = depth_shape
        self.n_query_classes = n_query_classes
        self.query_dict = (
            {f"q{i}": i for i in range(n_query_classes)} if n_query_classes else None
        )

        class_emb = rng.randn(n_actions, input_dim) * 2.0
        depth_emb = None
        if depth_shape is not None:
            depth_emb = rng.randn(n_actions, *depth_shape) * 2.0

        self.videos: List[Dict] = []
        for _ in range(n_videos):
            vid_len = int(rng.randint(*vid_len_range))
            labels: List[str] = []
            current = int(rng.randint(n_actions))
            while len(labels) < vid_len:
                labels += [f"act{current}"] * int(rng.randint(8, 25))
                current = (current + 1 + int(rng.randint(n_actions - 1))) % n_actions
            labels = labels[:vid_len]
            idx = np.array([self.actions_dict[l] for l in labels])
            feats = class_emb[idx] + rng.randn(vid_len, input_dim) * 0.5
            video = {"labels": labels, "features": feats.astype(np.float32)}
            if depth_shape is not None:
                video["depth"] = (
                    depth_emb[idx] + rng.randn(vid_len, *depth_shape) * 0.5
                ).astype(np.float32)
            if n_query_classes:
                # fine-grained stream: a sub-division of the coarse runs
                fine = (idx * 2 + (np.arange(vid_len) // 7)) % n_query_classes
                video["query"] = [f"q{int(i)}" for i in fine]
            self.videos.append(video)

    def example_table(self, obs_percs) -> List[Tuple[int, float]]:
        return [(v, o) for v in range(len(self.videos)) for o in obs_percs]

    def make_example_fn(self, obs_percs, sample_rate, n_query):
        table = self.example_table(obs_percs)

        def fn(i: int) -> Example:
            vid_i, obs = table[i]
            v = self.videos[vid_i]
            return make_example(
                v["features"], v["labels"], self.actions_dict, obs, sample_rate,
                n_query, self.pad_idx, self.n_class,
                depth_features=v.get("depth"),
                query_labels=v.get("query"), query_dict=self.query_dict,
                vid_name=f"vid{vid_i}",
            )

        return fn, len(table)
