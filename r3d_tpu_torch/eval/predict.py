"""Prediction and MoC evaluation: the sweep over observation ratios.

Counterpart of ``r3d_tpu/eval/predict.py``, the protocol every reference
``evaluation/predict_*.py`` shares (predict_utkinects.py:215-392): per video,
slice the observed prefix, run the eval-mode forward, decode the anticipated
frames, and accumulate the MoC counters at the eval horizons, with the
anticipation and segmentation accuracies beside them.

    predictor = Predictor(config, model, n_class)          # CUDA by default
    results = predictor.predict_multi(state_dict, source, obs_list)

Observed windows pad to the config's buckets with an exact key mask, and
the windows of every ratio that fall in one bucket run together in chunks
of ``eval_batch`` rows (filler rows keep frame 0 unmasked; their outputs are
dropped), in the storage dtype of the config. ``variables`` is a
``state_dict``, a module, or a list of them: a list averages the output
heads of the seeds' models (the ensemble). The forward is ``model.eval()``
under ``torch.inference_mode()``, as the serving session runs it.

``cache_data`` (``data/device_cache.arrays_from_source``: the sweep's
videos on the card) gathers each chunk's windows there
(``device_cache.assemble_eval``) from two [B] vectors, the videos and their
valid rows, instead of collating and copying them: the same inputs, filler
rows included, so the same outputs.

A query model (``models.QUERY_MODELS``) gets each window's query ids,
sliced and strided as the features are, with ``query_mod2`` re-encoded as
segment parity (``alternating_query``; on the cached route on the card,
over the gathered rows, each whole row's on a cut sequence), and zeros past
a window's rows; its ``l3`` output
gives the L3 accuracy (``l3_acc``), as JAX's does; the depth source takes
the same ids, as JAX's sweep feeds them. A gaze stream
(``gaze_dir``) is windowed over its raw rows, ``[:int(obs_p * N)]``, and
zero-padded to ``gaze_pad_len`` rows (else the largest bucket) with each
row's ``query_len``.

The self-attention source attends across the batch (COMPAT #17): its
outputs depend on the chunk's other rows, filler rows included, so the
reference's per-video protocol needs ``eval_batch=1`` (``darai`` sets it);
any other batch size warns.

``mesh`` (``parallel.make_mesh``) splits the sweep over the dp group, as
``r3d_tpu/eval/predict.py:114-126`` shards it: ``eval_batch`` rounds up to
the dp extent, each rank runs its rows of every chunk (inside
``split_rows``, so a fuser that ranks channels by activation ranks them
over the whole chunk, and MoE routes over it) and every rank gathers the
chunk's outputs over dp; a model that attends across the batch runs every
chunk whole on every rank, at its own ``eval_batch``. Each module holds
its rank's tp and ep slices (``parallel.mesh.place_model``), so the ranks
of one dp coordinate compute its rows together. On an sp axis each chunk's
sequence is cut as training cuts it (the bucket's frames over sp where sp
divides it, the cached route gathering only the rank's frames; JAX's sweep
cuts over dp and lets its ring reshard, ``r3d_tpu/eval/predict.py:114-125``,
to the same numbers), and the per-frame outputs are gathered over sp
before dp. The filler rows stay masked and dropped, so the MoC tables are
the one-process sweep's. Every family runs so: the query ids and a gaze
stream as long as the bucket are cut with the features, and each model
gathers over sp what mixes frames (``models/futr_unsupervised.py``,
``models/baselines.py``). On a pp axis the pp ranks of a dp coordinate run
its rows, the decoder stack as the GPipe forward (``parallel/pipeline.py``,
JAX's sweep on its pp mesh, ``r3d_tpu/eval/predict.py:84-120``).

``gif_dir`` renders, for each video whose ground truth names its frames
(``images`` in its meta, the csv layouts), a gt-against-prediction GIF over
those frames under ``frames_root`` (``eval/visualize.py``), named
``<video>[_<seq>]_<ratio>.gif``, as ``r3d_tpu/eval/predict.py:346-366``
does; on a group only rank 0 writes them.
"""

from __future__ import annotations

import collections
import copy
import os
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from r3d_tpu_torch.config import Config
from r3d_tpu_torch.data.datasets import VideoSource
from r3d_tpu_torch.data.device_cache import assemble_eval
from r3d_tpu_torch.data.pipeline import bucket_length
from r3d_tpu_torch.eval.decode import decode_anticipation, decode_frames_from_slots
from r3d_tpu_torch.eval.moc import MoCAccumulator
from r3d_tpu_torch.models import is_fusion_model, model_needs_query
from r3d_tpu_torch.models.futr_unsupervised import check_gaze_cut
from r3d_tpu_torch.models.layers import DTYPES
from r3d_tpu_torch.parallel.mesh import (
    axis,
    batch_sharding,
    cut,
    dp_group,
    dp_size,
    is_writer,
    local_model_state,
    place_model,
    seq_sharding,
    split_mesh,
)
from r3d_tpu_torch.parallel.tensor import cut_seq, gather_seq
from r3d_tpu_torch.serving import resolve_device

OUTPUT_KEYS = ("action", "duration", "seg", "l3")   # what the sweep reads back
FRAME_KEYS = ("seg", "l3")   # the outputs with a frame axis: gathered over a cut sequence
Variables = Union[Mapping[str, torch.Tensor], nn.Module]


def alternating_query(q: np.ndarray) -> np.ndarray:
    """predict_breakfast.py:239-252: a query id sequence as segment parity
    0/1, 0 for the first run of equal ids and toggling at every change."""
    q = np.asarray(q)
    changes = np.concatenate([[0], (q[1:] != q[:-1]).astype(np.int64)])
    return (np.cumsum(changes) % 2).astype(q.dtype)


def alternating_query_rows(q: torch.Tensor) -> torch.Tensor:
    """``alternating_query`` of each row of [B, S] ids, on their device.
    Rows past a window's length are re-encoded too; the mask keeps them from
    every real output."""
    changes = torch.cat([torch.zeros_like(q[:, :1]), (q[:, 1:] != q[:, :-1]).to(q.dtype)], 1)
    return torch.cumsum(changes, 1) % 2


def weighted_anticipation_accuracy(pred_actions: np.ndarray, future_labels: np.ndarray,
                                   last_observed: int,
                                   exclude_class_idx: Optional[int] = None,
                                   weight_same: float = 1.0,
                                   weight_different: float = 10.0) -> float:
    """predict_utkinects.py:105-137: the first min(Q, T) anticipated
    transcript entries against the future gt frames, weighted 10x when the
    first future label differs from the last observed one."""
    weight = (weight_different
              if (len(future_labels) and future_labels[0] != last_observed) else weight_same)
    correct = total = 0.0
    for i in range(min(len(future_labels), len(pred_actions))):
        gt = future_labels[i]
        if exclude_class_idx is not None and gt == exclude_class_idx:
            continue
        if pred_actions[i] == gt:
            correct += weight
        total += weight
    return correct / total if total > 0 else 0.0


class Predictor:
    def __init__(self, config: Config, model: nn.Module, n_class: int, eval_batch: int = 8,
                 mesh=None, device: Union[str, torch.device] = "cuda"):
        """``model``: a module of ``config.model`` that ``state_dict``
        variables load into; ``mesh`` the mesh to split the sweep over."""
        check_gaze_cut(config, mesh)
        self.mesh = mesh
        self.group = dp_group(mesh)
        self.sp = axis(mesh, "sp")
        self.device = resolve_device(device)
        self.config = config
        self.model = model
        self.n_class = n_class
        self.eval_batch = eval_batch
        self.is_fusion = is_fusion_model(config.model.model)
        self.needs_query = model_needs_query(config.model.model)
        self.in_dtype = DTYPES[config.data.feature_dtype]
        batch_attending = getattr(model, "query_source", None) == "self_attention"
        if batch_attending and eval_batch != 1:
            warnings.warn(
                f"model {config.model.model!r} attends across the batch (COMPAT #17): "
                f"eval_batch={eval_batch} makes the sweep batch-composition-dependent; the "
                "reference protocol is per-video (eval_batch=1).")
        # split each chunk over dp, or (a model that attends across the
        # batch, unless its batch already divides) run it whole on each rank
        dp = dp_size(mesh)
        rounded = -(-eval_batch // dp) * dp
        self._replicate = batch_attending and rounded != eval_batch
        if not self._replicate:
            self.eval_batch = rounded

    def _modules(self, variables: Union[Variables, Sequence[Variables]]) -> List[nn.Module]:
        """The eval-mode modules on the device for ``variables`` (one, or a
        list for the ensemble)."""
        many = isinstance(variables, (list, tuple))
        modules = []
        for i, v in enumerate(variables if many else [variables]):
            if not isinstance(v, nn.Module):
                m = self.model if i == 0 else copy.deepcopy(self.model)
                m.load_state_dict(local_model_state(m, v))
                v = m
            modules.append(place_model(v.to(self.device), self.mesh).eval())
        return modules

    def _prepare(self, source: VideoSource, obs_p: float) -> Dict[int, List[Dict]]:
        """Slice every video's observed window; group them by bucket."""
        cfg = self.config
        sample_rate = cfg.data.sample_rate
        groups: Dict[int, List[Dict]] = collections.defaultdict(list)
        for ui, (vid, seq) in enumerate(source.units()):
            v = source.load_video(vid, seq)
            labels_idx = v["label_idx"]
            vid_len = len(labels_idx)
            past_len = int(obs_p * vid_len)
            if past_len < 1:
                continue
            feats = v["features"][:past_len][::sample_rate]
            real_s = feats.shape[0]
            if cfg.eval.max_eval_len and real_s > cfg.eval.max_eval_len:
                # the reference skips on the observed strided row count
                # (predict_breakfast.py:216)
                continue
            item = {"vid": vid, "seq": seq, "ui": ui, "labels_idx": labels_idx,
                    "past_len": past_len, "future_len": int(cfg.eval.pred_p * vid_len),
                    "real_s": real_s, "feats": feats}
            if "depth" in v:
                item["depth"] = v["depth"][:past_len][::sample_rate]
            if self.needs_query and cfg.data.gaze_dir is not None:
                # the raw gaze rows of the window, not strided
                # (basedataset_darai_gaze.py:186-188)
                g = v["query_idx"]
                item["query"] = g[:int(obs_p * len(g))]
            elif self.needs_query and v.get("query_idx") is not None:
                q = np.asarray(v["query_idx"][:past_len][::sample_rate])
                item["query"] = alternating_query(q) if cfg.eval.query_mod2 else q
            groups[bucket_length(real_s, cfg.data.seq_buckets)].append(item)
        return groups

    def _forward_batch(self, modules: List[nn.Module], items: List[Dict], S: int
                       ) -> Dict[str, np.ndarray]:
        """Pad a bucket's chunk to (eval_batch, S, ...) in the storage dtype
        and run one forward per module, averaging the heads over modules.
        Filler rows keep frame 0 unmasked so no softmax row is fully masked;
        their outputs are dropped."""
        B, n = self.eval_batch, len(items)
        pin = self.device.type == "cuda"
        feats = torch.zeros((B, S) + items[0]["feats"].shape[1:], dtype=self.in_dtype,
                            pin_memory=pin)
        mask = torch.ones((B, S), dtype=torch.bool)
        mask[:, 0] = False
        depth = query = query_len = None
        gaze = self.config.data.gaze_dir is not None
        if self.is_fusion:
            depth = torch.zeros((B, S) + items[0]["depth"].shape[1:], dtype=self.in_dtype,
                                pin_memory=pin)
        if self.needs_query and gaze:
            Sq = self.config.data.gaze_pad_len or self.config.data.seq_buckets[-1]
            query = torch.zeros((B, Sq, 2), dtype=torch.float32, pin_memory=pin)
            query_len = torch.zeros((B,), dtype=torch.int32)
        elif self.needs_query:
            query = torch.zeros((B, S), dtype=torch.int32, pin_memory=pin)
        for i, it in enumerate(items):
            r = it["real_s"]
            feats[i, :r] = torch.from_numpy(np.ascontiguousarray(it["feats"]))
            mask[i, :r] = False
            mask[i, r:] = True
            if depth is not None:
                depth[i, :r] = torch.from_numpy(np.ascontiguousarray(it["depth"]))
            if query_len is not None:
                sq = min(len(it["query"]), query.shape[1])
                query[i, :sq] = torch.from_numpy(np.asarray(it["query"][:sq], np.float32))
                query_len[i] = sq
            elif query is not None:
                query[i, :r] = torch.from_numpy(np.asarray(it["query"][:r], np.int32))
        if self.is_fusion:
            args = (feats, depth, mask)
        elif self.needs_query:
            args = (feats, query, mask, query_len)
        else:
            args = (feats, mask)
        rows, seq = self._rows(), self._seq(S)
        return self._run(modules, tuple(None if t is None else cut(
            cut(t, rows), seq if t.dim() > 1 and t.shape[1] == S else None, 1).to(
            self.device, non_blocking=True) for t in args), n, seq)

    def _forward_batch_cached(self, modules: List[nn.Module], items: List[Dict], S: int,
                              data: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """``_forward_batch`` with the windows gathered on the card from the
        sweep's cached videos ``data``: the chunk ships its [B] video indices
        and valid row counts (filler rows: video 0, 0 rows)."""
        vid = torch.zeros(self.eval_batch, dtype=torch.long)
        real_s = torch.zeros(self.eval_batch, dtype=torch.long)
        for i, it in enumerate(items):
            vid[i], real_s[i] = it["ui"], it["real_s"]
        rows, seq = self._rows(), self._seq(S)
        b = assemble_eval(data, cut(vid, rows).to(self.device),
                          cut(real_s, rows).to(self.device), S, self.config.data.sample_rate,
                          seq)
        if self.is_fusion:
            args = (b["features"], b["depth"], b["mask"])
        elif self.needs_query:
            q = b["query"]
            if self.config.eval.query_mod2:
                # the parity of each whole row: on a cut sequence, of the
                # row gathered over sp, the rank's frames kept
                sp = self.sp if seq is not None else None
                q = cut_seq(alternating_query_rows(gather_seq(q, sp)), sp)
            args = (b["features"], q, b["mask"])
        else:
            args = (b["features"], b["mask"])
        return self._run(modules, args, len(items), seq)

    def _rows(self) -> Optional[slice]:
        """This rank's rows of a chunk (None: all of them)."""
        return None if self._replicate else batch_sharding(self.mesh, self.eval_batch)

    def _seq(self, S: int) -> Optional[slice]:
        """This sp rank's frames of a bucket of ``S`` (None: all of them)."""
        return None if self.sp is None else seq_sharding(self.mesh, S)

    def _run(self, modules: List[nn.Module], args, n: int, seq: Optional[slice] = None
             ) -> Dict[str, np.ndarray]:
        """One forward per module, the heads averaged over modules; the
        first ``n`` rows on the host. On a dp group ``args`` hold this
        rank's ``_rows()`` of the chunk, and the chunk's outputs are
        gathered from the group; on a cut sequence (``seq``) they hold the
        rank's frames, and the per-frame outputs are gathered over sp."""
        rows = self._rows()
        sp = self.sp if seq is not None else None
        with torch.inference_mode(), split_mesh(self.mesh, rows is not None, sp is not None):
            outs = [m(*args) for m in modules]
            outputs = {k: sum(o[k] for o in outs) / len(outs)
                       for k in OUTPUT_KEYS if k in outs[0]}
            outputs = {k: gather_seq(v, sp) if k in FRAME_KEYS else v
                       for k, v in outputs.items()}
            if rows is not None:
                outputs = {k: self._gather(v.float(), rows) for k, v in outputs.items()}
        return {k: v[:n].float().cpu().numpy() for k, v in outputs.items()}

    def _gather(self, part: torch.Tensor, rows: slice) -> torch.Tensor:
        """The chunk's [eval_batch, ...] outputs from each rank's ``rows``
        of them: zeros elsewhere, summed over the group (exact: each entry
        is one rank's value plus zeros)."""
        full = part.new_zeros((self.eval_batch,) + part.shape[1:])
        full[rows] = part
        torch.distributed.all_reduce(full, group=self.group)
        return full

    def _accumulate(self, it: Dict, outputs: Dict, i: int, acc: MoCAccumulator, stats: Dict,
                    obs_p: float, dump: Optional[List[str]] = None,
                    gif: Optional[Callable] = None) -> None:
        """Fold one video's outputs into the per-ratio accumulators; ``gif``,
        where given, renders the video's labels against the prediction."""
        cfg = self.config
        sample_rate = cfg.data.sample_rate
        none_idx = self.n_class - 1
        labels_idx = it["labels_idx"]
        past_len, future_len = it["past_len"], it["future_len"]
        action_logits = outputs["action"][i]
        if "duration" in outputs:
            frames, _ = decode_anticipation(action_logits, outputs["duration"][i], future_len,
                                            none_idx)
        else:
            # a model without a duration head (the TCN): each slot paints its share
            frames = decode_frames_from_slots(action_logits, future_len)
        prediction = np.concatenate([labels_idx[:past_len], frames])
        acc.add_video(labels_idx, prediction, obs_p)
        if gif is not None:
            gif(it, labels_idx, prediction, obs_p)

        # secondary metrics (predict_utkinects.py:305-328)
        future_sub = labels_idx[past_len: past_len + future_len][::sample_rate]
        pred_actions = np.argmax(action_logits, axis=-1)
        last_obs = labels_idx[past_len - 1]
        if dump is not None:
            # the gt/pred transcript log (predict_utkinects.py:118-134),
            # every video of a ratio in one file
            vid_tag = it["vid"] + (f"::{it['seq']}" if it["seq"] is not None else "")
            dump.append(f"--- {vid_tag} (obs {obs_p}) ---")
            dump.append("idx\tgt\tpred")
            for j in range(min(len(future_sub), len(pred_actions))):
                dump.append(f"{j}\t{int(future_sub[j])}\t{int(pred_actions[j])}")
        # the ant-accuracy protocol of the entry point's predict file; the
        # exclusion id is the eval side's (predict_utkinects.py:328)
        mode = cfg.eval.ant_acc_mode
        if mode == "weighted":
            stats["ant"] += weighted_anticipation_accuracy(
                pred_actions, future_sub, last_obs, exclude_class_idx=cfg.eval.exclude_class_idx)
        else:
            nn_ = min(len(future_sub), len(pred_actions))
            ok = pred_actions[:nn_] == future_sub[:nn_]
            if mode == "unweighted_excl" and cfg.eval.exclude_class_idx is not None:
                # predict_tcn_darai.py:146-155: the excluded class leaves the
                # numerator only
                ok = ok & (future_sub[:nn_] != cfg.eval.exclude_class_idx)
            correct = int(np.sum(ok))
            if mode == "micro":
                # predict_50salads.py:198-232: counts pooled over all videos
                stats["ant_correct"] += correct
                stats["ant_total"] += nn_
            else:
                # predict_breakfast.py:36-70: per-video plain accuracy
                stats["ant"] += (correct / nn_) if nn_ else 0.0
        if "seg" in outputs:
            seg_pred = np.argmax(outputs["seg"][i], axis=-1)
            past_sub = labels_idx[:past_len][::sample_rate]
            n = min(it["real_s"], len(past_sub))
            if n:
                stats["seg"] += float(np.mean(seg_pred[:n] == past_sub[:n]))
        # the L3 accuracy (predict_breakfast.py:121-131): pad and excluded
        # ids leave the count
        if "l3" in outputs and "query" in it:
            q = np.asarray(it["query"])
            if q.ndim == 1 and np.issubdtype(q.dtype, np.integer):
                r = it["real_s"]
                l3_pred = np.argmax(outputs["l3"][i][:r], axis=-1)
                gt = q[:r]
                valid = np.ones(r, bool)
                if cfg.train.l3_pad_idx is not None:
                    valid &= gt != cfg.train.l3_pad_idx
                if cfg.train.l3_exclude_idx is not None:
                    valid &= gt != cfg.train.l3_exclude_idx
                stats["l3_correct"] += int(np.sum((l3_pred == gt) & valid))
                stats["l3_total"] += int(valid.sum())
        stats["n"] += 1

    def _gif_renderer(self, source: VideoSource, gif_dir: str, frames_root: str) -> Callable:
        """render(it, labels, prediction, obs_p): a video's anticipation GIF
        over its first ``min(frames, len(prediction))`` frames, the observed
        ones captioned with their label (``r3d_tpu/eval/predict.py:346-366``)."""
        from r3d_tpu_torch.eval.visualize import render_anticipation_gif

        names = {v: k for k, v in source.actions_dict.items()}
        names[self.n_class - 1] = "NONE"

        def render(it: Dict, labels_idx: np.ndarray, prediction: np.ndarray, obs_p: float):
            images = source.load_meta(it["vid"], it["seq"]).get("images")
            if not images:
                return
            n_show = min(len(images), len(prediction))
            name = it["vid"].split("/")[-1].split(".")[0] + (
                f"_{it['seq']}" if it["seq"] is not None else "")
            render_anticipation_gif(
                [os.path.join(frames_root, p) for p in images[:n_show]],
                [names.get(int(x), "?") for x in labels_idx[:n_show]],
                [names.get(int(x), "?") for x in prediction[:n_show]],
                os.path.join(gif_dir, f"{name}_{obs_p}.gif"), observed_count=it["past_len"])

        return render

    def predict_multi(self, variables, source: VideoSource, obs_list, log: Callable = print,
                      gif_dir: Optional[str] = None, frames_root: str = "",
                      dump_dir: Optional[str] = None, cache_data=None
                      ) -> Dict[float, Dict[str, float]]:
        """One sweep serving every observation ratio: the windows of all
        ratios bucket together, so chunks fill across ratios. Returns, per
        ratio, the MoC of each horizon, ``ant_acc``, ``seg_acc`` and, where
        counted, ``l3_acc``; prints the reference's MoC lines. With
        ``cache_data`` (the video tensors of ``source``'s units, on the card)
        the windows are gathered there."""
        cfg = self.config
        modules = self._modules(variables)
        groups: Dict[int, List[Dict]] = collections.defaultdict(list)
        for obs_p in obs_list:
            for S, items in self._prepare(source, obs_p).items():
                for it in items:
                    it["obs_p"] = obs_p
                groups[S].extend(items)

        accs = {o: MoCAccumulator(cfg.eval.eval_p, len(source.actions_dict)) for o in obs_list}
        stats = {o: dict(ant=0.0, seg=0.0, l3_correct=0, l3_total=0, n=0, ant_correct=0,
                         ant_total=0) for o in obs_list}
        dumps = {o: [] for o in obs_list} if dump_dir is not None else None
        gif = (self._gif_renderer(source, gif_dir, frames_root)
               if gif_dir is not None and is_writer() else None)
        for S, items in sorted(groups.items()):
            for start in range(0, len(items), self.eval_batch):
                chunk = items[start: start + self.eval_batch]
                outputs = (self._forward_batch(modules, chunk, S) if cache_data is None
                           else self._forward_batch_cached(modules, chunk, S, cache_data))
                for i, it in enumerate(chunk):
                    o = it["obs_p"]
                    self._accumulate(it, outputs, i, accs[o], stats[o], o,
                                     dump=None if dumps is None else dumps[o], gif=gif)
        if dumps is not None and is_writer():
            os.makedirs(dump_dir, exist_ok=True)
            for o, lines in dumps.items():
                with open(os.path.join(dump_dir, f"gt_pred_log_{o}.txt"), "w") as f:
                    f.write("\n".join(lines) + "\n")

        all_results: Dict[float, Dict[str, float]] = {}
        for o in obs_list:
            results = accs[o].results(o)
            if is_writer():
                accs[o].print_results(o)
            st = stats[o]
            if cfg.eval.ant_acc_mode == "micro":
                results["ant_acc"] = st["ant_correct"] / max(st["ant_total"], 1)
            else:
                results["ant_acc"] = st["ant"] / max(st["n"], 1)
            results["seg_acc"] = st["seg"] / max(st["n"], 1)
            if st["l3_total"]:
                results["l3_acc"] = st["l3_correct"] / st["l3_total"]
            all_results[o] = results
        return all_results

    def predict(self, variables, source: VideoSource, obs_p: float, log: Callable = print,
                gif_dir: Optional[str] = None, frames_root: str = "", cache_data=None
                ) -> Dict[str, float]:
        """The single-ratio protocol (predict_utkinects.py:215-392)."""
        return self.predict_multi(variables, source, [obs_p], log=log, gif_dir=gif_dir,
                                  frames_root=frames_root, cache_data=cache_data)[obs_p]
