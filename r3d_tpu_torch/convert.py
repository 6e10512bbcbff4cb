"""Carry flax weights across: ``{"params", "batch_stats"}`` -> ``state_dict``.

A gradient pytree converts the same way (``{"params": grads}``), which is
how the tests hold the port's ``.grad`` against ``jax.grad``.

The leaves may be numpy arrays or anything ``np.asarray`` reads. Rules,
applied to each leaf by its path:

- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in], a Conv
  ``kernel`` [H, W, in, out] (HWIO) ``weight`` [out, in, H, W] (OIHW);
- a LayerNorm or BatchNorm ``scale`` becomes ``weight``;
- an ``nn.Embed``'s ``embedding`` [num, C] becomes ``nn.Embedding``'s
  ``weight`` [num, C], untransposed;
- the FuserBlock's flat names split at the last underscore
  (``mlp1_kernel`` -> ``mlp1.weight``, ``norm_scale`` -> ``norm.weight``);
- ``layer{i}`` becomes ``layers.{i}`` (the decoder's and the encoder's,
  ``encoder/layer{i}`` -> ``encoder.layers.{i}``); the fuser's blocks
  ``safuser/block{i}`` keep their names;
- BatchNorm statistics ``mean`` / ``var`` become ``running_mean`` /
  ``running_var``;
- everything else (``pos_embedding`` [1, L, C], the raw ``query_embed``
  parameter [Q, C] of FUTR and of ``temp2``, ``alpha`` [1, 1, C] of the BN
  and vary fusers, ``modality_token`` [1, 1, 1, C], biases) keeps its name
  and shape, and ``afft``'s Dense heads ``fc`` and ``fc_len`` convert as
  any Dense.

The rules are local to a leaf, so any subtree of a flax model converts to
the ``state_dict`` of the port's module at the same place.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_FLAT = re.compile(r"^(\w+)_(kernel|scale|bias)$")
_LAYER = re.compile(r"^layer(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(path: Tuple[str, ...]) -> list:
    return [f"layers.{m.group(1)}" if (m := _LAYER.match(p)) else p for p in path]


def _param(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    mods = _module_path(tuple(mods))
    m = _FLAT.match(leaf)
    if m:
        mods.append(m.group(1))
        leaf = m.group(2)
    if leaf == "kernel":
        leaf, value = "weight", value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), value


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of a model (or of one of its submodules) -> the
    port's ``state_dict`` for the module at the same place."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        key, value = _param(path, np.asarray(leaf, np.float32))
        sd[key] = torch.from_numpy(np.array(value, np.float32))
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mods, stat = path
        key = ".".join(_module_path(tuple(mods)) + [_STATS[stat]])
        sd[key] = torch.from_numpy(np.array(leaf, np.float32))
    return sd
