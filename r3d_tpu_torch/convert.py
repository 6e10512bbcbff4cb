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
- an MoE layer's stacked expert kernels ``experts/linear{1,2}/kernel``
  [E, in, out] become ``weight`` [E, out, in] (each expert's Dense
  transposed; a plain ``.T`` would give [out, in, E]);
- a weight-normalised conv's ``v`` [k, in, out] becomes ``v`` [out, in, k]
  (a Conv ``kernel`` [k, in, out] of a 1-D conv becomes ``weight``
  [out, in, k] by the Dense rule's ``.T``);
- the four cells of a bidirectional 2-layer LSTM, which flax names
  ``OptimizedLSTMCell_{0..3}`` in the order the stack creates them (layer
  0 forward, layer 0 backward, layer 1 forward, layer 1 backward), become
  ``nn.LSTM``'s ``weight_ih_l{layer}`` (the input kernels ``ii, if, ig,
  io`` transposed and stacked in that gate order), ``weight_hh_l{layer}``
  (``hi, hf, hg, ho``), ``bias_hh_l{layer}`` (their biases) and a zero
  ``bias_ih_l{layer}``, with ``_reverse`` for the backward cells. This is
  the one rule that reads several leaves;
- everything else (``pos_embedding`` [1, L, C], the raw ``query_embed``
  parameter [Q, C] of FUTR and of ``temp2``, ``alpha`` [1, 1, C] of the BN
  and vary fusers, ``modality_token`` [1, 1, 1, C], biases) keeps its name
  and shape, and ``afft``'s Dense heads ``fc`` and ``fc_len`` convert as
  any Dense.

Every rule but the LSTM's is local to a leaf, so any subtree of a flax
model converts to the ``state_dict`` of the port's module at the same place
(an LSTM's whole stack at once).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_FLAT = re.compile(r"^(\w+)_(kernel|scale|bias)$")
_LAYER = re.compile(r"^layer(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}
_LSTM_CELL = re.compile(r"^OptimizedLSTMCell_(\d+)$")
_LSTM_GATES = {"ih": ("ii", "if", "ig", "io"), "hh": ("hi", "hf", "hg", "ho")}


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
    if leaf == "kernel" and "experts" in mods:
        leaf, value = "weight", value.transpose(0, 2, 1)
    elif leaf == "kernel":
        leaf, value = "weight", value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    elif leaf == "v" and value.ndim == 3:
        value = value.transpose(2, 1, 0)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), value


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of a model (or of one of its submodules) -> the
    port's ``state_dict`` for the module at the same place."""
    sd: Dict[str, torch.Tensor] = {}
    cells: Dict[Tuple[Tuple[str, ...], int], Dict[Tuple[str, str], np.ndarray]] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        value = np.asarray(leaf, np.float32)
        cell = [i for i, p in enumerate(path) if _LSTM_CELL.match(p)]
        if cell:
            i = cell[0]
            n = int(_LSTM_CELL.match(path[i]).group(1))
            cells.setdefault((path[:i], n), {})[path[i + 1], path[-1]] = value
            continue
        key, value = _param(path, value)
        sd[key] = torch.from_numpy(np.array(value, np.float32))
    for (prefix, n), leaves in cells.items():
        name = ".".join(_module_path(prefix) + [""])
        suffix = f"l{n // 2}" + ("_reverse" if n % 2 else "")
        for side, gates in _LSTM_GATES.items():
            w = np.concatenate([leaves[g, "kernel"].T for g in gates])
            sd[f"{name}weight_{side}_{suffix}"] = torch.from_numpy(np.array(w, np.float32))
        b = np.concatenate([leaves[g, "bias"] for g in _LSTM_GATES["hh"]])
        sd[f"{name}bias_hh_{suffix}"] = torch.from_numpy(np.array(b, np.float32))
        sd[f"{name}bias_ih_{suffix}"] = torch.zeros(len(b))
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mods, stat = path
        key = ".".join(_module_path(tuple(mods)) + [_STATS[stat]])
        sd[key] = torch.from_numpy(np.array(leaf, np.float32))
    return sd


def flax_kernels(model: torch.nn.Module) -> Dict[str, Tuple[int, int]]:
    """The entries of ``model``'s ``state_dict`` that the rules above make
    from flax ``kernel`` leaves, each with (the dim its output channel went
    to, the number of flax kernels stacked in it): a Dense kernel or a Conv
    kernel (``nn.Linear``, ``nn.Conv1d``, ``nn.Conv2d`` ``weight``) puts its
    last axis first, (0, 1); the MoE's stacked expert kernels under
    ``experts`` [E, in, out] -> [E, out, in], (1, 1); an LSTM's
    ``weight_ih_l*`` and ``weight_hh_l*`` stack four gate kernels' outputs
    along dim 0, (0, 4). Everything else (``scale``, ``embedding``, a WN
    conv's ``v``, raw parameters such as ``pos_embedding``) is not a
    kernel. ``ops.quant`` quantizes from this set, as JAX's ``quantize_tree``
    does from the leaves whose path names a kernel."""
    out: Dict[str, Tuple[int, int]] = {}
    for mod_name, module in model.named_modules():
        prefix = mod_name + "." if mod_name else ""
        if isinstance(module, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d)):
            out[prefix + "weight"] = (0, 1)
        elif isinstance(module, torch.nn.LSTM):
            for name, _ in module.named_parameters(recurse=False):
                if name.startswith(("weight_ih", "weight_hh")):
                    out[prefix + name] = (0, 4)
        elif "experts" in mod_name.split(".") and isinstance(
                getattr(module, "weight", None), torch.nn.Parameter):
            out[prefix + "weight"] = (1, 1)
    return out


def flax_path(model: torch.nn.Module, name: str) -> Tuple[str, Tuple[int, ...]]:
    """The flax leaf a ``state_dict`` entry of ``model`` is made from, the
    rules above run backwards: (its path, ``"a/layer0/b/kernel"``, and the
    permutation that takes the flax leaf's axes to the entry's, so that the
    entry's axis ``i`` is the leaf's axis ``perm[i]``). An LSTM's stacked
    gate weights name their module's path and keep their own name: several
    leaves make each of them."""
    from r3d_tpu_torch.models.fuser import FuserBlock, TorchBatchNorm, _SAFuserCore

    *mods, leaf = name.split(".")
    module = model.get_submodule(".".join(mods))
    parent = model.get_submodule(".".join(mods[:-1])) if mods else None
    value = getattr(module, leaf)
    perm = tuple(range(value.dim()))
    if leaf == "weight" and "experts" in mods:
        leaf, perm = "kernel", (0, 2, 1)
    elif leaf == "weight" and isinstance(module, (torch.nn.Linear, torch.nn.Conv1d,
                                                  torch.nn.Conv2d)):
        leaf = "kernel"
        perm = (3, 2, 0, 1) if value.dim() == 4 else tuple(reversed(perm))
    elif leaf == "v" and value.dim() == 3:
        perm = (2, 1, 0)
    elif leaf == "weight" and isinstance(module, (torch.nn.LayerNorm, TorchBatchNorm)):
        leaf = "scale"
    elif leaf == "weight" and isinstance(module, torch.nn.Embedding):
        leaf = "embedding"
    if isinstance(parent, (FuserBlock, _SAFuserCore)):
        leaf = f"{mods.pop()}_{leaf}"
    parts, i = [], 0
    while i < len(mods):
        if mods[i] == "layers" and i + 1 < len(mods) and mods[i + 1].isdigit():
            parts.append(f"layer{mods[i + 1]}")
            i += 2
        else:
            parts.append(mods[i])
            i += 1
    return "/".join(parts + [leaf]), perm
