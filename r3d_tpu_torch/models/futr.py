"""FUTR input embed and heads.

Counterpart of ``r3d_tpu/models/futr.py`` (``InputEmbed`` and ``Heads``).
With ``embed_dtype="bfloat16"`` the input embed casts its input, weight and
bias to bf16 and gives bf16 out, which is then cast to the compute dtype;
everything after it runs in fp32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from r3d_tpu_torch.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def embed_dtype(cfg: ModelConfig) -> torch.dtype:
    """Dtype of only the wide input projections."""
    return DTYPES[cfg.embed_dtype or cfg.compute_dtype]


def linear_in(x, layer: nn.Linear, dtype: torch.dtype):
    """``layer(x)`` with input, weight and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class InputEmbed(nn.Module):
    """Features -> hidden, ReLU."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.input_type != "i3d_transcript":
            raise NotImplementedError(
                f"input_type {cfg.input_type!r} is not ported (ROADMAP queue A, item 11)")
        self.cfg = cfg
        self.input_embed = nn.Linear(cfg.input_dim, cfg.hidden_dim)

    def forward(self, src):
        emb = linear_in(src, self.input_embed, embed_dtype(self.cfg))
        return torch.relu(emb).to(compute_dtype(self.cfg))


class Heads(nn.Module):
    """Action, duration and segmentation heads."""

    def __init__(self, cfg: ModelConfig, n_class: int):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        if cfg.anticipate:
            self.fc = nn.Linear(C, n_class)
            self.fc_len = nn.Linear(C, 1)
        if cfg.seg:
            self.fc_seg = nn.Linear(C, n_class - 1 if cfg.seg_excludes_none else n_class)

    def forward(self, hs, memory) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cfg.anticipate:
            out["action"] = self.fc(hs).float()
            out["duration"] = self.fc_len(hs)[..., 0].float()
        if self.cfg.seg:
            out["seg"] = self.fc_seg(memory).float()
        return out
