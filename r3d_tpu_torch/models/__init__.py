"""Model registry of the port, and the seeded init that mirrors flax's.

Every model of ``r3d_tpu/models/__init__.py`` builds: the fusion models
``futr_fusion_bn``, ``futr_fusion_grad``, ``futr_fusion_vary``,
``futr_fusion_nox`` and ``afft`` (any ``fuser_depth``), ``futr``,
``futr_baseline``, the query family ``futr_proposed``,
``futr_unsupervised``, ``futr_unsupervised_temp2``,
``futr_unsupervised_temp3``, ``futr_unsupervised_depth`` and ``futr_gaze``,
and the baselines ``rnn``, ``cnn`` and ``tcn``, each in fp32 or bf16
compute, with or without ``use_encoder`` and MoE FFNs (``moe_experts > 0``)
where it has a transformer, and with the gt-label embed
(``input_type="gt"``) where it has ``InputEmbed``. Another compute dtype
raises ``NotImplementedError``; another name raises ``ValueError``, as
JAX's registry does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.baselines import (
    CNNAnticipator,
    LecunConv1d,
    LSTMStack,
    RNNAnticipator,
    TCNAnticipator,
    WNCausalConv,
)
from r3d_tpu_torch.models.fuser import CMFuserBN, CMFuserNoExchange, CMFuserVary, TorchBatchNorm
from r3d_tpu_torch.models.futr import FUTR
from r3d_tpu_torch.models.futr_fusion import FUSERS, FUTRFusion
from r3d_tpu_torch.models.futr_unsupervised import FUTRUnsupervised
from r3d_tpu_torch.models.layers import DTYPES
from r3d_tpu_torch.models.moe import Router, StackedLinear

BASELINES = {"rnn": RNNAnticipator, "cnn": CNNAnticipator, "tcn": TCNAnticipator}

def is_fusion_model(name: str) -> bool:
    return name in FUSERS


# Models whose forward takes (features, query, src_pad_mask, query_len):
# the FUTRUnsupervised family. The trainer and the sweep build their inputs
# from this list.
QUERY_MODELS = (
    "futr_unsupervised",
    "futr_proposed",
    "futr_gaze",
    "futr_unsupervised_depth",
    "futr_unsupervised_temp2",
    "futr_unsupervised_temp3",
)


def model_needs_query(name: str) -> bool:
    return name in QUERY_MODELS


# the query source of each model of the family (r3d_tpu/models/__init__.py:52-67)
_QUERY_SOURCES = {
    "futr_unsupervised_depth": "depth",
    "futr_proposed": "gt",
    "futr_unsupervised": "self_attention",
    "futr_unsupervised_temp2": "self_attention",
    "futr_unsupervised_temp3": "self_attention",
    "futr_gaze": "gaze",
}


def build_model(cfg: ModelConfig, n_class: int,
                depth_shape: Sequence[int] = (160, 120)) -> nn.Module:
    """The module for ``cfg.model``; ``depth_shape`` is the per-frame shape
    of the raw depth input (``DataConfig.depth_shape``) of the fusion
    models. ``futr_unsupervised_depth`` takes the trainer's route, the
    [B, S] L3 ids in the query slot, so its depth projection is 1 wide."""
    if cfg.compute_dtype not in DTYPES:
        raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r} is not ported")
    if cfg.model in ("futr", "futr_baseline"):
        # model/futr_baseline.py: futr + output['supcon'] = decoder output
        return FUTR(cfg, n_class, emit_supcon=cfg.model == "futr_baseline")
    if cfg.model in _QUERY_SOURCES:
        variant = cfg.model[len("futr_unsupervised_"):] if "_temp" in cfg.model else ""
        return FUTRUnsupervised(cfg, n_class, _QUERY_SOURCES[cfg.model], variant)
    if cfg.model in BASELINES:
        return BASELINES[cfg.model](cfg, n_class)
    if cfg.model not in FUSERS:
        raise ValueError(f"unknown model {cfg.model!r}")
    return FUTRFusion(cfg, n_class, math.prod(depth_shape))


def _xavier_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (the std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn as the flax init draws them (not the same
    numbers): xavier-uniform Linear weights and pos_embedding, zero biases,
    LayerNorm and BatchNorm at ones/zeros with unit running variance,
    FUTR's query_embed ~ N(0, 1), ``futr_fusion_bn``'s alpha ~ U(0, 1) and
    ``futr_fusion_vary``'s at ones, the modality token of
    ``futr_fusion_nox`` and ``afft`` ~ N(0, 1), an Embedding's table
    xavier-uniform with fan_in its rows and fan_out its width (flax's
    ``Embed(embedding_init=xavier)``), the raw ``query_embed`` of ``temp2``
    xavier-uniform, a Conv2d's kernel as flax's ``Conv`` default
    (truncated lecun normal) with a zero bias. MoE: the router lecun normal
    (flax's default Dense), each expert's linears xavier-uniform over its
    own [in, out]. Baselines: the LSTM's input kernels lecun normal, each
    gate's recurrent kernel orthogonal, zero biases; the WN conv's ``v``
    and the TCN's ``down`` convs ~ N(0, 0.01) with ``g`` = ||v|| and zero
    biases; the ``regression`` conv lecun normal."""
    for m in model.modules():
        if isinstance(m, Router):
            _lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, nn.Linear):
            _xavier_(m.weight, m.in_features, m.out_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, TorchBatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, TorchBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _xavier_(m.weight, m.num_embeddings, m.embedding_dim, generator)
        elif isinstance(m, StackedLinear):
            for w in m.weight:
                _xavier_(w, w.shape[1], w.shape[0], generator)
            m.bias.zero_()
        elif isinstance(m, LSTMStack):
            h = m.hidden_size
            for name, p in m.named_parameters():
                if name.startswith("weight_ih"):
                    _lecun_normal_(p, p.shape[1], generator)
                elif name.startswith("weight_hh"):
                    for gate in p.view(4, h, h):
                        nn.init.orthogonal_(gate, generator=generator)
                else:
                    p.zero_()
        elif isinstance(m, WNCausalConv):
            m.v.normal_(0.0, 0.01, generator=generator)
            m.g.copy_(m.v.flatten(1).norm(dim=1))
            m.bias.zero_()
        elif isinstance(m, LecunConv1d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.zero_()
        elif isinstance(m, CMFuserBN):
            m.alpha.uniform_(0.0, 1.0, generator=generator)
        elif isinstance(m, CMFuserVary):
            m.alpha.fill_(1.0)
        elif isinstance(m, CMFuserNoExchange):
            m.modality_token.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (FUTR, FUTRFusion, FUTRUnsupervised)):
            if hasattr(m, "pos_embedding"):
                _, L, C = m.pos_embedding.shape
                _xavier_(m.pos_embedding, L, C, generator)
            qe = getattr(m, "query_embed", None)
            if isinstance(qe, nn.Parameter) and isinstance(m, FUTRUnsupervised):
                _xavier_(qe, *qe.shape, generator)   # temp2's query_embed
            elif isinstance(qe, nn.Parameter):
                qe.normal_(0.0, 1.0, generator=generator)
    return model
