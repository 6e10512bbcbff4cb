"""Int8 weight-only quantization for serving.

Counterpart of ``r3d_tpu/ops/quant.py``, kept here as the port's own copy.
The matmul weights store as symmetric per-output-channel int8 plus one fp32
scale per output channel, cutting their bytes on the card about 4x.
Dequantization runs inside the forward at every chunk
(``serving.InferenceSession(..., quantize="int8")``): the card holds the
int8, and each weight becomes ``q * scale`` in fp32, one elementwise launch
(int8 times fp32 promotes to fp32), just before the model reads it.

Which weights quantize is JAX's rule, leaf by leaf: a floating leaf whose
flax path names a ``kernel``, with at least two dimensions and at least
``QUANT_MIN_ELEMS`` elements. The port's names are not flax's, so the set
comes from the converter (``convert.flax_kernels``), which also says where
the output channel went: JAX reduces over every axis of a flax kernel but
the last, its output, which is dim 0 of a ``Linear`` or conv weight, dim 1
of the MoE's stacked expert weights [E, out, in] (one scale an output
channel across the experts, as in JAX). An LSTM's ``weight_ih`` and
``weight_hh`` stack four flax gate kernels along their rows: each gate is
eligible on its own size, and its rows are its output channels, so a row
keeps its gate's scale. Biases, norms, positional tables and the learned
queries stay in float.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

QUANT_MIN_ELEMS = 4096


class QuantizedTensor(NamedTuple):
    """Symmetric int8 weights and fp32 per-output-channel scales (the
    scale's shape is the weight's with every dim but the output's at 1)."""

    q: torch.Tensor
    scale: torch.Tensor


Weights = Dict[str, Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]


def quantize_array(w: torch.Tensor, out_dim: int = 0) -> QuantizedTensor:
    """absmax/127 per output channel (``out_dim``); zero channels get scale 1;
    round half to even, as ``jnp.round``, then clip to +-127."""
    w = w.detach().float()
    red = tuple(d for d in range(w.ndim) if d != out_dim)
    absmax = w.abs().amax(dim=red, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def eligible(t: torch.Tensor, blocks: int = 1) -> bool:
    """JAX's size rule on a flax kernel: at least 2 dims and
    ``QUANT_MIN_ELEMS`` elements. ``blocks`` flax kernels stacked along dim
    0 (an LSTM's four gates) are each held to it."""
    return t.is_floating_point() and t.ndim >= 2 and t.numel() // blocks >= QUANT_MIN_ELEMS


def quantize_state_dict(weights: Mapping[str, torch.Tensor],
                        kernels: Mapping[str, Tuple[int, int]]) -> Dict[str, object]:
    """Quantize every eligible entry of ``weights`` named in ``kernels``
    (name -> (output dim, stacked flax kernels), ``convert.flax_kernels``)
    to a ``QuantizedTensor``; every other entry passes through."""
    out: Dict[str, object] = {}
    for name, t in weights.items():
        if name in kernels and eligible(t, kernels[name][1]):
            out[name] = quantize_array(t, kernels[name][0])
        else:
            out[name] = t
    return out


def dequantize_state_dict(weights: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_state_dict`` (a ``QuantizedTensor`` or a plain
    (q, scale) tuple becomes ``q * scale`` in fp32); the rest passes
    through. Called inside the forward, so the card keeps the int8."""
    return {name: (t[0] * t[1] if isinstance(t, tuple) else t) for name, t in weights.items()}


def quantized_nbytes(weights: Mapping[str, object]) -> int:
    """Bytes of every tensor in ``weights`` (int8 values and scales counted)."""
    return sum(t.numel() * t.element_size()
               for v in weights.values() for t in (v if isinstance(v, tuple) else (v,)))
