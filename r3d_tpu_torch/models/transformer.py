"""FUTR decoder stack with the bypassed encoder.

Counterpart of ``r3d_tpu/models/transformer.py``. Every reference entry
point runs with the encoder bypassed (``memory = src``), and so does the
port: ``use_encoder=True`` and the L3 query generation (``query_pos=None``,
``r3d_tpu/models/transformer.py:251-262``, which no model of the JAX
package reaches) are not ported yet (ROADMAP queue A, item A11.4).
"""

from __future__ import annotations

import torch
from torch import nn

from r3d_tpu_torch.models.layers import DecoderLayer, LayerNorm


class TransformerDecoder(nn.Module):
    """Sequential decoder layers and the reference's unconditional final
    LayerNorm."""

    def __init__(self, dim: int, n_head: int, n_layers: int, ffn_dim: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(dim, n_head, ffn_dim, dropout, dtype) for _ in range(n_layers)
        )
        self.norm = LayerNorm(dim, dtype)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None,
                tgt_key_padding_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, pos, query_pos, memory_key_padding_mask,
                        tgt_key_padding_mask)
        return self.norm(out)


class FUTRTransformer(nn.Module):
    """(memory, hs) = transformer(src, pos, queries) with memory = src."""

    def __init__(self, dim: int, n_head: int, n_decoder_layers: int, ffn_dim: int,
                 use_encoder: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_encoder:
            raise NotImplementedError(
                "use_encoder=True is not ported yet (ROADMAP queue A, item A11.4)")
        self.decoder = TransformerDecoder(dim, n_head, n_decoder_layers, ffn_dim, dropout,
                                          dtype)

    def forward(self, src, pos, query_pos, src_key_padding_mask=None,
                tgt_key_padding_mask=None):
        """``tgt_key_padding_mask`` [B, Q] (True = pad) masks padded query
        rows out of the decoder self-attention."""
        if query_pos is None:
            raise NotImplementedError(
                "L3 query generation (query_pos=None) is not ported yet "
                "(ROADMAP queue A, item A11.4)")
        memory = src
        hs = self.decoder(query_pos.new_zeros(query_pos.shape), memory, pos,
                          query_pos, src_key_padding_mask, tgt_key_padding_mask)
        return memory, hs
