"""FUTR decoder stack with the bypassed encoder.

Counterpart of ``r3d_tpu/models/transformer.py``. Every reference entry
point runs with the encoder bypassed (``memory = src``), and so does the
port: ``use_encoder=True`` and the L3 query generation (``query_pos=None``)
are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from torch import nn

from r3d_tpu_torch.models.layers import DecoderLayer


class TransformerDecoder(nn.Module):
    """Sequential decoder layers and the reference's unconditional final
    LayerNorm."""

    def __init__(self, dim: int, n_head: int, n_layers: int, ffn_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(dim, n_head, ffn_dim) for _ in range(n_layers)
        )
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, pos, query_pos, memory_key_padding_mask)
        return self.norm(out)


class FUTRTransformer(nn.Module):
    """(memory, hs) = transformer(src, pos, queries) with memory = src."""

    def __init__(self, dim: int, n_head: int, n_decoder_layers: int, ffn_dim: int,
                 use_encoder: bool = False):
        super().__init__()
        if use_encoder:
            raise NotImplementedError(
                "use_encoder=True is not ported yet (ROADMAP queue A, item 3)")
        self.decoder = TransformerDecoder(dim, n_head, n_decoder_layers, ffn_dim)

    def forward(self, src, pos, query_pos, src_key_padding_mask=None):
        if query_pos is None:
            raise NotImplementedError(
                "L3 query generation is not ported yet (ROADMAP queue A, item 11)")
        memory = src
        hs = self.decoder(query_pos.new_zeros(query_pos.shape), memory, pos,
                          query_pos, src_key_padding_mask)
        return memory, hs
