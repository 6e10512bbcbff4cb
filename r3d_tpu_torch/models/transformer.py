"""FUTR encoder-decoder stack.

Counterpart of ``r3d_tpu/models/transformer.py``. Every reference entry
point runs with the encoder bypassed (``memory = src``, COMPAT #1), and so
does the port by default; ``use_encoder=True`` runs the post-norm encoder
stack over the source first (``r3d_tpu/models/transformer.py:24-47,
240-248``). ``moe`` = (experts, top_k, capacity_factor) with experts > 0
makes every FFN of both stacks a ``MoEFeedForward``.

L3 query generation (``l3_queries=True``, then ``query_pos=None``;
``r3d_tpu/models/transformer.py:251-263``, which no model of the JAX
package reaches): ``l3_attention`` (queries the memory, keys and values the
source, no mask, no dropout), plus the sinusoidal encoding, pooled to
``n_query`` rows (``adaptive_avg_pool1d``), are the decoder's queries.

Sequence parallelism (``parallel.mesh.seq_axis()`` set): the encoder runs
on the rank's S/sp frames (ring attention, ``models/layers.py``), then the
decoder's keys and values (``memory + pos``) and the memory's padding mask
are gathered over sp (``gather_seq``, one collective each). The decoder
then runs one of two ways:

- ``n_query`` queries (``seq_queries=False``): on the whole sequence,
  replicated on the sp ranks, as JAX's program computes it on each sp
  device;
- S queries (``seq_queries=True``, the gt and depth sources): the queries
  are the rank's frames, the self-attention on the sequence stream (the
  ring, or the gathered call under dropout), the cross-attention the
  rank's query rows against the gathered keys (``MultiheadAttention``'s
  ``seq="q"``: the kernels run on the rank's rows, their route chosen as
  one process's), and ``hs`` comes back as the rank's frames.

L3 generation on sp: ``l3_attention`` is S queries against S keys on the
sequence stream (``seq=True``), the encoding takes the rank's positions,
and the pool to ``n_query`` rows runs on the stream gathered over sp. The
memory handed back stays the rank's block, so the segmentation head runs on
the rank's frames.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from r3d_tpu_torch.parallel.mesh import gather_rows, group_size, row_group, seq_axis
from r3d_tpu_torch.parallel.pipeline import (
    PipelineFallbackWarning,
    draw_base_seed,
    gpipe,
    pipeline_plan,
    stage_generators,
    stage_layers,
)
from r3d_tpu_torch.parallel.tensor import Axis, gather_seq, seq_positions
from r3d_tpu_torch.models.layers import (
    DecoderLayer,
    EncoderLayer,
    LayerNorm,
    MultiheadAttention,
    adaptive_avg_pool1d,
    sinusoidal_positional_encoding,
)


class TransformerEncoder(nn.Module):
    """Sequential encoder layers, no final LayerNorm (as JAX's)."""

    def __init__(self, dim: int, n_head: int, n_layers: int, ffn_dim: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 moe: Optional[tuple] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, n_head, ffn_dim, dropout, dtype, moe) for _ in range(n_layers)
        )

    def forward(self, src, pos, key_padding_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, pos, key_padding_mask)
        return out


class TransformerDecoder(nn.Module):
    """Decoder layers and the reference's unconditional final LayerNorm.

    On a pp mesh (``set_pipeline``, which ``parallel.mesh.place_model``
    calls) the stack runs as the GPipe pipeline where ``pipeline_plan``
    applies (``r3d_tpu/models/transformer.py:72-113``): each pp rank its
    stage's layers over M microbatches of its rows (``parallel/pipeline.py``),
    or, where a microbatch's rows do not divide over dp (JAX replicates
    them), of the dp group's rows gathered, its own rows kept. A MoE
    decoder declines with JAX's warning; every decline runs the stack
    sequentially on every pp rank."""

    def __init__(self, dim: int, n_head: int, n_layers: int, ffn_dim: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 moe: Optional[tuple] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(dim, n_head, ffn_dim, dropout, dtype, moe) for _ in range(n_layers)
        )
        self.norm = LayerNorm(dim, dtype)
        self.moe = moe is not None and moe[0] > 0
        self.pp: Optional[Axis] = None
        self.sp_size = 1

    def set_pipeline(self, pp: Optional[Axis], sp_size: int) -> None:
        """The mesh's pp axis (None: one rank) and its sp extent."""
        self.pp, self.sp_size = pp, sp_size

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None,
                tgt_key_padding_mask=None, seq: bool = False):
        plan = None
        if self.pp is not None and self.moe:
            warnings.warn(
                "mesh has pp>1 but the MoE decoder declined the pipeline (the stage body "
                "would drop the MoE aux-loss sow) — the layer stack runs sequentially on "
                "every pp rank", PipelineFallbackWarning, stacklevel=2)
        elif self.pp is not None:
            plan = pipeline_plan(self.pp, self.sp_size, len(self.layers),
                                 tgt.shape[0] * group_size(row_group()))
        if plan is not None:
            return self.norm(self._pipelined(plan, tgt, memory, pos, query_pos,
                                             memory_key_padding_mask, tgt_key_padding_mask,
                                             seq))
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, pos, query_pos, memory_key_padding_mask,
                        tgt_key_padding_mask, seq)
        return self.norm(out)

    def _pipelined(self, plan, tgt, memory, pos, query_pos, memory_key_padding_mask,
                   tgt_key_padding_mask, seq):
        pp, M = plan
        consts = {"memory": memory, "pos": pos, "query_pos": query_pos,
                  "mkpm": memory_key_padding_mask, "tkpm": tgt_key_padding_mask}
        B = tgt.shape[0]
        rows = row_group() if B % M else None
        if rows is not None:
            # the microbatches' rows do not divide over dp: the dp group's
            # rows, each rank its own kept after
            tgt = gather_rows(tgt, rows)
            consts = {k: None if v is None else gather_rows(v, rows) for k, v in consts.items()}
        mine = stage_layers(len(self.layers), pp)
        base = draw_base_seed(self.layers)

        def stage(x, c, m):
            for li in mine:
                with stage_generators(self.layers[li], base, li, m):
                    x = self.layers[li](x, c["memory"], c["pos"], c["query_pos"], c["mkpm"],
                                        c["tkpm"], seq)
            return x

        out = gpipe(stage, pp, M, tgt, consts, list(self.layers.parameters()))
        if rows is not None:
            r = torch.distributed.get_rank(rows)
            out = out[r * B:(r + 1) * B]
        return out


class FUTRTransformer(nn.Module):
    """(memory, hs) = transformer(src, pos, queries): memory = src, or the
    encoder stack of ``n_encoder_layers`` over it (none at 0, the config's
    ``use_encoder=False``). With ``l3_queries`` the queries may be None:
    they are generated from the memory and the source."""

    def __init__(self, dim: int, n_head: int, n_decoder_layers: int, ffn_dim: int,
                 n_encoder_layers: int = 0, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, moe: Optional[tuple] = None,
                 l3_queries: bool = False, n_query: int = 8, max_pos_len: int = 2000):
        super().__init__()
        self.encoder = (TransformerEncoder(dim, n_head, n_encoder_layers, ffn_dim, dropout, dtype,
                                           moe) if n_encoder_layers else None)
        self.decoder = TransformerDecoder(dim, n_head, n_decoder_layers, ffn_dim, dropout,
                                          dtype, moe)
        if l3_queries:
            self.n_query = n_query
            self.l3_attention = MultiheadAttention(dim, n_head, 0.0, dtype)
            self.register_buffer("pe", sinusoidal_positional_encoding(max_pos_len, dim),
                                 persistent=False)

    def forward(self, src, pos, query_pos, src_key_padding_mask=None,
                tgt_key_padding_mask=None, seq_queries: bool = False):
        """``tgt_key_padding_mask`` [B, Q] (True = pad) masks padded query
        rows out of the decoder self-attention; ``seq_queries``: the
        queries are the sequence stream (under sp the rank's frames, as
        ``tgt_key_padding_mask`` and the returned ``hs`` are)."""
        memory = src if self.encoder is None else self.encoder(src, pos, src_key_padding_mask)
        sp = seq_axis()
        if query_pos is None:
            if not hasattr(self, "l3_attention"):
                raise ValueError("query_pos=None needs a transformer built with l3_queries=True")
            src_l3 = self.l3_attention(memory, src, src, seq=True)
            pe = seq_positions(self.pe, src.shape[1], sp).to(src_l3.dtype)
            query_pos = adaptive_avg_pool1d(gather_seq(src_l3 + pe, sp), self.n_query)
        keys, key_pos, key_mask = memory, pos, src_key_padding_mask
        if sp is not None:
            # the decoder reads memory + pos alone: one gather
            keys = gather_seq(memory if pos is None else memory + pos, sp)
            key_pos = None
            key_mask = None if key_mask is None else gather_seq(key_mask, sp)
        hs = self.decoder(query_pos.new_zeros(query_pos.shape), keys, key_pos,
                          query_pos, key_mask, tgt_key_padding_mask, seq_queries)
        return memory, hs
