"""The ablation baselines: BiLSTM (``rnn``), pooling only (``cnn``) and the
dilated TCN (``tcn``).

Counterpart of ``r3d_tpu/models/baselines.py`` (the reference's
``model/rnn.py``, ``model/cnn.py`` and ``model/tcn.py``). Each takes
(features [B, S, input_dim], src_pad_mask [B, S] bool with True = pad, or
None). A mask gives each row its true length: the pools to 8 rows use each
row's own bin edges (``masked_adaptive_avg_pool1d``), the LSTM runs each row
packed to its length, and the TCN's temporal mean divides by it.

- ``RNNAnticipator``: ``InputEmbed``, a 2-layer bidirectional LSTM of
  hidden/2 a direction (``nn.LSTM``, fp32; packed where there is a mask, so
  the reverse pass starts at each row's last real frame, as JAX's
  ``seq_lengths`` does, and pad rows come out zero where JAX leaves values
  there that no output reads but ``supcon``), ``rnn_fc``, the pool to 8
  rows, then ``fc`` / ``fc_len`` on the pool and ``fc_seg`` (n_class - 1
  wide) on the embedded stream; ``supcon`` is the ``rnn_fc`` stream.
- ``CNNAnticipator``: ``InputEmbed``, the pool, the same heads; ``supcon``
  is the embedded stream.
- ``TCNAnticipator``: four blocks of two weight-normalised causal dilated
  convs (channels 256, 512, 512, 256, kernel 3, dilation 2**i, ReLU and a
  hard-coded ``Dropout(0.2)`` after each, a 1x1 ``down`` conv where the
  width changes, the residual and a ReLU), a 1x1 ``regression`` conv to
  8 x n_class, and the temporal mean over the true rows: ``action``
  [B, 8, n_class] only, no duration or seg head. Its dropouts are
  ``FixedDropout``: on in the sticky epochs of the ``tcn`` loop, as in
  JAX's frozen twin (ROADMAP C4).

JAX computes the LSTM and the convs outside any Pallas kernel; the port
runs them in cuDNN.

Sequence parallelism (``parallel.mesh.seq_axis()`` set; the features and
the mask are the rank's S/sp frames): each model gathers over sp, with the
mask and so the lengths, what the first layer that mixes frames reads (the
embedded stream before the LSTM or the pool, the TCN's features before its
convs), and everything after runs on the whole sequence, replicated on the
sp ranks; ``seg`` is read off the rank's own embedded frames, and
``supcon`` is cut back to them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from r3d_tpu_torch.config import ModelConfig
from r3d_tpu_torch.models.futr import InputEmbed, compute_dtype
from r3d_tpu_torch.models.layers import (
    FixedDropout,
    adaptive_avg_pool1d,
    linear_in,
    masked_adaptive_avg_pool1d,
)
from r3d_tpu_torch.parallel.mesh import seq_axis
from r3d_tpu_torch.parallel.tensor import cut_seq, gather_seq

POOL_ROWS = 8   # rnn.py:97 hard-codes the pool to 8
TCN_DROPOUT = 0.2   # tcn.py's hard-coded dropout rate


def _lengths(src_pad_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if src_pad_mask is None else (~src_pad_mask).sum(-1)


def _whole(x: torch.Tensor, src_pad_mask: Optional[torch.Tensor]):
    """(``x`` [B, S, ...], the rows' lengths): under sp, gathered over it
    with the mask (one process's stream and lengths otherwise)."""
    sp = seq_axis()
    mask = None if src_pad_mask is None else gather_seq(src_pad_mask, sp)
    return gather_seq(x, sp), _lengths(mask)


def _pool8(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    if lengths is None:
        return adaptive_avg_pool1d(x, POOL_ROWS)
    return masked_adaptive_avg_pool1d(x, POOL_ROWS, lengths)


class LSTMStack(nn.LSTM):
    """2-layer bidirectional LSTM, hidden // 2 a direction, batch-major, in
    fp32 (flax's cells compute in the promoted dtype of an fp32 carry).
    flax's cells have one bias a gate, on the recurrent side, so
    ``bias_ih_*`` stay zero and out of training (``requires_grad`` off;
    the optimizer takes only trainable parameters)."""

    def __init__(self, dim: int, hidden: int, num_layers: int = 2):
        super().__init__(dim, hidden // 2, num_layers=num_layers, bidirectional=True,
                         batch_first=True)
        for name, p in self.named_parameters():
            if name.startswith("bias_ih"):
                p.requires_grad_(False)

    def forward(self, x, lengths: Optional[torch.Tensor] = None):
        # cuDNN keeps what its backward needs only in training mode; with no
        # dropout between layers the mode changes nothing else, so a forward
        # a backward may follow (the sticky epochs' module-eval forward)
        # runs in it
        mode = self.training
        self.training = mode or torch.is_grad_enabled()
        try:
            x = x.float()
            if lengths is None:
                return super().forward(x)[0]
            packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                          enforce_sorted=False)
            out = super().forward(packed)[0]
            return pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])[0]
        finally:
            self.training = mode


class _Heads(nn.Module):
    """``fc`` / ``fc_len`` on the pooled rows, ``fc_seg`` on the stream."""

    def __init__(self, cfg: ModelConfig, n_class: int):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        if cfg.anticipate:
            self.fc = nn.Linear(C, n_class)
            self.fc_len = nn.Linear(C, 1)
        if cfg.seg:
            self.fc_seg = nn.Linear(C, n_class - 1)

    def heads(self, pooled, src) -> Dict[str, torch.Tensor]:
        dt = compute_dtype(self.cfg)
        out: Dict[str, torch.Tensor] = {}
        if self.cfg.anticipate:
            out["action"] = linear_in(pooled, self.fc, dt).float()
            out["duration"] = linear_in(pooled, self.fc_len, dt)[..., 0].float()
        if self.cfg.seg:
            out["seg"] = linear_in(src, self.fc_seg, dt).float()
        return out


class RNNAnticipator(_Heads):
    """reference model/rnn.py: embed -> BiLSTM -> fc -> pool(8) -> heads."""

    def __init__(self, cfg: ModelConfig, n_class: int):
        super().__init__(cfg, n_class)
        C = cfg.hidden_dim
        self.embed = InputEmbed(cfg, n_class)
        self.rnn = LSTMStack(C, C)
        self.rnn_fc = nn.Linear(C, C)

    def forward(self, features, src_pad_mask: Optional[torch.Tensor] = None):
        src = self.embed(features)
        whole, lengths = _whole(src, src_pad_mask)
        tgt = linear_in(self.rnn(whole, lengths), self.rnn_fc, compute_dtype(self.cfg))
        out = self.heads(_pool8(tgt, lengths), src)
        out["supcon"] = cut_seq(tgt, seq_axis())
        return out


class CNNAnticipator(_Heads):
    """reference model/cnn.py: embed -> pool(8) -> heads."""

    def __init__(self, cfg: ModelConfig, n_class: int):
        super().__init__(cfg, n_class)
        self.embed = InputEmbed(cfg, n_class)

    def forward(self, features, src_pad_mask: Optional[torch.Tensor] = None):
        src = self.embed(features)
        out = self.heads(_pool8(*_whole(src, src_pad_mask)), src)
        out["supcon"] = src
        return out


class WNCausalConv(nn.Module):
    """Weight-normalised causal dilated 1-D conv (tcn.py:17-19: conv,
    symmetric pad and chomp == a left pad only): the kernel is ``v * g /
    max(||v||, 1e-12)`` with the norm over (in, k) of each output channel,
    computed on every call; ``v`` [out, in, k], ``g`` [out], ``bias``
    [out] (JAX's ``v`` is [k, in, out])."""

    def __init__(self, in_features: int, features: int, kernel_size: int, dilation: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilation = dilation
        self.dtype = dtype
        self.v = nn.Parameter(torch.zeros(features, in_features, kernel_size))
        self.g = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):   # [B, C, T]
        norm = self.v.flatten(1).norm(dim=1).clamp_min(1e-12)
        w = (self.v * (self.g / norm)[:, None, None]).to(self.dtype)
        pad = (self.v.shape[-1] - 1) * self.dilation
        return F.conv1d(F.pad(x.to(self.dtype), (pad, 0)), w, self.bias.to(self.dtype),
                        dilation=self.dilation)


class LecunConv1d(nn.Conv1d):
    """A 1x1 conv whose weight draws flax's default Conv init (lecun
    normal): the TCN's ``regression``."""


class TCNAnticipator(nn.Module):
    """reference model/tcn.py MustafaNet1DTCN: 4-level dilated TCN -> 1x1
    regression -> [B, anticipated_frames, n_class]."""

    def __init__(self, cfg: ModelConfig, n_class: int,
                 channels: Tuple[int, ...] = (256, 512, 512, 256), kernel_size: int = 3,
                 anticipated_frames: int = 8):
        super().__init__()
        self.cfg = cfg
        self.n_class = n_class
        self.anticipated_frames = anticipated_frames
        dt = compute_dtype(cfg)
        c_in = cfg.input_dim
        for i, ch in enumerate(channels):
            setattr(self, f"block{i}_conv1", WNCausalConv(c_in, ch, kernel_size, 2 ** i, dt))
            setattr(self, f"block{i}_conv2", WNCausalConv(ch, ch, kernel_size, 2 ** i, dt))
            if c_in != ch:
                setattr(self, f"block{i}_down", nn.Conv1d(c_in, ch, 1))
            c_in = ch
        self.n_blocks = len(channels)
        self.drop = FixedDropout(TCN_DROPOUT)
        self.regression = LecunConv1d(c_in, n_class * anticipated_frames, 1)

    def forward(self, features, src_pad_mask: Optional[torch.Tensor] = None):
        dt = compute_dtype(self.cfg)
        features, lengths = _whole(features, src_pad_mask)
        x = features.to(dt).transpose(1, 2)   # [B, C, T]
        for i in range(self.n_blocks):
            conv1, conv2 = getattr(self, f"block{i}_conv1"), getattr(self, f"block{i}_conv2")
            y = self.drop(torch.relu(conv1(x)))
            y = self.drop(torch.relu(conv2(y)))
            down = getattr(self, f"block{i}_down", None)
            if down is not None:
                x = F.conv1d(x, down.weight.to(dt), down.bias.to(dt))
            x = torch.relu(y + x)
        r = self.regression
        logits = F.conv1d(x, r.weight.to(dt), r.bias.to(dt)).transpose(1, 2)
        B, T, _ = logits.shape
        logits = logits.reshape(B, T, self.anticipated_frames, self.n_class)
        if lengths is None:
            action = logits.mean(1)
        else:
            # the causal convs keep the real rows clean of the suffix padding;
            # only the mean needs the true length
            valid = (torch.arange(T, device=logits.device)[None, :]
                     < lengths[:, None]).to(logits.dtype)[..., None, None]
            action = (logits * valid).sum(1) / lengths.clamp_min(1).to(logits.dtype)[:, None, None]
        return {"action": action.float()}
