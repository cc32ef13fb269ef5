"""Pruned-transducer model family (PyTorch port of
``fast_rnnt_tpu/models/transducer.py``): conformer encoder, stateless
predictor and pruned joiner, the offline forward of both encoder variants
(``causal=False`` and ``causal=True`` with ``attention_left_context``).

The modules compute what the flax modules compute, so that weights carried
across by :func:`fast_rnnt_tpu_torch.utils.params_from_flax` give the same
outputs:

  * params are float32; every layer with ``dtype=cfg.dtype`` in the JAX
    package casts its input, kernel and bias to the compute dtype
    (:class:`Dense`, :func:`_conv`, the embedding), and the four
    projections of :class:`PrunedTransducer` run in float32;
  * :class:`LayerNorm` is flax's: epsilon 1e-6, statistics in float32 as
    E[x^2] - E[x]^2, the output cast to the compute dtype;
  * the stride-2 subsampling convs pad as XLA's ``SAME`` does, all of an
    odd total on the high side (:func:`_same_pads`), on the time and the
    frequency axis; their NCHW output is flattened frequency-major,
    channel-minor, as the NHWC reshape is;
  * attention is flax ``MultiHeadDotProductAttention``: the query divided
    by sqrt(head_dim) in the compute dtype, masked logits set to the
    dtype's finfo.min, the softmax in the compute dtype.

Streaming (``causal=True`` with a bounded ``attention_left_context``):
:class:`ConvModule`, :class:`ConformerBlock` and :class:`Encoder` pair
their offline ``forward`` with a ``step`` over the same parameters, which
takes one chunk and the carried per-layer state (the subsampling convs'
input tails, each block's attention window and depthwise-conv tail) and
gives the offline rows of the same frames; models/streaming.py drives it.
The port keeps the subsampling tails NCHW, ``(B, C, 2, F)``, where the
JAX package keeps them NHWC.

The dense products and convolutions are plain PyTorch ops: the JAX package
computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TransducerConfig", "Encoder", "Predictor", "Joiner", "PrunedTransducer"]


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    vocab_size: int = 500
    feature_dim: int = 80
    d_model: int = 256
    d_joiner: int = 512
    num_layers: int = 6
    num_heads: int = 4
    ff_mult: int = 4
    conv_kernel: int = 15
    predictor_context: int = 2
    blank_id: int = 0
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay float32
    # causal convolutions and attention restricted to
    # [q - attention_left_context, q] encoder frames (None: all of kk <= q)
    causal: bool = False
    attention_left_context: Optional[int] = None


def _same_pads(length: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one axis: ceil(length / stride) outputs,
    the total pad split with its odd unit on the high side."""
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Conv1d/Conv2d applied with its input, weight and bias in ``dtype``."""
    return conv._conv_forward(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype))


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (flax ``Dense(dtype=...)``);
    ``dtype=None`` computes in the promoted dtype of input and weight."""

    def __init__(self, d_in: int, d_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__(d_in, d_out)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: epsilon 1e-6, float32 statistics (fast variance,
    clipped at 0), output in ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class FeedForward(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        d = cfg.d_model
        self.ln = LayerNorm(d, cfg.dtype)
        self.fc1 = Dense(d, d * cfg.ff_mult, cfg.dtype)
        self.fc2 = Dense(d * cfg.ff_mult, d, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(self.ln(x))))


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with qkv and out features
    d_model: q/k/v projections to (heads, head_dim), the scaled product,
    the masked softmax and the output projection, all in ``dtype``."""

    def __init__(self, d: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(d, d, dtype)
        self.key = Dense(d, d, dtype)
        self.value = Dense(d, d, dtype)
        self.out = Dense(d, d, dtype)

    def forward(self, xq: torch.Tensor, xkv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``mask``: bool, broadcastable to (B, heads, Tq, Tk), True where
        a query may attend a key."""
        B, Tq, d = xq.shape
        H = self.num_heads
        hd = d // H

        def heads(x):
            return x.view(B, x.shape[1], H, hd).transpose(1, 2)  # (B, H, T, hd)

        q, k, v = heads(self.query(xq)), heads(self.key(xkv)), heads(self.value(xkv))
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
        w = torch.matmul(q, k.transpose(-1, -2))
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        o = torch.matmul(w, v).transpose(1, 2).reshape(B, Tq, d)
        return self.out(o)


class ConvModule(nn.Module):
    """Conformer convolution module: pointwise-GLU -> depthwise -> pointwise.
    Offline the depthwise conv is centred (``SAME``); causal, it sees the
    k-1 frames to the left only."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln_in = LayerNorm(d, cfg.dtype)
        self.pw_in = Dense(d, 2 * d, cfg.dtype)
        self.dw = nn.Conv1d(d, d, cfg.conv_kernel, groups=d)
        self.ln_out = LayerNorm(d, cfg.dtype)
        self.pw_out = Dense(d, d, cfg.dtype)

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        return F.glu(self.pw_in(self.ln_in(x)), dim=-1)

    def _post(self, g: torch.Tensor, pads: Tuple[int, int]) -> torch.Tensor:
        """The depthwise conv of (B, T, d) ``g`` padded by ``pads`` on the
        time axis, then the output half."""
        g = _conv(self.dw, F.pad(g.transpose(1, 2), pads), self.cfg.dtype).transpose(1, 2)
        return self.pw_out(F.silu(self.ln_out(g)))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        k = self.cfg.conv_kernel
        # zero padded frames so the depthwise conv cannot leak across padding
        g = torch.where(pad_mask[:, :, None], self._pre(x), 0.0)
        pads = (k - 1, 0) if self.cfg.causal else _same_pads(g.shape[1], k, 1)
        return self._post(g, pads)

    def step(self, x_new: torch.Tensor, tail: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One streaming chunk: ``tail`` is the (B, k-1, d) post-GLU rows of
        the previous k-1 frames (zeros at stream start, the offline causal
        zero pad).  Returns (out, new tail)."""
        gw = torch.cat([tail, self._pre(x_new)], dim=1)
        return self._post(gw, (0, 0)), gw[:, x_new.shape[1]:]


class ConformerBlock(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        self.ff1 = FeedForward(cfg)
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = MultiHeadAttention(cfg.d_model, cfg.num_heads, cfg.dtype)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(cfg)
        self.ln_out = LayerNorm(cfg.d_model, cfg.dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        attn_mask = pad_mask[:, None, None, :]  # (B, 1, 1, T) keys mask
        if self.cfg.attention_left_context is not None or self.cfg.causal:
            # query q attends keys in [q - L, q]; causal always means zero
            # right context
            T = x.shape[1]
            q = torch.arange(T, device=x.device)[:, None]
            kk = torch.arange(T, device=x.device)[None, :]
            win = kk <= q
            if self.cfg.attention_left_context is not None:
                win = win & (kk >= q - self.cfg.attention_left_context)
            attn_mask = attn_mask & win[None, None]
        x = x + 0.5 * self.ff1(x)
        y = self.ln_attn(x)
        x = x + self.attn(y, y, attn_mask)
        x = x + self.conv(x, pad_mask)
        x = x + 0.5 * self.ff2(x)
        return self.ln_out(x)

    def step(self, x_new: torch.Tensor, att_cache: torch.Tensor, conv_tail: torch.Tensor,
             seen: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One streaming chunk over the same parameters as ``forward``.

        Args:
          x_new: (B, n, d) the chunk's n new encoder frames.
          att_cache: (B, L, d) the previous L attention inputs (post
            ``ln_attn``), the key/value window; L = attention_left_context.
          conv_tail: (B, k-1, d) the conv module's post-GLU tail.
          seen: int, (B,) or () tensor: encoder frames each stream has
            consumed; slots may sit at different positions.

        Returns (out (B, n, d), new att_cache, new conv_tail).
        """
        L = self.cfg.attention_left_context
        n = x_new.shape[1]
        dev = x_new.device
        x = x_new + 0.5 * self.ff1(x_new)
        y = self.ln_attn(x)
        window = torch.cat([att_cache, y], dim=1)  # (B, L+n, d)
        # cache slot i holds absolute frame seen - L + i and query j is frame
        # seen + j: the window [q - L, q] is i in [j, j + L], and a slot is
        # live (absolute frame >= 0) where i >= L - min(seen, L)
        j = torch.arange(n, device=dev)[:, None]
        i = torch.arange(L + n, device=dev)[None, :]
        lo = (L - torch.as_tensor(seen, device=dev).clamp(max=L)).reshape(-1, 1, 1)
        mask = ((i >= j) & (i <= j + L))[None] & (i[None] >= lo)  # (B or 1, n, L+n)
        x = x + self.attn(y, window, mask[:, None])
        c_out, new_tail = self.conv.step(x, conv_tail)
        x = x + c_out
        x = x + 0.5 * self.ff2(x)
        return self.ln_out(x), window[:, n:], new_tail


class Encoder(nn.Module):
    """Conv subsampling (stride 4) + conformer stack: (B, T_in, feature_dim)
    -> (B, ceil(T_in / 4), d_model) float32, padded frames zeroed."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        c2 = cfg.d_model // 4
        self.sub1 = nn.Conv2d(1, c2, 3, stride=2)
        self.sub2 = nn.Conv2d(c2, c2, 3, stride=2)
        f4 = ((cfg.feature_dim + 1) // 2 + 1) // 2  # ceil(ceil(F / 2) / 2)
        self.proj = Dense(f4 * c2, cfg.d_model, cfg.dtype)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.num_layers))

    def _subsample(self, conv: nn.Module, x: torch.Tensor, time_pad: int = 2) -> torch.Tensor:
        """One stride-2 3x3 conv + relu over NCHW (B, C, T, F).  Causal, the
        frequency axis pads (1, 1) and the time axis ``time_pad`` zero
        frames on the left, so each output frame depends on past input
        frames only: 2 offline, 0 when streaming, where the carried tail
        of 2 real frames stands ahead of ``x``."""
        if self.cfg.causal:
            pads = (1, 1, time_pad, 0)
        else:
            pads = (*_same_pads(x.shape[3], 3, 2), *_same_pads(x.shape[2], 3, 2))
        return F.relu(_conv(conv, F.pad(x, pads), self.cfg.dtype))

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """The NHWC flatten of (B, C2, T, F4), frequency-major and
        channel-minor, then ``proj``: (B, T, d_model)."""
        B, C2, T, F4 = x.shape
        return self.proj(x.permute(0, 2, 3, 1).reshape(B, T, F4 * C2))

    def forward(self, features: torch.Tensor, feature_lens: torch.Tensor):
        x = features.to(self.cfg.dtype)[:, None]  # (B, 1, T_in, F)
        x = self._project(self._subsample(self.sub2, self._subsample(self.sub1, x)))
        T = x.shape[1]
        # SAME-padded stride-2 convs give ceil(L/2) frames each
        out_lens = (feature_lens + 3) // 4
        pad_mask = torch.arange(T, device=x.device)[None, :] < out_lens[:, None]
        for blk in self.blocks:
            x = blk(x, pad_mask)
        x = torch.where(pad_mask[:, :, None], x, 0.0)
        return x.float(), out_lens

    def step(self, chunk: torch.Tensor, state: dict) -> Tuple[torch.Tensor, dict]:
        """Encode one chunk of (B, C_in, F) input frames (C_in % 4 == 0)
        with carried state: ((B, C_in // 4, d_model) float32, new state).
        The rows are the offline ``forward`` rows of the same absolute
        frames; the state is :func:`models.streaming.encoder_stream_state`'s
        layout."""
        cfg = self.cfg
        if not cfg.causal or cfg.attention_left_context is None:
            raise ValueError("Encoder.step needs causal=True and a bounded attention_left_context")
        xin = chunk.to(cfg.dtype)[:, None]  # (B, 1, C_in, F)
        mid = self._subsample(self.sub1, torch.cat([state["in_tail"], xin], dim=2), time_pad=0)
        x = self._project(self._subsample(self.sub2, torch.cat([state["mid_tail"], mid], dim=2),
                                          time_pad=0))
        seen = state["seen"]
        att, conv = [], []
        for blk, a, c in zip(self.blocks, state["att"], state["conv"]):
            x, a, c = blk.step(x, a, c, seen)
            att.append(a)
            conv.append(c)
        new_state = {
            "in_tail": xin[:, :, -2:],
            "mid_tail": mid[:, :, -2:],
            "att": att,
            "conv": conv,
            "seen": seen + x.shape[1],
        }
        return x.float(), new_state


class Predictor(nn.Module):
    """Stateless predictor: embedding + left-context conv over the symbols.
    (B, S) symbols -> (B, S+1, d_model) float32; row 0 is the context
    before any symbol."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        self.k = max(cfg.predictor_context, 1)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.conv = nn.Conv1d(cfg.d_model, cfg.d_model, self.k)
        self.ln = LayerNorm(cfg.d_model, cfg.dtype)

    def forward(self, symbols: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        B = symbols.shape[0]
        # prepend k blanks (an infinite-blank history), as greedy decoding's
        # blank-initialised context buffer has it
        blanks = torch.full((B, self.k), self.cfg.blank_id, dtype=symbols.dtype,
                            device=symbols.device)
        y = torch.cat([blanks, symbols], dim=1).long()  # (B, S+k)
        x = F.embedding(y, self.embed.weight.to(dt)).transpose(1, 2)  # (B, d, S+k)
        x = F.relu(_conv(self.conv, x, dt)).transpose(1, 2)  # (B, S+1, d)
        return self.ln(x).float()


class Joiner(nn.Module):
    """Pruned joiner over (B, T, s_range, d_joiner) pairs."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        self.out = Dense(cfg.d_joiner, cfg.vocab_size, cfg.dtype)

    def forward(self, am_pruned: torch.Tensor, lm_pruned: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(am_pruned + lm_pruned).to(self.cfg.dtype)
        return self.out(x).float()


class PrunedTransducer(nn.Module):
    """The full model, two-stage (the pruning ranges sit between them):

      stage 1 ``forward``: (features, feature_lens, symbols) ->
              (am, lm, simple_am, simple_lm, out_lens)
        am        (B, T, d_joiner)   joiner-space encoder projection
        lm        (B, S+1, d_joiner) joiner-space predictor projection
        simple_am (B, T, C)          vocab-space projection, simple loss
        simple_lm (B, S+1, C)
      stage 2 ``join``: pruned pairs -> logits (B, T, s_range, C).
    """

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.predictor = Predictor(cfg)
        self.am_proj = Dense(cfg.d_model, cfg.d_joiner)
        self.lm_proj = Dense(cfg.d_model, cfg.d_joiner)
        self.simple_am_proj = Dense(cfg.d_model, cfg.vocab_size)
        self.simple_lm_proj = Dense(cfg.d_model, cfg.vocab_size)
        self.joiner = Joiner(cfg)

    def forward(self, features, feature_lens, symbols):
        enc, out_lens = self.encoder(features, feature_lens)
        pred = self.predictor(symbols)
        return (
            self.am_proj(enc),
            self.lm_proj(pred),
            self.simple_am_proj(enc),
            self.simple_lm_proj(pred),
            out_lens,
        )

    def join(self, am_pruned: torch.Tensor, lm_pruned: torch.Tensor) -> torch.Tensor:
        return self.joiner(am_pruned, lm_pruned)

    def encode_stream(self, chunk: torch.Tensor, enc_state: dict) -> Tuple[torch.Tensor, dict]:
        """Streaming stage 1 for one chunk: (am rows, new encoder state)."""
        enc, new_state = self.encoder.step(chunk, enc_state)
        return self.am_proj(enc), new_state
