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

``TransducerConfig(recipe="icefall")`` builds instead the conformer of
icefall's ``pruned_transducer_stateless`` recipe (k2-fsa/icefall,
egs/librispeech/ASR; arXiv:2206.13236), with the same block order:

  * the front end: two unpadded 3x3 stride-2 convs of d_model channels,
    each with ReLU, the channel-major flatten, a Dense to d_model, then
    x * sqrt(d_model); T = ((T_in - 1) // 2 - 1) // 2;
  * :class:`RelPositionMultiHeadAttention`: Transformer-XL relative
    positions in ESPnet's form (learned biases u and v, the position
    scores shifted), the softmax in float32;
  * the conv module's norm is BatchNorm1d (batch statistics over every
    B x T position); every LayerNorm is torch's (eps 1e-5) and hands on
    float32, as autocast's rule has it, so the residual stream stays
    float32 and each Dense casts its input to the compute dtype;
  * after the blocks a LayerNorm and a float32 Dense to the vocabulary: am;
    the predictor is icefall's stateless decoder (blank-row embedding, one
    zero frame of left context, a depthwise context conv without bias,
    ReLU, a float32 Dense to the vocabulary): lm; the joiner is a float32
    Dense(V, V) over tanh(am_pruned + lm_pruned).  am and lm are both the
    simple loss's and the joiner's inputs.

Its modules are their own classes (``Icefall*``), chosen once where the
model is built; the flax recipe's modules are the JAX package's.

The model's parts open spans in the profiler's timeline
(``frt.model.subsampling``, ``.attention``, ``.conv_module``,
``.feed_forward``, ``.predictor``, ``.joiner``), one flag test each
without a profiler.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.relpos_attention import relpos_attention
from ..utils.profiling import annotate

__all__ = ["TransducerConfig", "Encoder", "Predictor", "Joiner", "PrunedTransducer",
           "RelPositionMultiHeadAttention", "IcefallEncoder", "IcefallPredictor"]

RECIPES = ("flax", "icefall")


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
    # the modules' recipe: "flax", the JAX package's model; "icefall", the
    # conformer of icefall's pruned_transducer_stateless (module docstring)
    recipe: str = "flax"

    def __post_init__(self):
        if self.recipe not in RECIPES:
            raise ValueError(f"recipe must be one of {RECIPES}, got {self.recipe!r}")
        if self.recipe == "icefall" and (self.causal or self.attention_left_context is not None):
            raise ValueError("the icefall recipe is offline: causal=False, attention_left_context=None")

    @property
    def icefall(self) -> bool:
        return self.recipe == "icefall"


def _same_pads(length: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one axis: ceil(length / stride) outputs,
    the total pad split with its odd unit on the high side."""
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Conv1d/Conv2d applied with its input, weight and bias in ``dtype``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return conv._conv_forward(x.to(dtype), conv.weight.to(dtype), bias)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (flax ``Dense(dtype=...)``);
    ``dtype=None`` computes in the promoted dtype of input and weight."""

    def __init__(self, d_in: int, d_out: int, dtype: Optional[torch.dtype] = None,
                 bias: bool = True):
        super().__init__(d_in, d_out, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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


class TorchLayerNorm(nn.LayerNorm):
    """torch's LayerNorm (eps 1e-5) over the float32 input, output float32:
    icefall's ``nn.LayerNorm`` as autocast runs it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def _layer_norm(cfg: "TransducerConfig", d: int) -> nn.Module:
    return TorchLayerNorm(d) if cfg.icefall else LayerNorm(d, cfg.dtype)


class FeedForward(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        d = cfg.d_model
        self.ln = _layer_norm(cfg, d)
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


def rel_positions(T: int, d: int, device=None) -> torch.Tensor:
    """(2T-1, d) float32 sinusoidal encodings of the relative positions
    T-1, T-2, ..., -(T-1) (ESPnet's ``RelPositionalEncoding``): row r is
    position T-1-r, sin in the even and cos in the odd columns."""
    pos = torch.arange(T - 1, -T, -1, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * -(math.log(10000.0) / d))
    pe = torch.empty(2 * T - 1, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class RelPositionMultiHeadAttention(nn.Module):
    """icefall's ``RelPositionMultiheadAttention``, Transformer-XL relative
    positions (Dai et al., arXiv:1901.02860, section 3.3) in ESPnet's form:
    q, k, v from one in-projection, p = pe W_pos (no bias), and
    score[b, h, i, j] = ((q_i + u_h) k_j + (q_i + v_h) p_{T-1-i+j}) / sqrt(hd);
    padded keys masked, the softmax over keys in float32, then v and the
    out-projection.  Products in ``dtype``.  The (B, H, T, T) part is
    :func:`~fast_rnnt_tpu_torch.ops.kernels.relpos_attention.relpos_attention`:
    on the card a kernel pair that keeps the scores out of device memory."""

    def __init__(self, d: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = Dense(d, 3 * d, dtype)
        self.linear_pos = Dense(d, d, dtype, bias=False)
        self.out_proj = Dense(d, d, dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, d // num_heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, d // num_heads))

    def forward(self, x: torch.Tensor, pos: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """``x`` (B, T, d); ``pos`` (2T-1, d) :func:`rel_positions`;
        ``key_mask`` bool (B, T), True on an utterance's frames."""
        B, T, d = x.shape
        H = self.num_heads
        hd = d // H
        q, k, v = self.in_proj(x).view(B, T, 3, H, hd).unbind(2)  # each (B, T, H, hd)
        # zero positions after the 2T-1, to L a multiple of 8: bd_raw's rows
        # start on 16 bytes, which the product's fast kernels need
        pos = F.pad(pos, (0, 0, 0, -(2 * T - 1) % 8))
        p = self.linear_pos(pos).view(-1, H, hd).permute(1, 2, 0)  # (H, hd, L)
        dt = q.dtype
        qu = q + self.pos_bias_u.to(dt)  # (B, T, H, hd)
        # a head's (B T, hd) rows against its positions, one product a head:
        # bd_raw (B, H, T, L) stored (H, B, T, L), no operand copied
        qv = (q + self.pos_bias_v.to(dt)).permute(2, 0, 1, 3).reshape(H, B * T, hd)
        bd_raw = torch.bmm(qv, p).view(H, B, T, -1).transpose(0, 1)
        o = relpos_attention(qu, k, v, bd_raw, key_mask)  # (B, T, H, hd)
        return self.out_proj(o.reshape(B, T, d))


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


def _residuals(blk: nn.Module, x: torch.Tensor, pad_mask: torch.Tensor, attend) -> torch.Tensor:
    """A conformer block's residual chain (half-step feed-forward, attention
    over ``attend(ln_attn(x))``, conv module, half-step feed-forward, final
    norm), each part in its span."""
    with annotate("frt.model.feed_forward"):
        h = blk.ff1(x)
    x = torch.add(x, h, alpha=0.5)
    y = blk.ln_attn(x)
    with annotate("frt.model.attention"):
        h = attend(y)
    x = x + h
    with annotate("frt.model.conv_module"):
        h = blk.conv(x, pad_mask)
    x = x + h
    with annotate("frt.model.feed_forward"):
        h = blk.ff2(x)
    x = torch.add(x, h, alpha=0.5)
    return blk.ln_out(x)


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
        return _residuals(self, x, pad_mask, lambda y: self.attn(y, y, attn_mask))

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
        with annotate("frt.model.subsampling"):
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
    """Pruned joiner over (B, T, s_range, d_in) pairs: logits (B, T,
    s_range, vocab_size) float32, the Dense computed in ``dtype`` (None: in
    float32, as the icefall recipe's)."""

    def __init__(self, d_in: int, vocab_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out = Dense(d_in, vocab_size, dtype)

    def forward(self, am_pruned: torch.Tensor, lm_pruned: torch.Tensor) -> torch.Tensor:
        return self.out(torch.tanh(am_pruned + lm_pruned)).float()


class IcefallConvModule(nn.Module):
    """icefall's conformer convolution module: pointwise-GLU, padded frames
    zeroed (the port's rule), depthwise conv centred by its own padding (an
    odd kernel), BatchNorm1d (``norm``) in float32 over every B x T
    position, swish, pointwise."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln_in = TorchLayerNorm(d)
        self.pw_in = Dense(d, 2 * d, cfg.dtype)
        self.dw = nn.Conv1d(d, d, cfg.conv_kernel, groups=d, padding=(cfg.conv_kernel - 1) // 2)
        self.norm = nn.BatchNorm1d(d)
        self.pw_out = Dense(d, d, cfg.dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        g = F.glu(self.pw_in(self.ln_in(x)), dim=-1)
        g = torch.where(pad_mask[:, :, None], g, 0.0).transpose(1, 2)
        g = _conv(self.dw, g, self.cfg.dtype)  # (B, d, T)
        return self.pw_out(F.silu(self.norm(g.float())).transpose(1, 2))


class IcefallConformerBlock(nn.Module):
    """icefall's conformer block: :func:`_residuals` over torch's
    LayerNorms, :class:`RelPositionMultiHeadAttention` and
    :class:`IcefallConvModule`."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.ff1 = FeedForward(cfg)
        self.ln_attn = TorchLayerNorm(cfg.d_model)
        self.attn = RelPositionMultiHeadAttention(cfg.d_model, cfg.num_heads, cfg.dtype)
        self.conv = IcefallConvModule(cfg)
        self.ff2 = FeedForward(cfg)
        self.ln_out = TorchLayerNorm(cfg.d_model)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """``pos``: the (2T-1, d) relative positions (:func:`rel_positions`)."""
        return _residuals(self, x, pad_mask, lambda y: self.attn(y, pos, pad_mask))


class IcefallEncoder(nn.Module):
    """icefall's ``Conv2dSubsampling`` (two unpadded 3x3 stride-2 convs of
    d_model channels, each with ReLU, the channel-major flatten, a Dense
    to d_model), the xscale of ESPnet's ``RelPositionalEncoding``, the
    blocks and ``after_norm``: (B, T_in, feature_dim) -> (B, ((T_in - 1)
    // 2 - 1) // 2, d_model) float32, padded frames as computed."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.sub1 = nn.Conv2d(1, d, 3, stride=2)
        self.sub2 = nn.Conv2d(d, d, 3, stride=2)
        f4 = ((cfg.feature_dim - 1) // 2 - 1) // 2  # two unpadded stride-2 3x3 convs
        self.proj = Dense(f4 * d, d, cfg.dtype)
        self.blocks = nn.ModuleList(IcefallConformerBlock(cfg) for _ in range(cfg.num_layers))
        self.after_norm = TorchLayerNorm(d)

    def forward(self, features: torch.Tensor, feature_lens: torch.Tensor):
        dt = self.cfg.dtype
        x = features.to(dt)[:, None]  # (B, 1, T_in, F)
        with annotate("frt.model.subsampling"):
            x = F.relu(_conv(self.sub2, F.relu(_conv(self.sub1, x, dt)), dt))
            B, C2, T, F4 = x.shape
            # channel-major, frequency-minor: (B, T, C2 * F4)
            x = self.proj(x.transpose(1, 2).reshape(B, T, C2 * F4)).float() * math.sqrt(self.cfg.d_model)
        out_lens = ((feature_lens - 1) // 2 - 1) // 2
        pad_mask = torch.arange(T, device=x.device)[None, :] < out_lens[:, None]
        pos = rel_positions(T, self.cfg.d_model, x.device)
        for blk in self.blocks:
            x = blk(x, pad_mask, pos)
        return self.after_norm(x), out_lens


class IcefallPredictor(nn.Module):
    """icefall's stateless ``Decoder``: (B, S) symbols -> (B, S+1,
    vocab_size) float32, lm; the symbols with one blank before them,
    embedded (the blank's row 0 and without gradient, ``padding_idx``),
    k-1 zero frames of left context, a depthwise conv of width k without
    bias, ReLU and a float32 Dense to the vocabulary."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        self.k = max(cfg.predictor_context, 1)
        d = cfg.d_model
        self.embed = nn.Embedding(cfg.vocab_size, d, padding_idx=cfg.blank_id)
        self.conv = nn.Conv1d(d, d, self.k, groups=d, bias=False)
        self.out = Dense(d, cfg.vocab_size)

    def forward(self, symbols: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        blank = self.cfg.blank_id
        y = F.pad(symbols.long(), (1, 0), value=blank)  # (B, S+1)
        x = F.embedding(y, self.embed.weight.to(dt), padding_idx=blank).transpose(1, 2)
        x = F.pad(x, (self.k - 1, 0))  # (B, d, S+k)
        x = F.relu(_conv(self.conv, x, dt)).transpose(1, 2)  # (B, S+1, d)
        return self.out(x)  # float32: Dense promotes to its weight's dtype


class PrunedTransducer(nn.Module):
    """The full model, two-stage (the pruning ranges sit between them):

      stage 1 ``forward``: (features, feature_lens, symbols) ->
              (am, lm, simple_am, simple_lm, out_lens)
        am        (B, T, d_joiner)   joiner-space encoder projection
        lm        (B, S+1, d_joiner) joiner-space predictor projection
        simple_am (B, T, C)          vocab-space projection, simple loss
        simple_lm (B, S+1, C)
      stage 2 ``join``: pruned pairs -> logits (B, T, s_range, C).

    The icefall recipe has no projections: its encoder's float32 Dense to
    the vocabulary (``encoder_out``) gives am (B, T, C) and its predictor lm
    (B, S+1, C), returned as both pairs.
    """

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.icefall:
            self.encoder = IcefallEncoder(cfg)
            self.predictor = IcefallPredictor(cfg)
            self.encoder_out = Dense(cfg.d_model, cfg.vocab_size)
            self.joiner = Joiner(cfg.vocab_size, cfg.vocab_size)
            return
        self.encoder = Encoder(cfg)
        self.predictor = Predictor(cfg)
        self.am_proj = Dense(cfg.d_model, cfg.d_joiner)
        self.lm_proj = Dense(cfg.d_model, cfg.d_joiner)
        self.simple_am_proj = Dense(cfg.d_model, cfg.vocab_size)
        self.simple_lm_proj = Dense(cfg.d_model, cfg.vocab_size)
        self.joiner = Joiner(cfg.d_joiner, cfg.vocab_size, cfg.dtype)

    def forward(self, features, feature_lens, symbols):
        enc, out_lens = self.encoder(features, feature_lens)
        with annotate("frt.model.predictor"):
            pred = self.predictor(symbols)
        if self.cfg.icefall:
            am = self.encoder_out(enc)
            return am, pred, am, pred, out_lens
        return (
            self.am_proj(enc),
            self.lm_proj(pred),
            self.simple_am_proj(enc),
            self.simple_lm_proj(pred),
            out_lens,
        )

    def join(self, am_pruned: torch.Tensor, lm_pruned: torch.Tensor) -> torch.Tensor:
        with annotate("frt.model.joiner"):
            return self.joiner(am_pruned, lm_pruned)

    def encode_stream(self, chunk: torch.Tensor, enc_state: dict) -> Tuple[torch.Tensor, dict]:
        """Streaming stage 1 for one chunk: (am rows, new encoder state)."""
        enc, new_state = self.encoder.step(chunk, enc_state)
        return self.am_proj(enc), new_state
