"""Chunked streaming inference for the pruned transducer (PyTorch port of
``fast_rnnt_tpu/models/streaming.py``).

The encoder must be built streaming-capable,
``TransducerConfig(causal=True, attention_left_context=L)``.  Each
:func:`streaming_step` consumes one chunk of input frames per stream and
carries per-layer encoder state: the subsampling convs' input tails, each
conformer block's attention key/value window (its last L attention inputs)
and depthwise-conv tail (its last k-1 post-GLU frames).  The chunk's
encoder cost is O(chunk), with no recomputation of history.  The new
encoder frames then advance the carried decode state, greedy
(:func:`decoding.greedy_over_frames`) or modified beam search
(``StreamingConfig(beam=H)``, :func:`decoding.beam_over_frames`).

The zero-initialised tails are the offline causal zero pads and the
L-frame window with its warm-up mask is the offline [q - L, q] attention
mask, so streamed tokens equal offline tokens for any chunk size (held by
tests/test_torch_streaming.py against :func:`decoding.greedy_search` and
:func:`decoding.modified_beam_search`, and against the JAX package).

The state is a dict of tensors on the model's device, every leaf with a
leading per-stream axis; the step runs eagerly under ``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .decoding import beam_best, beam_init_state, beam_over_frames, greedy_over_frames
from .transducer import PrunedTransducer, TransducerConfig

__all__ = [
    "StreamingConfig",
    "encoder_stream_state",
    "streaming_init",
    "streaming_reset",
    "streaming_step",
]


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """chunk: input frames consumed per step (a multiple of 4, the
    subsampling factor).  ``left`` is accepted and ignored: the encoder
    carries exact per-layer history, so there is no rolling window (the
    JAX package keeps the field for its callers)."""

    chunk: int = 32
    left: int = 0
    max_symbols_per_frame: int = 4
    max_len: int = 256
    beam: int = 0  # 0: greedy; >= 2: streamed modified beam search

    def __post_init__(self):
        if self.chunk % 4:
            raise ValueError("chunk must be a multiple of 4")


def encoder_stream_state(cfg: TransducerConfig, batch_size: int, device) -> Dict:
    """Zero per-stream encoder state on ``device``.

    Zeros are exact: the offline causal encoder left-pads with zeros in the
    same places, and the attention windows start masked (``seen`` = 0).
    ``in_tail`` (B, 1, 2, F) and ``mid_tail`` (B, d/4, 2, ceil(F/2)) are
    NCHW; ``att`` and ``conv`` hold one (B, L, d) and one (B, k-1, d)
    tensor per layer.
    """
    B, d, dt = batch_size, cfg.d_model, cfg.dtype
    F2 = (cfg.feature_dim - 1) // 2 + 1  # frequency bins after the first conv

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "in_tail": zeros(B, 1, 2, cfg.feature_dim),
        "mid_tail": zeros(B, d // 4, 2, F2),
        "att": [zeros(B, cfg.attention_left_context, d) for _ in range(cfg.num_layers)],
        "conv": [zeros(B, cfg.conv_kernel - 1, d) for _ in range(cfg.num_layers)],
        # per stream, so that slots can be reset apart (models/serving.py)
        "seen": torch.zeros(B, dtype=torch.int32, device=device),
    }


def streaming_init(model: PrunedTransducer, scfg: StreamingConfig, batch_size: int) -> Dict:
    """Fresh state for ``batch_size`` parallel streams, on the model's
    device."""
    cfg: TransducerConfig = model.cfg
    if not cfg.causal:
        raise ValueError(
            "streaming needs a causal encoder: build the model with "
            "TransducerConfig(causal=True, attention_left_context=...)"
        )
    if cfg.attention_left_context is None:
        raise ValueError(
            "stateful streaming needs a bounded attention window: "
            "attention_left_context=None means unbounded causal attention, "
            "whose per-layer state cannot be carried in O(1) memory; set "
            "TransducerConfig(attention_left_context=L)"
        )
    dev = next(model.parameters()).device
    B = batch_size
    k = max(cfg.predictor_context, 1)
    state = {
        "enc": encoder_stream_state(cfg, B, dev),
        "stream_len": torch.zeros(B, dtype=torch.int32, device=dev),  # input frames seen
        "decoded_t": torch.zeros(B, dtype=torch.int32, device=dev),  # encoder frames decoded
    }
    if scfg.beam:
        scores, ctx, hyps, lens = beam_init_state(cfg, B, scfg.beam, scfg.max_len, device=dev)
        state.update(scores=scores, ctx=ctx, hyps=hyps, lens=lens)
    else:
        state.update(
            ctx=torch.full((B, k), cfg.blank_id, dtype=torch.int32, device=dev),
            hyps=torch.full((B, scfg.max_len), cfg.blank_id, dtype=torch.int32, device=dev),
            lens=torch.zeros(B, dtype=torch.int32, device=dev),
        )
    return state


def _select(mask: torch.Tensor, new, old):
    """``new`` where the (B,) ``mask`` is True and ``old`` elsewhere, leaf
    by leaf over a state tree of dicts and lists."""
    if isinstance(old, dict):
        return {key: _select(mask, new[key], old[key]) for key in old}
    if isinstance(old, list):
        return [_select(mask, a, b) for a, b in zip(new, old)]
    return torch.where(mask.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)


def streaming_reset(model: PrunedTransducer, scfg: StreamingConfig, state: Dict,
                    reset: torch.Tensor) -> Dict:
    """The streams where the (B,) bool ``reset`` is True set back to the
    fresh :func:`streaming_init` state; the other slots untouched.

    The continuous-batching primitive (models/serving.py): a finished slot
    is re-armed for a new stream while its neighbours keep decoding.  A
    reset slot's later decode is bit for bit a fresh batch's.
    """
    fresh = streaming_init(model, scfg, state["stream_len"].shape[0])
    return _select(reset.to(fresh["stream_len"].device), fresh, state)


@torch.no_grad()
def streaming_step(
    model: PrunedTransducer,
    scfg: StreamingConfig,
    state: Dict,
    chunk_feats: torch.Tensor,
    chunk_lens: torch.Tensor,
) -> Tuple[Dict, Tuple[torch.Tensor, torch.Tensor]]:
    """Consume one chunk of audio for every stream: (new state, the
    cumulative (hyps, lens)).

    Args:
      chunk_feats: (B, chunk, feature_dim) on the model's device; pad the
        final partial chunk with anything and pass the real count in
        ``chunk_lens``.
      chunk_lens: (B,) int32 in [0, chunk]: 0 for ended or stalled streams.
        A zero-length slot is frozen this step: its encoder state and
        counters pass through unchanged and its decode state is untouched
        (no active frames).  A partial chunk (0 < len < chunk) must be a
        stream's final chunk: the remaining positions are consumed as
        padding, which is exact only when no real frame follows.
    """
    n_new = scfg.chunk // 4

    am_new, enc = model.encode_stream(chunk_feats, state["enc"])
    fed = chunk_lens > 0
    enc = _select(fed, enc, state["enc"])

    # frame activity from each stream's total length (ends mid-chunk)
    stream_len = state["stream_len"] + chunk_lens.to(torch.int32)
    total_sub = (stream_len + 3) // 4  # the Encoder's out_lens
    t0 = state["decoded_t"]
    frames = t0[:, None] + torch.arange(n_new, device=t0.device)[None, :]
    frame_active = fed[:, None] & (frames < total_sub[:, None])

    new_state = {
        "enc": enc,
        "stream_len": stream_len,
        "decoded_t": t0 + fed.to(torch.int32) * n_new,
    }
    if scfg.beam:
        scores, ctx, hyps, lens = beam_over_frames(
            model, am_new, frame_active, state["scores"], state["ctx"], state["hyps"], state["lens"]
        )
        new_state.update(scores=scores, ctx=ctx, hyps=hyps, lens=lens)
        return new_state, beam_best(scores, hyps, lens)
    ctx, hyps, lens = greedy_over_frames(
        model, am_new, frame_active, state["ctx"], state["hyps"], state["lens"],
        max_symbols_per_frame=scfg.max_symbols_per_frame,
    )
    new_state.update(ctx=ctx, hyps=hyps, lens=lens)
    return new_state, (hyps, lens)
