"""Batched transducer decoding (PyTorch port of
``fast_rnnt_tpu/models/decoding.py``): greedy search and modified beam
search, with the JAX package's decisions, in its order.

  * Greedy search is one loop whose every trip is one predictor + joiner
    evaluation per stream; a stream advances its frame pointer on blank,
    on the emission cap or past its end, and emits otherwise.  The JAX
    ``lax.while_loop`` becomes a Python loop bounded by
    ``T_blk * (max_symbols_per_frame + 1)`` trips (no frame takes more);
    its stop test is read on the host every ``_STOP_CHECK_EVERY`` trips
    only, since a read waits for the device.  A trip after every stream
    has finished changes nothing, so the extra trips are idle work, not a
    different result.
  * Beam search is one step per frame; the top-H of the H*C candidates
    come from a stable descending sort, so equal scores resolve to the
    lower flat index as ``lax.top_k`` resolves them (the all--inf slots of
    a fresh beam tie on every early frame).
  * The stateless predictor means the decode state is a rolling (B, k)
    symbol buffer; finished utterances keep emitting blanks into masked
    lanes, and results are length-tracked.

The decoders run under ``torch.no_grad`` on the device of their inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .transducer import PrunedTransducer, TransducerConfig

__all__ = [
    "greedy_search",
    "greedy_over_frames",
    "modified_beam_search",
    "beam_over_frames",
    "beam_init_state",
    "beam_best",
]

# greedy trips between two host reads of "has every stream finished"
_STOP_CHECK_EVERY = 8


def _encode(model: PrunedTransducer, features, feature_lens):
    """Encoder + am projection only (the decode-time acoustic path)."""
    enc, out_lens = model.encoder(features, feature_lens)
    return model.am_proj(enc), out_lens


def _predictor_last(model: PrunedTransducer, ctx: torch.Tensor) -> torch.Tensor:
    """lm projection row for the current (B, k) symbol context: the
    predictor's last position."""
    return model.lm_proj(model.predictor(ctx))[:, -1, :]


def _frame_active(out_lens: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=out_lens.device)[None, :] < out_lens[:, None]


@torch.no_grad()
def greedy_over_frames(
    model: PrunedTransducer,
    am: torch.Tensor,
    frame_active: torch.Tensor,
    ctx: torch.Tensor,
    hyps: torch.Tensor,
    lens: torch.Tensor,
    max_symbols_per_frame: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy-decode a block of encoder frames, resuming from carried state.

    Args:
      am: (B, T_blk, d_joiner) joiner-space encoder rows for this block.
      frame_active: (B, T_blk) bool: frames past an utterance's end emit
        nothing.
      ctx: (B, k) rolling predictor symbol context.
      hyps / lens: (B, max_len) int32 output buffer and (B,) counts.

    Returns the updated (ctx, hyps, lens); the inputs are not modified.
    """
    cfg: TransducerConfig = model.cfg
    blank = cfg.blank_id
    B, T_blk, _ = am.shape
    max_len = hyps.shape[1]
    dev = am.device
    bidx = torch.arange(B, device=dev)
    pos = torch.arange(max_len, device=dev)[None, :]
    t_ptr = torch.zeros(B, dtype=torch.int32, device=dev)
    emit_cnt = torch.zeros_like(t_ptr)
    for trip in range(T_blk * (max_symbols_per_frame + 1)):
        if trip % _STOP_CHECK_EVERY == 0 and not bool((t_ptr < T_blk).any()):
            break
        t_safe = t_ptr.clamp(max=T_blk - 1).long()
        am_t = am[bidx, t_safe]  # (B, d)
        frame_ok = frame_active[bidx, t_safe]
        in_block = t_ptr < T_blk

        lm_rows = _predictor_last(model, ctx)
        logits = model.join(am_t[:, None, None, :], lm_rows[:, None, None, :])[:, 0, 0, :]
        sym = logits.argmax(dim=-1).to(torch.int32)  # the first maximum
        take = (
            in_block
            & frame_ok
            & (sym != blank)
            & (lens < max_len)
            & (emit_cnt < max_symbols_per_frame)
        )
        hyps = torch.where((pos == lens[:, None]) & take[:, None], sym[:, None], hyps)
        lens = lens + take.to(lens.dtype)
        ctx = torch.where(take[:, None], torch.cat([ctx[:, 1:], sym[:, None]], dim=1), ctx)
        advance = in_block & ~take
        t_ptr = t_ptr + advance.to(torch.int32)
        emit_cnt = torch.where(advance, 0, emit_cnt + take.to(torch.int32))
    return ctx, hyps, lens


@torch.no_grad()
def greedy_search(
    model: PrunedTransducer,
    features: torch.Tensor,
    feature_lens: torch.Tensor,
    max_symbols_per_frame: int = 4,
    max_len: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy (max-prob) transducer decoding.

    Args:
      features: (B, T_in, feature_dim) float.
      feature_lens: (B,) int frame counts before subsampling.
      max_symbols_per_frame: emission cap per frame.
      max_len: output buffer length.

    Returns (hyps, hyp_lens): int32 (B, max_len) padded with blank, and
    (B,) counts, on the features' device.
    """
    cfg: TransducerConfig = model.cfg
    k = max(cfg.predictor_context, 1)
    am, out_lens = _encode(model, features, feature_lens)
    B, T, _ = am.shape
    dev = am.device
    ctx0 = torch.full((B, k), cfg.blank_id, dtype=torch.int32, device=dev)
    hyps0 = torch.full((B, max_len), cfg.blank_id, dtype=torch.int32, device=dev)
    lens0 = torch.zeros(B, dtype=torch.int32, device=dev)
    _, hyps, lens = greedy_over_frames(
        model, am, _frame_active(out_lens, T), ctx0, hyps0, lens0,
        max_symbols_per_frame=max_symbols_per_frame,
    )
    return hyps, lens


@torch.no_grad()
def beam_over_frames(
    model: PrunedTransducer,
    am: torch.Tensor,
    frame_active: torch.Tensor,
    scores: torch.Tensor,
    ctx: torch.Tensor,
    hyps: torch.Tensor,
    lens: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam-search a block of encoder frames, resuming from carried beam
    state (scores, ctx, hyps, lens): (B, H), (B, H, k), (B, H, L), (B, H).
    Returns the updated state."""
    cfg: TransducerConfig = model.cfg
    blank = cfg.blank_id
    k = ctx.shape[2]
    B, H = scores.shape
    C = cfg.vocab_size
    max_len = hyps.shape[2]
    dev = am.device
    vocab = torch.arange(C, device=dev)
    blank_only = torch.where(vocab == blank, 0.0, float("-inf"))  # frozen frames
    pos = torch.arange(max_len, device=dev)
    hi = torch.arange(H, device=dev)
    earlier = hi[None, :, None] < hi[None, None, :]
    for t in range(am.shape[1]):
        am_t, active = am[:, t], frame_active[:, t]
        lm_rows = _predictor_last(model, ctx.reshape(B * H, k)).reshape(B, H, -1)
        logits = model.join(am_t[:, None, None, :], lm_rows[:, :, None, :])[:, :, 0, :]
        logp = F.log_softmax(logits, dim=-1)  # (B, H, C)

        # candidate scores; frozen (inactive) frames only allow blank, and
        # hypotheses that can no longer grow only blank
        cand = scores[:, :, None] + torch.where(active[:, None, None], logp, blank_only)
        full = (lens >= max_len)[:, :, None]
        cand = torch.where(full & (vocab != blank), float("-inf"), cand)
        top_scores, flat_idx = torch.sort(cand.reshape(B, H * C), dim=1, descending=True,
                                          stable=True)
        top_scores, flat_idx = top_scores[:, :H], flat_idx[:, :H]
        parent = flat_idx // C  # (B, H)
        sym = (flat_idx % C).to(torch.int32)

        new_ctx = ctx.gather(1, parent[:, :, None].expand(B, H, k))
        new_hyps = hyps.gather(1, parent[:, :, None].expand(B, H, max_len))
        new_lens = lens.gather(1, parent)

        emit = sym != blank
        new_hyps = torch.where((pos == new_lens[:, :, None]) & emit[:, :, None],
                               sym[:, :, None], new_hyps)
        new_lens = new_lens + emit.to(new_lens.dtype)
        new_ctx = torch.where(emit[:, :, None],
                              torch.cat([new_ctx[:, :, 1:], sym[:, :, None]], dim=2), new_ctx)

        # merge slots holding identical token sequences: the lowest slot of
        # each group takes the group's log-sum, the rest drop to -inf
        same = (new_lens[:, :, None] == new_lens[:, None, :]) & (
            new_hyps[:, :, None, :] == new_hyps[:, None, :, :]
        ).all(dim=3)  # (B, H, H), symmetric, diagonal True
        is_dup = (same & earlier).any(dim=1)
        merged = torch.logsumexp(
            torch.where(same, top_scores[:, None, :], float("-inf")), dim=2
        )
        scores = torch.where(is_dup, float("-inf"), merged)
        ctx, hyps, lens = new_ctx, new_hyps, new_lens
    return scores, ctx, hyps, lens


def beam_init_state(cfg: TransducerConfig, B: int, beam: int, max_len: int, device="cuda"):
    """Fresh beam state on ``device``: slot 0 live at score 0, the rest at
    -inf so the first frame fans out."""
    k = max(cfg.predictor_context, 1)
    scores = torch.full((B, beam), float("-inf"), device=device)
    scores[:, 0] = 0.0
    return (
        scores,
        torch.full((B, beam, k), cfg.blank_id, dtype=torch.int32, device=device),
        torch.full((B, beam, max_len), cfg.blank_id, dtype=torch.int32, device=device),
        torch.zeros((B, beam), dtype=torch.int32, device=device),
    )


def beam_best(scores, hyps, lens) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each utterance's best hypothesis (the first maximum score)."""
    best = scores.argmax(dim=1)
    bidx = torch.arange(scores.shape[0], device=scores.device)
    return hyps[bidx, best], lens[bidx, best]


@torch.no_grad()
def modified_beam_search(
    model: PrunedTransducer,
    features: torch.Tensor,
    feature_lens: torch.Tensor,
    beam: int = 4,
    max_len: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched modified beam search (at most one emission per frame, as
    k2/icefall's ``modified_beam_search``).  Per frame each of the H live
    hypotheses expands over the full vocab (blank = stay, symbol = append)
    and the top H of the H*C candidates survive.

    Returns (hyps, hyp_lens) of the best hypothesis per utterance: int32
    (B, max_len) padded with blank, and (B,) lengths.
    """
    am, out_lens = _encode(model, features, feature_lens)
    B, T, _ = am.shape
    state = beam_init_state(model.cfg, B, beam, max_len, device=am.device)
    scores, _, hyps, lens = beam_over_frames(
        model, am, _frame_active(out_lens, T), *state
    )
    return beam_best(scores, hyps, lens)
