"""Evaluation metrics (PyTorch port of ``fast_rnnt_tpu/models/metrics.py``):
batched token error rate (Levenshtein distance), exact integers.

One DP column of (S_ref + 1) entries per hypothesis position, vectorised
over the batch; the deletion chain inside a column is a running minimum
(``torch.cummin``), so the only loop is the Python loop over hypothesis
tokens, as the JAX ``lax.scan`` is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["edit_distance", "token_error_rate"]


def edit_distance(
    refs: torch.Tensor,
    ref_lens: torch.Tensor,
    hyps: torch.Tensor,
    hyp_lens: torch.Tensor,
) -> torch.Tensor:
    """Levenshtein distance per utterance (substitution, insertion and
    deletion cost 1).

    Args:
      refs: (B, S_ref) int token ids, padded arbitrarily past ``ref_lens``.
      ref_lens: (B,) int valid lengths.
      hyps: (B, S_hyp) int, padded arbitrarily past ``hyp_lens``.
      hyp_lens: (B,) int valid lengths.

    Returns (B,) int32 edit distances.  Lengths past the buffers are
    clamped to them, as the JAX package's indexing does.
    """
    B, S_ref = refs.shape
    S_hyp = hyps.shape[1]
    dev = refs.device
    refs = refs.to(torch.int32)
    hyps = hyps.to(torch.int32)

    # col[i] = min(prev[i] + 1, col[i-1] + 1, prev[i-1] + (ref[i-1] != hyp_j));
    # with m[i] = col[i] - i the col[i-1] term is a running min of m
    iota = torch.arange(S_ref + 1, dtype=torch.int32, device=dev)
    prev = iota.expand(B, S_ref + 1)
    rows = [prev]
    for j in range(S_hyp):
        sub = prev[:, :-1] + (refs != hyps[:, j : j + 1]).to(torch.int32)
        ins = prev[:, 1:] + 1
        nodel = torch.cat([prev[:, :1] + 1, torch.minimum(sub, ins)], dim=1)
        m = torch.cummin(nodel - iota, dim=1).values
        prev = torch.minimum(nodel, m + iota)
        rows.append(prev)
    rows = torch.stack(rows)  # (S_hyp + 1, B, S_ref + 1)
    h = hyp_lens.long().clamp(0, S_hyp)
    r = ref_lens.long().clamp(0, S_ref)
    return rows[h, torch.arange(B, device=dev), r]


def token_error_rate(
    refs: torch.Tensor,
    ref_lens: torch.Tensor,
    hyps: torch.Tensor,
    hyp_lens: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Corpus token error rate = total edits / total reference tokens.

    Returns (ter, {"edits": (B,), "ref_tokens": scalar})."""
    edits = edit_distance(refs, ref_lens, hyps, hyp_lens)
    total_ref = ref_lens.sum().clamp_min(1)
    return edits.sum() / total_ref, {"edits": edits, "ref_tokens": total_ref}
