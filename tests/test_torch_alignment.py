"""Parity of the port's Viterbi scoring and forced alignment
(fast_rnnt_tpu_torch.ops.alignment) with the JAX package's, on the CPU:
the same numpy lattices to both.  Scores within 1e-5 + 1e-5 |x| (the
lattice tolerance of tests/_torch_parity.py); the best path's emission
frames and its 0/1 px indicator equal (random inputs have no ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_rnnt_tpu as frt
import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu_torch.ops.alignment import _max_linear_scan

from ._torch_parity import LAT_ATOL, LAT_RTOL, assert_close, to_np, tt


def _lattice(seed, B=3, S=5, T=9, modified=False, ragged=True):
    """(px [B, S, T'], py [B, S+1, T], boundary or None) in numpy."""
    rng = np.random.default_rng(seed)
    T1 = T if modified else T + 1
    px = (rng.normal(size=(B, S, T1)) - 1.0).astype(np.float32)
    py = (rng.normal(size=(B, S + 1, T)) - 1.0).astype(np.float32)
    if not modified:
        px[:, :, T] = -np.inf
    if not ragged:
        return px, py, None
    se = rng.integers(S // 2, S + 1, size=B)
    te = np.maximum(rng.integers(T // 2, T + 1, size=B), se + 1)
    se[0], te[0] = S, T
    z = np.zeros(B, np.int32)
    return px, py, np.stack([z, z, se, te], axis=1).astype(np.int32)


CASES = [(m, r) for m in (False, True) for r in (False, True)]
IDS = [f"{'modified' if m else 'regular'}-{'ragged' if r else 'full'}" for m, r in CASES]


@pytest.mark.parametrize("modified,ragged", CASES, ids=IDS)
def test_viterbi_scores_match_jax(modified, ragged):
    px, py, bnd = _lattice(10 + 2 * modified + ragged, modified=modified, ragged=ragged)
    want = frt.viterbi_scores(jnp.asarray(px), jnp.asarray(py),
                              None if bnd is None else jnp.asarray(bnd))
    got = ft.viterbi_scores(*tt(px, py), None if bnd is None else tt(bnd))
    assert_close(got, np.asarray(want), LAT_ATOL, LAT_RTOL, "viterbi scores")


@pytest.mark.parametrize("modified,ragged", CASES, ids=IDS)
def test_viterbi_alignment_matches_jax(modified, ragged):
    px, py, bnd = _lattice(20 + 2 * modified + ragged, modified=modified, ragged=ragged)
    jb = None if bnd is None else jnp.asarray(bnd)
    w_scores, w_frames, w_ind = frt.viterbi_alignment(jnp.asarray(px), jnp.asarray(py), jb)
    scores, frames, ind = ft.viterbi_alignment(*tt(px, py), None if bnd is None else tt(bnd))
    assert_close(scores, np.asarray(w_scores), LAT_ATOL, LAT_RTOL, "scores")
    assert frames.dtype == torch.int32
    np.testing.assert_array_equal(to_np(frames), np.asarray(w_frames))
    np.testing.assert_array_equal(to_np(ind), np.asarray(w_ind))
    if bnd is not None:  # symbols past s_end are not emitted
        s_idx = np.arange(px.shape[1])[None, :]
        assert (to_np(frames)[s_idx >= bnd[:, 2:3]] == -1).all()


def test_max_linear_scan_matches_a_loop():
    rng = np.random.default_rng(3)
    coeff = torch.tensor(rng.normal(size=(2, 13)).astype(np.float32))
    bias = torch.tensor(rng.normal(size=(2, 13)).astype(np.float32))
    coeff[:, 0] = float("-inf")
    want = torch.empty_like(bias)
    x = torch.full((2,), float("-inf"))
    for t in range(13):
        x = torch.maximum(coeff[:, t] + x, bias[:, t])
        want[:, t] = x
    torch.testing.assert_close(_max_linear_scan(coeff, bias), want, atol=1e-6, rtol=0)
