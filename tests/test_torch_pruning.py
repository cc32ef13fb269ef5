"""Port parity: pruning ranges (fast_rnnt_tpu_torch.ops.pruning and the plain
side of ops/kernels/ranges.py) vs the JAX package's XLA formulation and its
Pallas ranges kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.ops import pruning as jpr
from fast_rnnt_tpu.ops import recursion as jrec
from fast_rnnt_tpu.ops.kernels.ranges import window_argmax_rows_pallas
from fast_rnnt_tpu_torch.ops import pruning as tpr
from fast_rnnt_tpu_torch.ops.kernels import ranges

from ._torch_parity import assert_ranges_match, jj, rows_inputs, to_np, tt


def _occupancies(seed, modified, S=6, T=14, B=3):
    """Occupancies of a random lattice, from the JAX XLA core (the same
    numpy arrays then go to both sides)."""
    px, py, bnd = rows_inputs(seed, B=B, S=S, T=T, modified=modified)
    bnd[:, 2] = np.maximum(bnd[:, 2], 2)
    bnd[:, 3] = np.maximum(bnd[:, 3], bnd[:, 2] + 1)
    _, (gx, gy) = jax.jit(
        lambda a, b, c: jrec.mutual_information_rows(a, b, c, calc_gradients=True, impl="xla")
    )(*jj(px, py, bnd))
    return np.asarray(gx), np.asarray(gy), bnd


@pytest.mark.parametrize("s_range", [2, 3, 100])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_prune_ranges_rows_match_xla(modified, s_range):
    gx, gy, bnd = _occupancies(1, modified)
    got = tpr.get_rnnt_prune_ranges_rows(*tt(gx, gy, bnd), s_range)
    want = np.asarray(jpr.get_rnnt_prune_ranges_rows(*jj(gx, gy, bnd), s_range, impl="xla"))
    assert got.shape == want.shape and got.dtype == torch.int32
    K = want.shape[2]
    assert_ranges_match(
        to_np(got)[:, :, 0], want[:, :, 0], to_np(tpr._window_scores(*tt(gx, gy), K)), "ranges"
    )
    np.testing.assert_array_equal(
        to_np(got) - to_np(got)[:, :, :1], np.broadcast_to(np.arange(K), got.shape)
    )


@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_window_starts_match_pallas_interpret(modified):
    """The plain version of the ranges kernel vs the Pallas kernel (window
    argmax + fused padding and repair) in interpret mode."""
    gx, gy, bnd = _occupancies(2, modified, S=7, T=12)
    K = 3
    step = 2 if modified else K
    got = ranges.window_starts(*tt(gy, gx), K, tt(bnd), step)
    want = window_argmax_rows_pallas(
        *jj(gy, gx), K, interpret=True, boundary=jj(bnd), adjust_step=step
    )
    assert_ranges_match(got, np.asarray(want), to_np(tpr._window_scores(*tt(gx, gy), K)), "starts")


@pytest.mark.parametrize("K", [1, 2, 4])
def test_window_argmax_first_max_matches_jax(K):
    """Exact ties pin first-max tie breaking (as jnp.argmax)."""
    rng = np.random.default_rng(K)
    S, B, T = 6, 2, 9
    gx = (np.round(rng.random((S, B, T + 1)) * 4) / 4).astype(np.float32)
    gy = (np.round(rng.random((S + 1, B, T)) * 4) / 4).astype(np.float32)
    got = tpr._window_argmax(*tt(gx, gy), K)
    want = jpr._window_argmax(*jj(gx, gy), K, impl="xla")
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_adjust_pruning_lower_bound_matches_jax():
    s = np.random.default_rng(3).integers(0, 12, size=(4, 30)).astype(np.int32)
    for step in (2, 4):
        got = tpr.adjust_pruning_lower_bound(torch.from_numpy(s), step)
        want = jax.jit(jpr.adjust_pruning_lower_bound, static_argnums=1)(jnp.asarray(s), step)
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_prune_ranges_bmajor_wrapper():
    gx, gy, bnd = _occupancies(4, False)
    a = tpr.get_rnnt_prune_ranges(*tt(gx.transpose(1, 0, 2), gy.transpose(1, 0, 2), bnd), 3)
    b = tpr.get_rnnt_prune_ranges_rows(*tt(gx, gy, bnd), 3)
    np.testing.assert_array_equal(to_np(a), to_np(b))


def test_prune_ranges_guards():
    gx, gy, bnd = _occupancies(5, False)
    with pytest.raises(ValueError):
        tpr.get_rnnt_prune_ranges_rows(*tt(gx, gy, bnd), 1)  # regular needs >= 2
    with pytest.raises(TypeError):
        tpr.get_rnnt_prune_ranges_rows(*tt(gx, gy, bnd), 2.0)
    gxm, gym, bndm = _occupancies(5, True)
    assert tpr.get_rnnt_prune_ranges_rows(*tt(gxm, gym, bndm), 1).shape[2] == 1
