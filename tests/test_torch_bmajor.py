"""Port parity: the (B, S, T)-major API of the port, the public recursion
and the lattice builders of a real joiner's logits, vs the JAX package on
the same numpy inputs (XLA path on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_rnnt_tpu as jft
import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu.ops import lattice as jlat
from fast_rnnt_tpu.ops import recursion as jrec
from fast_rnnt_tpu_torch.ops import lattice as tlat
from fast_rnnt_tpu_torch.ops import recursion as trec
from fast_rnnt_tpu_torch.ops.kernels import wavefront

from ._torch_parity import (
    assert_close,
    assert_lattice_close,
    assert_loss_close,
    jj,
    loss_inputs,
    rows_inputs,
    storage_rtol,
    to_np,
    tt,
)

RNNT_TYPES = ["regular", "modified", "constrained"]


def _bmajor(seed, modified, B=3, S=5, T=11, offset=True):
    px, py, bnd = rows_inputs(seed, B=B, S=S, T=T, modified=modified, offset=offset)
    return px.transpose(1, 0, 2).copy(), py.transpose(1, 0, 2).copy(), bnd


@pytest.mark.parametrize("calc_gradients", [False, True], ids=["scores", "grads"])
@pytest.mark.parametrize("given", [False, True], ids=["bnd_none", "bnd_given"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_mutual_information_recursion_matches_jax(modified, given, calc_gradients):
    """Scores, occupancies and the autograd gradient of w . scores."""
    px, py, bnd = _bmajor(1, modified)
    bnd = bnd if given else None
    w = np.random.default_rng(2).random(px.shape[0]).astype(np.float32)

    def jf(px_, py_):
        out = jrec.mutual_information_recursion(
            px_, py_, jj(bnd), calc_gradients=calc_gradients, impl="xla"
        )
        s = out[0] if calc_gradients else out
        return jnp.sum(s * jj(w)), out

    (_, out_j), (jgx, jgy) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(*jj(px, py))
    tpx = torch.from_numpy(px).requires_grad_()
    tpy = torch.from_numpy(py).requires_grad_()
    out_t = ft.mutual_information_recursion(tpx, tpy, tt(bnd), calc_gradients=calc_gradients)
    s_t = out_t[0] if calc_gradients else out_t
    (s_t * torch.from_numpy(w)).sum().backward()
    assert_loss_close(s_t, out_j[0] if calc_gradients else out_j, "scores")
    if calc_gradients:
        assert out_t[1][0].shape == px.shape and out_t[1][1].shape == py.shape
        assert_lattice_close(out_t[1][0], out_j[1][0], "px_grad")
        assert_lattice_close(out_t[1][1], out_j[1][1], "py_grad")
    assert_lattice_close(tpx.grad, jgx, "d px")
    assert_lattice_close(tpy.grad, jgy, "d py")


def test_mutual_information_recursion_bf16_storage_matches_jax():
    """bf16 storage: float32 scores, bf16 occupancies, on both sides."""
    px, py, bnd = _bmajor(3, False)
    s_j, (gx_j, gy_j) = jrec.mutual_information_recursion(
        jnp.asarray(px).astype(jnp.bfloat16), jnp.asarray(py).astype(jnp.bfloat16),
        jj(bnd), calc_gradients=True, impl="xla",
    )
    s_t, (gx_t, gy_t) = ft.mutual_information_recursion(
        torch.from_numpy(px).bfloat16(), torch.from_numpy(py).bfloat16(), tt(bnd),
        calc_gradients=True,
    )
    assert s_t.dtype == torch.float32 and s_j.dtype == jnp.float32
    assert gx_t.dtype == torch.bfloat16 and gx_j.dtype == jnp.bfloat16
    assert_loss_close(s_t, s_j, "scores")
    rtol = storage_rtol(torch.bfloat16)
    assert_close(gx_t, np.asarray(gx_j, np.float32), 1e-5, rtol, "px_grad")
    assert_close(gy_t, np.asarray(gy_j, np.float32), 1e-5, rtol, "py_grad")


def test_boundary_none_equals_explicit_full_boundary():
    px, py, _ = _bmajor(4, True)
    B, S, T = py.shape[0], py.shape[1] - 1, py.shape[2]
    full = np.tile(np.array([[0, 0, S, T]], np.int32), (B, 1))
    a, (ga, _) = ft.mutual_information_recursion(*tt(px, py), None, calc_gradients=True)
    b, (gb, _) = ft.mutual_information_recursion(*tt(px, py, full), calc_gradients=True)
    assert torch.equal(a, b) and torch.equal(ga, gb)


def test_mutual_information_recursion_shape_errors():
    px, py, bnd = tt(*_bmajor(5, False))
    with pytest.raises(ValueError, match="py shape"):
        ft.mutual_information_recursion(px, py[:, :-1], bnd)
    with pytest.raises(ValueError, match="px last dim"):
        ft.mutual_information_recursion(px[:, :, :-3], py, bnd)
    with pytest.raises(ValueError, match="boundary shape"):
        ft.mutual_information_recursion(px, py, bnd[:2])


def test_debug_self_check_passes_and_raises(monkeypatch):
    px, py, bnd = tt(*_bmajor(6, False))
    s1 = ft.mutual_information_recursion(px, py, bnd, debug_self_check=True)
    s2, _ = ft.mutual_information_recursion(px, py, bnd, calc_gradients=True, debug_self_check=True)
    assert torch.equal(s1, s2)
    real = wavefront.fused_rows

    def corrupted(*a):
        scores, gx, gy = real(*a)
        return scores, 0.5 * gx, gy

    monkeypatch.setattr(wavefront, "fused_rows", corrupted)
    with pytest.raises(FloatingPointError, match="round-trip"):
        ft.mutual_information_recursion(px, py, bnd, debug_self_check=True)


def test_debug_self_check_bf16_and_degenerate_boundaries():
    """bf16 storage gets the loose bound (no spurious raise); a zero-length
    utterance's origin is its seed cell and scores 0."""
    px, py, _ = _bmajor(7, False, B=2, S=3, T=4)
    bnd = np.array([[1, 2, 1, 2], [0, 0, 3, 4]], np.int32)
    s, (gx, _) = ft.mutual_information_recursion(
        torch.from_numpy(px).bfloat16(), torch.from_numpy(py).bfloat16(), tt(bnd),
        calc_gradients=True, debug_self_check=True,
    )
    assert gx.dtype == torch.bfloat16 and float(s[0]) == 0.0
    assert torch.isfinite(s).all()


def test_occupancy_roundtrip_check_matches_jax():
    px, py, bnd = _bmajor(8, True, B=4)
    bnd[3] = [2, 3, 2, 3]  # origin == seed cell
    _, (gx, gy) = jrec.mutual_information_recursion(*jj(px, py, bnd), calc_gradients=True, impl="xla")
    ag = np.random.default_rng(0).random(4).astype(np.float32) + 0.5
    want = jrec.occupancy_roundtrip_check(gx * 1.5, gy, jj(bnd), jj(ag))
    got = trec.occupancy_roundtrip_check(
        torch.from_numpy(np.array(gx) * 1.5), torch.from_numpy(np.array(gy)), tt(bnd),
        torch.from_numpy(ag),
    )
    assert_lattice_close(got, want, "round-trip error")


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_get_rnnt_logprobs_matches_jax(rnnt_type):
    am, lm, sym, bnd = loss_inputs(9)
    px_t, py_t = ft.get_rnnt_logprobs(*tt(lm, am, sym), 0, rnnt_type, tt(bnd))
    px_j, py_j = jft.get_rnnt_logprobs(*jj(lm, am, sym), 0, rnnt_type, jj(bnd))
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_get_rnnt_logprobs_smoothed_matches_jax(rnnt_type):
    am, lm, sym, bnd = loss_inputs(10)
    px_t, py_t = ft.get_rnnt_logprobs_smoothed(*tt(lm, am, sym), 0, 0.2, 0.1, tt(bnd), rnnt_type)
    px_j, py_j = jft.get_rnnt_logprobs_smoothed(*jj(lm, am, sym), 0, 0.2, 0.1, jj(bnd), rnnt_type)
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


def _joint_logits(seed, B=3, T=9, S=4, C=10):
    am, lm, sym, bnd = loss_inputs(seed, B=B, T=T, S=S, C=C)
    logits = (np.tanh(am[:, :, None, :] + lm[:, None, :, :]) * 3.0).astype(np.float32)
    return logits, sym, bnd


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_get_rnnt_logprobs_joint_matches_jax(rnnt_type):
    logits, sym, bnd = _joint_logits(11)
    sym[0, 1], sym[1, 0] = -1, 99  # out-of-range symbols read 0, as the one-hot does
    px_t, py_t = ft.get_rnnt_logprobs_joint(*tt(logits, sym), 0, tt(bnd), rnnt_type)
    px_j, py_j = jft.get_rnnt_logprobs_joint(*jj(logits, sym), 0, jj(bnd), rnnt_type)
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


def _ranges(seed, B, T, S, K):
    """Monotone windows [B, T, K] with starts in [0, S + 1 - K]."""
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.integers(0, S + 2 - K, size=(B, T)), axis=1)
    return (lo[:, :, None] + np.arange(K)).astype(np.int32)


def test_scatter_window_and_roll_by_shifts_match_jax():
    rng = np.random.default_rng(12)
    win = rng.normal(size=(2, 7, 3)).astype(np.float32)
    shifts = rng.integers(0, 6, size=(2, 7)).astype(np.int32)
    assert_lattice_close(
        tlat.scatter_window(*tt(win, shifts), 8), jlat.scatter_window(*jj(win, shifts), 8), "scatter"
    )
    assert_lattice_close(
        tlat.scatter_window(*tt(win, shifts), 8, 0.0), jlat.scatter_window(*jj(win, shifts), 8, 0.0),
        "scatter fill 0",
    )
    src = rng.normal(size=(2, 7, 6)).astype(np.float32)
    shifts = rng.integers(-8, 9, size=(2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(ft.roll_by_shifts(*tt(src, shifts))), np.asarray(jft.roll_by_shifts(*jj(src, shifts)))
    )


def test_do_rnnt_pruning_matches_jax():
    am, lm, _, _ = loss_inputs(13, B=2, T=6, S=4, C=5)
    ranges = _ranges(13, 2, 6, 4, 3)
    ranges[1, 2, 2] = 9  # out of range: a row of zeros, as the one-hot product gives
    am_t, lm_t = ft.do_rnnt_pruning(*tt(am, lm, ranges))
    am_j, lm_j = jft.do_rnnt_pruning(*jj(am, lm, ranges))
    np.testing.assert_array_equal(to_np(am_t), np.asarray(am_j))
    np.testing.assert_array_equal(to_np(lm_t), np.asarray(lm_j))


def test_band_mask_rows_matches_jax():
    px, py, _ = _bmajor(14, False, B=2, S=5, T=8)
    ranges = _ranges(14, 2, 8, 5, 3)
    for x in (px, py):
        assert_lattice_close(
            tlat.band_mask_rows(*tt(x, ranges)), jlat.band_mask_rows(*jj(x, ranges)), "band mask"
        )


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_get_rnnt_logprobs_pruned_matches_jax(rnnt_type):
    am, lm, sym, bnd = loss_inputs(15, B=3, T=10, S=6, C=11)
    sym[2, 3] = 40  # an out-of-range symbol reads 0
    ranges = _ranges(15, 3, 10, 6, 3)
    logits = np.tanh(am[:, :, None, :] + lm[np.arange(3)[:, None, None], ranges]) * 2.0
    px_t, py_t = ft.get_rnnt_logprobs_pruned(*tt(logits, sym, ranges), 0, tt(bnd), rnnt_type)
    px_j, py_j = jft.get_rnnt_logprobs_pruned(*jj(logits, sym, ranges), 0, jj(bnd), rnnt_type)
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_get_rnnt_logprobs_pruned_simple_matches_jax(rnnt_type):
    am, lm, sym, bnd = loss_inputs(16, B=3, T=10, S=6, C=11)
    ranges = _ranges(16, 3, 10, 6, 3)
    px_t, py_t = ft.get_rnnt_logprobs_pruned_simple(*tt(lm, am, sym, ranges), 0, tt(bnd), rnnt_type)
    px_j, py_j = jft.get_rnnt_logprobs_pruned_simple(*jj(lm, am, sym, ranges), 0, jj(bnd), rnnt_type)
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")
    # and equal to the materialized pruned lattice of the additive joiner
    am_p, lm_p = ft.do_rnnt_pruning(*tt(am, lm, ranges))
    px_m, py_m = ft.get_rnnt_logprobs_pruned(am_p + lm_p, *tt(sym, ranges), 0, tt(bnd), rnnt_type)
    assert_lattice_close(px_t, px_m, "px vs materialized")
    assert_lattice_close(py_t, py_m, "py vs materialized")
