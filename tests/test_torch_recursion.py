"""Port parity: the s-major recursion (fast_rnnt_tpu_torch.ops.recursion and
the plain side of ops/kernels/wavefront.py) vs the JAX package's XLA core,
its Pallas kernels in interpret mode, the loop oracle and the golden
path-enumeration vectors."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.ops import recursion as jrec
from fast_rnnt_tpu.ops.kernels.wavefront import backward_rows_pallas, forward_rows_pallas
from fast_rnnt_tpu_torch.ops import recursion as trec
from fast_rnnt_tpu_torch.ops.kernels import wavefront

from ._torch_parity import (
    assert_lattice_close,
    assert_loss_close,
    band,
    jj,
    rows_inputs,
    to_np,
    tt,
)
from .oracle import mi_loop

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.npz")))


def _case(seed, modified, banded, offset, B=3, S=5, T=11):
    px, py, bnd = rows_inputs(seed, B=B, S=S, T=T, modified=modified, offset=offset)
    K = 3 if banded else 0
    lo = band(seed + 1, B, S, T, K) if banded else None
    return px, py, bnd, lo, K


@pytest.mark.parametrize("offset", [False, True], ids=["begin0", "offset"])
@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_rows_forward_backward_match_xla(modified, banded, offset):
    px, py, bnd, lo, K = _case(11, modified, banded, offset)
    ag = np.random.default_rng(0).random(px.shape[1]).astype(np.float32) + 0.5
    p_t, sc_t = wavefront.forward_rows(*tt(px, py, bnd), tt(lo) if banded else None, K)
    p_j, sc_j = jrec._forward_rows_xla(*jj(px, py, bnd), lo=jj(lo), K=K)
    assert_loss_close(sc_t, sc_j, "scores")
    assert_lattice_close(p_t, p_j, "p")
    gx_t, gy_t = wavefront.backward_rows(
        *tt(px, py), p_t, tt(bnd), torch.from_numpy(ag), tt(lo) if banded else None, K
    )
    gx_j, gy_j = jrec._backward_rows_xla(*jj(px, py), p_j, jj(bnd), jj(ag), lo=jj(lo), K=K)
    assert_lattice_close(gx_t, gx_j, "px_grad")
    assert_lattice_close(gy_t, gy_j, "py_grad")


@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_rows_match_pallas_interpret(modified, banded):
    """Against the Pallas kernels themselves, run in interpret mode."""
    px, py, bnd, lo, K = _case(21, modified, banded, offset=True)
    p_t, sc_t = wavefront.forward_rows(*tt(px, py, bnd), tt(lo) if banded else None, K)
    p_j, sc_j = forward_rows_pallas(*jj(px, py, bnd), lo=jj(lo), K=K, interpret=True)
    T = py.shape[2]
    assert_loss_close(sc_t, sc_j, "scores")
    assert_lattice_close(p_t, np.asarray(p_j)[:, :, : T + 1], "p")
    ones = np.ones(px.shape[1], np.float32)
    gx_t, gy_t = wavefront.backward_rows(
        *tt(px, py), p_t, tt(bnd), torch.from_numpy(ones), tt(lo) if banded else None, K
    )
    gx_j, gy_j = backward_rows_pallas(
        *jj(px, py), p_j, jj(bnd), jj(ones), lo=jj(lo), K=K, interpret=True
    )
    assert_lattice_close(gx_t, gx_j, "px_grad")
    assert_lattice_close(gy_t, gy_j, "py_grad")


@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_mutual_information_rows_matches_oracle(modified):
    px, py, bnd = rows_inputs(5, B=3, S=4, T=9, modified=modified, offset=True, neg_inf_frac=0.1)
    scores, (gx, gy) = trec.mutual_information_rows(*tt(px, py, bnd), calc_gradients=True)
    ref_s, ref_gx, ref_gy, _ = mi_loop(px.transpose(1, 0, 2), py.transpose(1, 0, 2), bnd)
    np.testing.assert_allclose(to_np(scores), ref_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(gx).transpose(1, 0, 2), ref_gx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(gy).transpose(1, 0, 2), ref_gy, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_mutual_information_rows_matches_golden(path):
    g = np.load(path)
    px = g["px"].astype(np.float32).transpose(1, 0, 2)
    py = g["py"].astype(np.float32).transpose(1, 0, 2)
    lo, K = (tt(g["lo"]), int(g["K"])) if "lo" in g.files else (None, 0)
    scores, (gx, gy) = trec.mutual_information_rows(
        *tt(px, py, g["boundary"]), lo=lo, s_range=K, calc_gradients=True
    )
    np.testing.assert_allclose(to_np(scores), g["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(gx).transpose(1, 0, 2), g["px_grad"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(gy).transpose(1, 0, 2), g["py_grad"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("calc_gradients", [False, True], ids=["scores_op", "grads_op"])
@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
def test_rows_gradient_matches_jax(banded, calc_gradients):
    """d(w . scores)/d(px, py) of both autograd ops vs jax.grad."""
    px, py, bnd, lo, K = _case(31, False, banded, offset=False)
    w = np.random.default_rng(1).random(px.shape[1]).astype(np.float32)

    def jf(px_, py_):
        out = jrec.mutual_information_rows(
            px_, py_, jj(bnd), lo=jj(lo), s_range=K, calc_gradients=calc_gradients, impl="xla"
        )
        s = out[0] if calc_gradients else out
        return jnp.sum(s * jj(w))

    jgx, jgy = jax.grad(jf, argnums=(0, 1))(*jj(px, py))
    tpx = torch.from_numpy(px).requires_grad_()
    tpy = torch.from_numpy(py).requires_grad_()
    out = trec.mutual_information_rows(
        tpx, tpy, tt(bnd), lo=tt(lo) if banded else None, s_range=K,
        calc_gradients=calc_gradients,
    )
    s = out[0] if calc_gradients else out
    (s * torch.from_numpy(w)).sum().backward()
    assert_lattice_close(tpx.grad, jgx, "d px")
    assert_lattice_close(tpy.grad, jgy, "d py")


def test_scores_only_path_matches_lattice_path():
    px, py, bnd, lo, K = _case(41, True, True, offset=True)
    a = trec.mutual_information_rows(*tt(px, py, bnd), lo=tt(lo), s_range=K)
    b, _ = trec.mutual_information_rows(*tt(px, py, bnd), lo=tt(lo), s_range=K, calc_gradients=True)
    assert_loss_close(a, b)


def test_empty_transcripts_match_xla():
    px, py, bnd = rows_inputs(3, B=2, S=0, T=6)
    p_t, sc_t = wavefront.forward_rows(*tt(px, py, bnd))
    p_j, sc_j = jrec._forward_rows_xla(*jj(px, py, bnd))
    assert_loss_close(sc_t, sc_j)
    assert_lattice_close(p_t, p_j)
    gx, gy = wavefront.backward_rows(*tt(px, py), p_t, tt(bnd), torch.ones(2))
    assert gx.shape == (0, 2, 7)
    assert_lattice_close(gy, jrec._backward_rows_xla(*jj(px, py), p_j, jj(bnd), jnp.ones(2))[1])


def test_normalize_boundary_clamps_like_jax():
    bnd = np.array([[0, 0, 9, 40], [-2, 3, 4, 2], [5, 1, 3, 7], [0, 0, 0, 0]], np.int32)
    got = trec._normalize_boundary(torch.from_numpy(bnd), 4, 6, 20)
    want = jrec._normalize_boundary(jnp.asarray(bnd), 4, 6, 20)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        to_np(trec._normalize_boundary(None, 2, 6, 20)),
        np.asarray(jrec._normalize_boundary(None, 2, 6, 20)),
    )


def test_cummin_and_monotonic_lower_bound_match_jax():
    x = np.random.default_rng(2).integers(-5, 9, size=(3, 25)).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(trec.cummin(torch.from_numpy(x))), np.asarray(jax.jit(jrec.cummin)(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(
        to_np(trec.monotonic_lower_bound(torch.from_numpy(x))),
        np.asarray(jax.jit(jrec.monotonic_lower_bound)(jnp.asarray(x))),
    )


def test_float64_and_bf16_on_cpu_run_the_plain_path():
    px, py, bnd = rows_inputs(7, B=2, S=4, T=8)
    ref_s = mi_loop(px.transpose(1, 0, 2), py.transpose(1, 0, 2), bnd)[0]
    s64 = trec.mutual_information_rows(
        torch.from_numpy(px).double(), torch.from_numpy(py).double(), tt(bnd)
    )
    assert s64.dtype == torch.float64
    np.testing.assert_allclose(to_np(s64), ref_s, rtol=1e-10)
    s16 = trec.mutual_information_rows(
        torch.from_numpy(px).bfloat16(), torch.from_numpy(py).bfloat16(), tt(bnd)
    )
    assert s16.dtype == torch.float32  # bf16 is storage; the recursion is f32
    np.testing.assert_allclose(to_np(s16), ref_s, rtol=2e-2)
