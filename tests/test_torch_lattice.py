"""Port parity: the s-major lattice build (fast_rnnt_tpu_torch.ops.lattice
and the plain side of ops/kernels/latbuild.py) vs the JAX package's einsum
build and its Pallas build kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.ops import lattice as jlat
from fast_rnnt_tpu.ops.kernels.latbuild import lattice_rows_fused
from fast_rnnt_tpu_torch.ops import lattice as tlat
from fast_rnnt_tpu_torch.ops.kernels import latbuild

from ._torch_parity import (
    SPLIT_ATOL,
    SPLIT_RTOL,
    assert_close,
    assert_lattice_close,
    band,
    jj,
    loss_inputs,
    to_np,
    tt,
)

TYPES = ["regular", "modified", "constrained"]


@pytest.mark.parametrize("with_boundary", [False, True], ids=["nobnd", "bnd"])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_build_matches_xla(rnnt_type, with_boundary):
    am, lm, sym, bnd = loss_inputs(1, B=3, T=19, S=6, C=13)
    b = bnd if with_boundary else None
    px_t, py_t = tlat.get_rnnt_logprobs_rows(*tt(lm, am, sym), 0, rnnt_type, tt(b) if with_boundary else None)
    px_j, py_j = jlat.get_rnnt_logprobs_rows(*jj(lm, am, sym), 0, rnnt_type, jj(b), impl="xla")
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_build_out_of_range_symbols_match_xla(rnnt_type):
    """A symbol outside [0, C) reads 0 in the JAX package's one-hot gathers;
    the port's build (plain here, the kernel on the card) does the same and
    never indexes outside the row."""
    am, lm, sym, bnd = loss_inputs(10, B=3, T=12, S=5, C=9)
    sym[0, 0], sym[1, 2], sym[2, 4] = -1, 9, 40
    px_t, py_t = latbuild.lattice_rows(*tt(lm, am, sym), 0, rnnt_type, tt(bnd))
    px_j, py_j = jlat.get_rnnt_logprobs_rows(*jj(lm, am, sym), 0, rnnt_type, jj(bnd), impl="xla")
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_build_matches_pallas_interpret(rnnt_type):
    """Against the Pallas build kernel in interpret mode.  That kernel
    contracts the symbol gather and normalizer as 3-term bf16 splits
    (fast_rnnt_tpu/ops/kernels/latbuild.py:146), exact to ~2^-24 relative
    here, so the lattice tolerance holds."""
    am, lm, sym, bnd = loss_inputs(2, B=2, T=21, S=5, C=11)
    px_t, py_t = latbuild.lattice_rows(*tt(lm, am, sym), 0, rnnt_type, tt(bnd))
    px_j, py_j = lattice_rows_fused(*jj(lm, am, sym), 0, rnnt_type, jj(bnd), interpret=True)
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


def test_build_out_dtype_casts_last():
    am, lm, sym, bnd = loss_inputs(3, B=2, T=9, S=4, C=7)
    px_t, py_t = tlat.get_rnnt_logprobs_rows(*tt(lm, am, sym), 0, "constrained", out_dtype=torch.bfloat16)
    px_j, py_j = jlat.get_rnnt_logprobs_rows(
        *jj(lm, am, sym), 0, "constrained", out_dtype=jnp.bfloat16, impl="xla"
    )
    assert px_t.dtype == torch.bfloat16 and py_t.dtype == torch.bfloat16
    # one bf16 rounding of equal f32 values: equal up to a bf16 step
    np.testing.assert_allclose(to_np(px_t), np.asarray(px_j, np.float32), rtol=8e-3)
    np.testing.assert_allclose(to_np(py_t), np.asarray(py_j, np.float32), rtol=8e-3)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_build_gradient_matches_jax(rnnt_type):
    """The plain build is ordinary differentiable torch on the CPU."""
    am, lm, sym, bnd = loss_inputs(4, B=2, T=10, S=4, C=9)
    rng = np.random.default_rng(5)
    px_t, py_t = tlat.get_rnnt_logprobs_rows(*tt(lm, am, sym), 0, rnnt_type, tt(bnd))
    wx = rng.random(tuple(px_t.shape)).astype(np.float32)
    wy = rng.random(tuple(py_t.shape)).astype(np.float32)

    def jf(lm_, am_):
        px, py = jlat.get_rnnt_logprobs_rows(lm_, am_, jj(sym), 0, rnnt_type, jj(bnd), impl="xla")
        px = jnp.where(jnp.isfinite(px), px, 0.0)
        return jnp.sum(px * wx) + jnp.sum(py * wy)

    jgl, jga = jax.grad(jf, argnums=(0, 1))(*jj(lm, am))
    tlm = torch.from_numpy(lm).requires_grad_()
    tam = torch.from_numpy(am).requires_grad_()
    px_t, py_t = tlat.get_rnnt_logprobs_rows(tlm, tam, tt(sym), 0, rnnt_type, tt(bnd))
    px_t = torch.where(torch.isfinite(px_t), px_t, 0.0)
    ((px_t * torch.from_numpy(wx)).sum() + (py_t * torch.from_numpy(wy)).sum()).backward()
    assert_lattice_close(tlm.grad, jgl, "d lm")
    assert_lattice_close(tam.grad, jga, "d am")


@pytest.mark.parametrize("regular", [False, True], ids=["T", "T+1"])
def test_band_mask_rows_smajor_matches_jax(regular):
    rng = np.random.default_rng(6)
    S, B, T, K = 6, 3, 8, 3
    x = rng.normal(size=(S + 1, B, T + int(regular))).astype(np.float32)
    lo = band(7, B, S, T, K)
    got = tlat.band_mask_rows_smajor(*tt(x, lo), K)
    want = jlat.band_mask_rows_smajor(*jj(x, lo), K)
    assert_lattice_close(got, want)


def test_fix_for_boundary_matches_jax():
    rng = np.random.default_rng(8)
    px = rng.normal(size=(3, 4, 10)).astype(np.float32)
    bnd = np.array([[0, 0, 4, 9], [0, 0, 2, 5], [0, 0, 3, 0]], np.int32)
    assert_lattice_close(tlat.fix_for_boundary(*tt(px, bnd)), jlat.fix_for_boundary(*jj(px, bnd)))
    assert tlat.fix_for_boundary(tt(px)) is not None


def test_unknown_rnnt_type_raises():
    am, lm, sym, _ = loss_inputs(9, B=1, T=4, S=2, C=5)
    with pytest.raises(ValueError):
        tlat.get_rnnt_logprobs_rows(*tt(lm, am, sym), 0, "other")


def _cotangents(seed, S, B, T, modified):
    rng = np.random.default_rng(seed)
    dpx = rng.normal(size=(S, B, T if modified else T + 1)).astype(np.float32)
    dpy = rng.normal(size=(S + 1, B, T)).astype(np.float32)
    return dpx, dpy


def _te(bnd, B, regular):
    return bnd[:, 3].astype(np.int32) if regular and bnd is not None else np.full(B, -1, np.int32)


def _bwd_plain(lm, am, sym, bnd, dpx, dpy, rnnt_type, blank=0):
    """lattice_rows_bwd_plain for any rnnt_type: the constrained px is the
    modified px plus py[1:], so its px cotangent also reaches py[1:]."""
    B, S = sym.shape
    modified = rnnt_type != "regular"
    if rnnt_type == "constrained":
        dpy = dpy + np.concatenate([np.zeros_like(dpy[:1]), dpx], axis=0)
    d_lm, d_am, d_uni = latbuild.lattice_rows_bwd_plain(
        *tt(lm, am, sym, _te(bnd, B, not modified), dpx, dpy), blank, modified
    )
    assert d_uni is None
    return d_lm, d_am


@pytest.mark.parametrize("with_boundary", [False, True], ids=["nobnd", "bnd"])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_build_bwd_plain_matches_pallas_vjp(rnnt_type, with_boundary):
    """The build backward's plain version against jax.vjp of the Pallas
    build in interpret mode, which saves D as its residual (f32 mode) and
    runs ``_build_bwd_kernel``; random cotangents cover every entry."""
    am, lm, sym, bnd = loss_inputs(21, B=3, T=19, S=5, C=11)
    b = bnd if with_boundary else None
    dpx, dpy = _cotangents(22, 5, 3, 19, rnnt_type != "regular")
    _, vjp = jax.vjp(
        lambda l, a: lattice_rows_fused(l, a, jj(sym), 0, rnnt_type, jj(b), interpret=True),
        *jj(lm, am),
    )
    j_lm, j_am = vjp((jj(dpx), jj(dpy)))
    d_lm, d_am = _bwd_plain(lm, am, sym, b, dpx, dpy, rnnt_type)
    assert_close(d_lm, j_lm, SPLIT_ATOL, SPLIT_RTOL, "d lm")
    assert_close(d_am, j_am, SPLIT_ATOL, SPLIT_RTOL, "d am")


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_build_bwd_plain_matches_xla_vjp_and_autograd(rnnt_type):
    """Against the XLA build's VJP and torch autograd of the plain build,
    with out-of-range symbols (they contribute nothing) and cotangents
    zeroed on the -inf columns (the XLA VJP lets a cotangent there leak into
    the finite terms; the kernels, like the Pallas one, drop it)."""
    am, lm, sym, bnd = loss_inputs(23, B=3, T=14, S=5, C=9)
    sym[0, 0], sym[1, 2], sym[2, 4] = -1, 9, 40
    dpx, dpy = _cotangents(24, 5, 3, 14, rnnt_type != "regular")
    px_j, _ = jlat.get_rnnt_logprobs_rows(*jj(lm, am, sym), 0, rnnt_type, jj(bnd), impl="xla")
    dpx = np.where(np.isneginf(np.asarray(px_j)), 0.0, dpx).astype(np.float32)
    _, vjp = jax.vjp(
        lambda l, a: jlat.get_rnnt_logprobs_rows(l, a, jj(sym), 0, rnnt_type, jj(bnd), impl="xla"),
        *jj(lm, am),
    )
    j_lm, j_am = vjp((jj(dpx), jj(dpy)))
    d_lm, d_am = _bwd_plain(lm, am, sym, bnd, dpx, dpy, rnnt_type)
    assert_lattice_close(d_lm, j_lm, "d lm vs xla")
    assert_lattice_close(d_am, j_am, "d am vs xla")
    tlm = torch.from_numpy(lm).requires_grad_()
    tam = torch.from_numpy(am).requires_grad_()
    px, py = tlat.get_rnnt_logprobs_rows(tlm, tam, tt(sym), 0, rnnt_type, tt(bnd))
    g_lm, g_am = torch.autograd.grad([px, py], [tlm, tam], [torch.from_numpy(dpx), torch.from_numpy(dpy)])
    assert_lattice_close(d_lm, g_lm, "d lm vs autograd")
    assert_lattice_close(d_am, g_am, "d am vs autograd")


@pytest.mark.parametrize("S,blank", [(0, 0), (4, 5), (3, -2)], ids=["S0", "blank5", "blank-2"])
@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_build_bwd_plain_edge_cases_match_autograd(rnnt_type, S, blank):
    """S = 0 (no px rows) and a non-zero or negative blank."""
    am, lm, sym, bnd = loss_inputs(25, B=2, T=9, S=max(S, 1), C=7)
    lm, sym = lm[:, : S + 1].copy(), sym[:, :S].copy()
    bnd[:, 2] = np.minimum(bnd[:, 2], S)
    dpx, dpy = _cotangents(26, S, 2, 9, rnnt_type == "modified")
    if rnnt_type == "regular":
        dpx[:, :, -1] = 0.0
        dpx[:, np.arange(2), bnd[:, 3]] = 0.0
    tlm = torch.from_numpy(lm).requires_grad_()
    tam = torch.from_numpy(am).requires_grad_()
    px, py = latbuild.lattice_rows(tlm, tam, tt(sym), blank, rnnt_type, tt(bnd))
    g_lm, g_am = torch.autograd.grad([px, py], [tlm, tam], [torch.from_numpy(dpx), torch.from_numpy(dpy)])
    d_lm, d_am = _bwd_plain(lm, am, sym, bnd, dpx, dpy, rnnt_type, blank)
    assert_lattice_close(d_lm, g_lm, "d lm")
    assert_lattice_close(d_am, g_am, "d am")
