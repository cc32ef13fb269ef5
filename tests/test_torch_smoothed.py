"""Port parity: the smoothed lattice build (fast_rnnt_tpu_torch.ops.lattice
get_rnnt_logprobs_smoothed_rows and the plain side of
ops/kernels/latbuild.py: the parts build and its backward) vs the JAX
package's XLA smoothed build and its Pallas parts kernels in interpret
mode, values and gradients; the kernel route also on bf16 and f16 lm and
am, against the Pallas route on the same rounded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.ops import lattice as jlat
from fast_rnnt_tpu.ops.kernels import latbuild as jlb
from fast_rnnt_tpu_torch.ops import lattice as tlat
from fast_rnnt_tpu_torch.ops.kernels import latbuild

from ._torch_parity import (
    SPLIT_ATOL,
    SPLIT_RTOL,
    assert_close,
    assert_lattice_close,
    jj,
    loss_inputs,
    tt,
)

TYPES = ["regular", "modified", "constrained"]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _grad_rtol(dtype):
    """Gradient rtol against the Pallas backward: the float32 cases' (the
    Pallas float32 mode forms its products as 2-term bf16 splits, ~2^-16
    relative) plus, for a float16 output, one float16 step (2^-10): float16
    lm and am ride that float32 mode, and two float32 values 2^-16 apart
    may round to neighbouring float16 steps.  The bf16 mode's products are
    exact in float32 on both sides, so bf16 outputs take the float32
    cases' tolerance."""
    return SPLIT_RTOL + (2.0**-10 if dtype == torch.float16 else 0.0)


def _cast(dtype, *arrays):
    """numpy float32 -> (torch tensors, jax arrays) in ``dtype``, the same
    rounded values on both sides."""
    return ([torch.from_numpy(a).to(dtype) for a in arrays],
            [jnp.asarray(a).astype(_JNP[dtype]) for a in arrays])


def _uni(lm):
    """The unigram LM of the smoothed build (mean of the normalized lm
    probs over (B, S+1), + tiny), in numpy."""
    p = np.exp(lm - lm.max(axis=2, keepdims=True))
    return ((p / p.sum(axis=2, keepdims=True)).mean(axis=(0, 1)) + np.finfo(np.float32).tiny).astype(
        np.float32
    )


def _jax_parts(lm, am, sym, te, uni, modified):
    """The Pallas parts build (interpret mode) as a function of (lm, am, uni)."""
    return lambda l, a, u: jlb._build_parts(
        l, a, jj(sym), jj(te), u, jlat.matmul_precision(), 0, modified, True
    )


def _te(bnd, regular):
    return bnd[:, 3].astype(np.int32) if regular else np.full(bnd.shape[0], -1, np.int32)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_parts_plain_matches_pallas(rnnt_type, dtype):
    """(px, py, normd) of the parts build's plain version against the
    Pallas parts kernel, on float32, bf16 and f16 lm and am (the plain
    version rounds where the Pallas kernel's bf16 mode rounds; f16 rides
    float32); normd = norm - amonly, the form the interpolation needs."""
    modified = rnnt_type == "modified"
    am, lm, sym, bnd = loss_inputs(30, B=3, T=21, S=5, C=13)
    uni, te = _uni(lm), _te(bnd, not modified)
    (lm_t, am_t), (lm_j, am_j) = _cast(dtype, lm, am)
    want = _jax_parts(lm, am, sym, te, uni, modified)(lm_j, am_j, jj(uni))
    got = latbuild.lattice_rows_parts_plain(lm_t, am_t, *tt(sym, te, uni), 0, modified)
    for g, w, name in zip(got, want, ("px", "py", "normd")):
        assert g.dtype == torch.float32
        assert_lattice_close(g, w, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_parts_bwd_plain_matches_pallas_vjp(rnnt_type, dtype):
    """The parts backward's plain version, with the unigram row (d_uni, a
    batch-wide sum), against jax.vjp of the Pallas parts kernel on float32,
    bf16 and f16 lm and am (d_am in am's dtype; d_lm float32, compared in
    lm's dtype as the Pallas route returns it), and, float32, torch
    autograd of the plain parts build."""
    modified = rnnt_type == "modified"
    B, T, S, C = 3, 17, 5, 11
    am, lm, sym, bnd = loss_inputs(31, B=B, T=T, S=S, C=C)
    uni, te = _uni(lm), _te(bnd, not modified)
    rng = np.random.default_rng(32)
    dpx = rng.normal(size=(S, B, T if modified else T + 1)).astype(np.float32)
    dpy = rng.normal(size=(S + 1, B, T)).astype(np.float32)
    dnd = rng.normal(size=(S + 1, B, T)).astype(np.float32)
    (lm_t, am_t), (lm_j, am_j) = _cast(dtype, lm, am)
    _, vjp = jax.vjp(_jax_parts(lm, am, sym, te, uni, modified), lm_j, am_j, jj(uni))
    want = vjp(jj(dpx, dpy, dnd))
    got = latbuild.lattice_rows_bwd_plain(
        lm_t, am_t, *tt(sym, te, dpx, dpy), 0, modified, *tt(uni, dnd)
    )
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype and got[2].dtype == torch.float32
    got = (got[0].to(dtype), *got[1:])
    for g, w, name, rtol in zip(got, want, ("d lm", "d am", "d uni"),
                                (_grad_rtol(dtype), _grad_rtol(dtype), SPLIT_RTOL)):
        assert_close(g, w, SPLIT_ATOL, rtol, name)
    if dtype != torch.float32:
        return  # autograd of the rounded forward is not the rounded VJP
    leaves = [torch.from_numpy(x).requires_grad_() for x in (lm, am, uni)]
    outs = latbuild.lattice_rows_parts_plain(leaves[0], leaves[1], tt(sym), tt(te), leaves[2], 0, modified)
    if not modified:  # autograd of the killed columns' constant -inf: no flow
        dpx[:, :, -1] = 0.0
        dpx[:, np.arange(B), te] = 0.0
    ag = torch.autograd.grad(outs, leaves, [torch.from_numpy(x) for x in (dpx, dpy, dnd)])
    for g, w, name in zip(got, ag, ("d lm", "d am", "d uni")):
        assert_lattice_close(g, w, name + " vs autograd")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("scales", [(0.1, 0.1), (0.25, 0.0), (0.0, 0.3)])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_smoothed_rows_match_jax(rnnt_type, scales, dtype):
    """Both routes of the port (the plain build that CPU tensors take, and
    the kernel route's composition around the parts build) against the JAX
    package's XLA build and its Pallas route in interpret mode; on bf16 and
    f16 lm and am the kernel route against the Pallas route (the plain
    route is held to the XLA pipeline on bf16 in test_torch_bf16.py)."""
    am, lm, sym, bnd = loss_inputs(33, B=3, T=19, S=5, C=13)
    lms, ams = scales
    (lm_t, am_t), (lm_j, am_j) = _cast(dtype, lm, am)
    want_p = jlb.lattice_rows_fused_smoothed(
        lm_j, am_j, jj(sym), 0, lms, ams, jj(bnd), rnnt_type, interpret=True
    )
    comp = latbuild.lattice_rows_smoothed(lm_t, am_t, tt(sym), 0, lms, ams, tt(bnd), rnnt_type)
    arms = [(comp, want_p, "composed vs pallas")]
    if dtype == torch.float32:
        want_x = jlat.get_rnnt_logprobs_smoothed_rows(
            *jj(lm, am, sym), 0, lms, ams, jj(bnd), rnnt_type, impl="xla"
        )
        plain = tlat.get_rnnt_logprobs_smoothed_rows(*tt(lm, am, sym), 0, lms, ams, tt(bnd), rnnt_type)
        arms += [(plain, want_x, "plain vs xla"), (comp, plain, "composed vs plain")]
    for got, want, what in arms:
        assert_lattice_close(got[0], want[0], what + " px")
        assert_lattice_close(got[1], want[1], what + " py")


def test_smoothed_out_of_range_symbols_match_xla():
    """A symbol outside [0, C) reads 0 in every gather, as in the XLA
    build; both port routes agree."""
    am, lm, sym, bnd = loss_inputs(34, B=3, T=12, S=5, C=9)
    sym[0, 0], sym[1, 2], sym[2, 4] = -1, 9, 40
    want = jlat.get_rnnt_logprobs_smoothed_rows(*jj(lm, am, sym), 0, 0.2, 0.1, jj(bnd), impl="xla")
    plain = tlat.get_rnnt_logprobs_smoothed_rows(*tt(lm, am, sym), 0, 0.2, 0.1, tt(bnd))
    comp = latbuild.lattice_rows_smoothed(*tt(lm, am, sym), 0, 0.2, 0.1, tt(bnd))
    for got in (plain, comp):
        assert_lattice_close(got[0], want[0], "px")
        assert_lattice_close(got[1], want[1], "py")


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_smoothed_gradient_matches_jax(rnnt_type):
    """Gradients w.r.t. (lm, am) of both port routes against the Pallas
    route's VJP and the XLA build's.  d_lm includes the unigram LM's
    batch-wide coupling (the kernel's d_uni).  Cotangents are zeroed on the
    -inf px columns, where the XLA VJP leaks (see
    tests/test_fused_build.py:195)."""
    am, lm, sym, bnd = loss_inputs(35, B=3, T=15, S=5, C=11)
    px_x, py_x = jlat.get_rnnt_logprobs_smoothed_rows(
        *jj(lm, am, sym), 0, 0.2, 0.1, jj(bnd), rnnt_type, impl="xla"
    )
    rng = np.random.default_rng(36)
    cpx = rng.normal(size=px_x.shape).astype(np.float32)
    cpx = np.where(np.isneginf(np.asarray(px_x)), 0.0, cpx).astype(np.float32)
    cpy = rng.normal(size=py_x.shape).astype(np.float32)

    def jgrad(build):
        def f(l, a):
            px, py = build(l, a)
            return jnp.sum(jnp.where(cpx != 0, px, 0.0) * cpx) + jnp.sum(py * cpy)

        return jax.grad(f, argnums=(0, 1))(*jj(lm, am))

    want_x = jgrad(lambda l, a: jlat.get_rnnt_logprobs_smoothed_rows(
        l, a, jj(sym), 0, 0.2, 0.1, jj(bnd), rnnt_type, impl="xla"))
    want_p = jgrad(lambda l, a: jlb.lattice_rows_fused_smoothed(
        l, a, jj(sym), 0, 0.2, 0.1, jj(bnd), rnnt_type, interpret=True))
    for route, want, atol, rtol in (
        (tlat.get_rnnt_logprobs_smoothed_rows, want_x, 1e-5, 1e-5),
        (latbuild.lattice_rows_smoothed, want_p, SPLIT_ATOL, SPLIT_RTOL),
    ):
        tlm = torch.from_numpy(lm).requires_grad_()
        tam = torch.from_numpy(am).requires_grad_()
        px, py = route(tlm, tam, tt(sym), 0, 0.2, 0.1, tt(bnd), rnnt_type)
        px = torch.where(torch.from_numpy(cpx) != 0, px, 0.0)
        g = torch.autograd.grad([px, py], [tlm, tam], [torch.from_numpy(cpx), torch.from_numpy(cpy)])
        assert_close(g[0], want[0], atol, rtol, f"{route.__name__} d lm")
        assert_close(g[1], want[1], atol, rtol, f"{route.__name__} d am")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_smoothed_narrow_gradient_matches_pallas(rnnt_type, dtype):
    """Gradients w.r.t. bf16 and f16 (lm, am) of the kernel route (its
    plain versions on the CPU) against the Pallas route's VJP on the same
    rounded inputs, in the inputs' dtype.  d_lm sums the kernel's d_lm with
    the lm-side terms of the interpolation and the unigram LM in float32
    before its one rounding; both are held to ``_grad_rtol``."""
    am, lm, sym, bnd = loss_inputs(35, B=3, T=15, S=5, C=11)
    (lm_t, am_t), (lm_j, am_j) = _cast(dtype, lm, am)
    px_x, py_x = jlb.lattice_rows_fused_smoothed(
        lm_j, am_j, jj(sym), 0, 0.2, 0.1, jj(bnd), rnnt_type, interpret=True
    )
    rng = np.random.default_rng(37)
    cpx = rng.normal(size=px_x.shape).astype(np.float32)
    cpx = np.where(np.isneginf(np.asarray(px_x)), 0.0, cpx).astype(np.float32)
    cpy = rng.normal(size=py_x.shape).astype(np.float32)

    def f(l, a):
        px, py = jlb.lattice_rows_fused_smoothed(l, a, jj(sym), 0, 0.2, 0.1, jj(bnd), rnnt_type,
                                                 interpret=True)
        return jnp.sum(jnp.where(cpx != 0, px, 0.0) * cpx) + jnp.sum(py * cpy)

    want = jax.grad(f, argnums=(0, 1))(lm_j, am_j)
    tlm, tam = lm_t.requires_grad_(), am_t.requires_grad_()
    px, py = latbuild.lattice_rows_smoothed(tlm, tam, tt(sym), 0, 0.2, 0.1, tt(bnd), rnnt_type)
    px = torch.where(torch.from_numpy(cpx) != 0, px, 0.0)
    g = torch.autograd.grad([px, py], [tlm, tam], [torch.from_numpy(cpx), torch.from_numpy(cpy)])
    for got, w, name in zip(g, want, ("d lm", "d am")):
        assert got.dtype == dtype
        assert_close(got, w.astype(jnp.float32), SPLIT_ATOL, _grad_rtol(dtype), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_parts_bwd_plain_takes_the_forward_residual(dtype):
    """Given the forward's residual D (S+1, B, T), as the kernels take it,
    the plain backward uses it in place of its own normalizer denominator:
    the same D gives the same bits."""
    B, T, S, C = 2, 9, 4, 7
    am, lm, sym, bnd = loss_inputs(38, B=B, T=T, S=S, C=C)
    uni, te = _uni(lm), _te(bnd, True)
    rng = np.random.default_rng(39)
    dpx, dpy, dnd = (rng.normal(size=(n, B, T + 1 if n == S else T)).astype(np.float32) for n in (S, S + 1, S + 1))
    (lm_t, am_t), _ = _cast(dtype, lm, am)
    args = (lm_t, am_t, *tt(sym, te, dpx, dpy), 0, False, *tt(uni, dnd))
    lmp = latbuild._lm_probs(lm_t, True).float()
    amp = latbuild._lm_probs(am_t, True).float()
    d = torch.einsum("bsc,btc->sbt", lmp, amp) + float(np.finfo(np.float32).tiny)
    for g, w in zip(latbuild.lattice_rows_bwd_plain(*args, d=d), latbuild.lattice_rows_bwd_plain(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    got = latbuild.lattice_rows_bwd_plain(*args, d=d * 2)  # and it is read: w halves
    assert not torch.equal(got[1], latbuild.lattice_rows_bwd_plain(*args)[1])
