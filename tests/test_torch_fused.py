"""Port parity: the fused forward + occupancy-backward recursion
(fast_rnnt_tpu_torch.ops.kernels.wavefront.fused_rows, its plain version on
the CPU) vs the JAX package's fused Pallas kernel in interpret mode and vs
the port's split pair, the storage dtypes, and the kernel route of the
rows ops of fast_rnnt_tpu_torch.ops.recursion: the calc_gradients op runs
the fused launch, the scores op the forward phase and, under autograd,
the backward phase (spied on the port's module only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_rnnt_tpu as jft
import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu.ops.kernels import wavefront as jwf
from fast_rnnt_tpu.ops import recursion as jrec
from fast_rnnt_tpu_torch.ops import recursion as trec
from fast_rnnt_tpu_torch.ops.kernels import wavefront

from ._torch_parity import (
    assert_close,
    assert_lattice_close,
    assert_loss_close,
    band,
    jj,
    loss_inputs,
    rows_inputs,
    storage_rtol,
    to_np,
    tt,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _case(seed, modified, banded, B=4, S=9, T=50, offset=True):
    px, py, bnd = rows_inputs(seed, B=B, S=S, T=T, modified=modified, offset=offset)
    K = 3 if banded else 0
    lo = band(seed + 1, B, S, T, K) if banded else None
    return px, py, bnd, lo, K


@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_fused_rows_match_pallas_interpret(modified, banded):
    """Against the fused Pallas kernel itself, run in interpret mode (as
    tests/test_fused_kernel.py runs it)."""
    px, py, bnd, lo, K = _case(3, modified, banded)
    sc_t, gx_t, gy_t = wavefront.fused_rows(*tt(px, py, bnd), tt(lo) if banded else None, K)
    out = jwf.fused_rows_pallas(*jj(px, py, bnd), lo=jj(lo), K=K, interpret=True)
    assert out is not None
    sc_j, gx_j, gy_j = out
    assert_loss_close(sc_t, sc_j, "scores")
    assert_lattice_close(gx_t, gx_j, "px_grad")
    assert_lattice_close(gy_t, gy_j, "py_grad")


def test_fused_bf16_storage_matches_pallas_interpret():
    """bf16 storage: scores float32, occupancies bf16, as the Pallas kernel
    returns them (tests/test_fused_kernel.py:70-88)."""
    px, py, bnd, _, _ = _case(5, False, False, B=3, S=7, T=40, offset=False)
    px16, py16 = (torch.from_numpy(x).bfloat16() for x in (px, py))
    sc_t, gx_t, gy_t = wavefront.fused_rows(px16, py16, tt(bnd))
    assert sc_t.dtype == torch.float32
    assert gx_t.dtype == torch.bfloat16 and gy_t.dtype == torch.bfloat16
    sc_j, gx_j, gy_j = jwf.fused_rows_pallas(
        jnp.asarray(px).astype(jnp.bfloat16), jnp.asarray(py).astype(jnp.bfloat16),
        jj(bnd), interpret=True,
    )
    assert gx_j.dtype == jnp.bfloat16
    assert_loss_close(sc_t, sc_j, "scores")
    # occupancies rounded to bf16 on both sides: one bf16 step apart at most
    rtol = storage_rtol(torch.bfloat16)
    assert_close(gx_t, np.asarray(gx_j, np.float32), 1e-5, rtol, "px_grad")
    assert_close(gy_t, np.asarray(gy_j, np.float32), 1e-5, rtol, "py_grad")


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_fused_equals_split_pair(modified, banded, dtype):
    """fused_rows == forward_rows then backward_rows seeded with ones, in
    every storage dtype; the occupancies keep the storage dtype."""
    px, py, bnd, lo, K = _case(7, modified, banded)
    dt = DTYPES[dtype]
    px, py = torch.from_numpy(px).to(dt), torch.from_numpy(py).to(dt)
    lo = tt(lo) if banded else None
    sc, gx, gy = wavefront.fused_rows(px, py, tt(bnd), lo, K)
    p, sc2 = wavefront.forward_rows(px, py, tt(bnd), lo, K)
    gx2, gy2 = wavefront.backward_rows(px, py, p, tt(bnd), torch.ones_like(sc2), lo, K)
    assert p.dtype == torch.float32 and sc.dtype == torch.float32
    assert gx.dtype == dt and gy.dtype == dt
    assert torch.equal(sc, sc2) and torch.equal(gx, gx2) and torch.equal(gy, gy2)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_storage_dtypes_match_jax_xla_in_float32(dtype):
    """Narrow storage computes in float32: the port's split pair on the
    rounded inputs equals the JAX XLA core on the same rounded inputs
    widened to float32, up to the rounding of the occupancies."""
    px, py, bnd, lo, K = _case(9, True, True)
    dt = DTYPES[dtype]
    px_n, py_n = torch.from_numpy(px).to(dt), torch.from_numpy(py).to(dt)
    p, sc = wavefront.forward_rows(px_n, py_n, tt(bnd), tt(lo), K)
    gx, gy = wavefront.backward_rows(px_n, py_n, p, tt(bnd), torch.ones_like(sc), tt(lo), K)
    px32, py32 = to_np(px_n.float()), to_np(py_n.float())
    p_j, sc_j = jrec._forward_rows_xla(*jj(px32, py32, bnd), lo=jj(lo), K=K)
    gx_j, gy_j = jrec._backward_rows_xla(*jj(px32, py32), p_j, jj(bnd), jnp.ones(4), lo=jj(lo), K=K)
    assert_loss_close(sc, sc_j, "scores")
    assert_lattice_close(p, p_j, "p")
    assert_close(gx.float(), gx_j, 1e-5, storage_rtol(dt), "px_grad")
    assert_close(gy.float(), gy_j, 1e-5, storage_rtol(dt), "py_grad")


def _spy_rows(monkeypatch):
    """Record which of the three sweep entries the rows ops call, in order."""
    calls = []
    for name in ("fused_rows", "forward_rows", "backward_rows"):
        real = getattr(wavefront, name)

        def spy(*a, _name=name, _real=real, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(wavefront, name, spy)
    return calls


@pytest.mark.parametrize("calc_gradients", [False, True], ids=["scores_op", "grads_op"])
@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
def test_grads_op_runs_fused_and_scores_op_the_pair(monkeypatch, banded, calc_gradients):
    """The calc_gradients op runs the fused launch once; the scores op runs
    the forward phase once and its VJP the backward phase once, never the
    fused launch; d(w . scores)/d(px, py) matches jax.grad either way."""
    calls = _spy_rows(monkeypatch)
    px, py, bnd, lo, K = _case(11, False, banded, B=3, S=5, T=11, offset=False)
    w = np.random.default_rng(1).random(3).astype(np.float32)

    def jf(px_, py_):
        out = jrec.mutual_information_rows(
            px_, py_, jj(bnd), lo=jj(lo), s_range=K, calc_gradients=calc_gradients, impl="xla"
        )
        return jnp.sum((out[0] if calc_gradients else out) * jj(w))

    jgx, jgy = jax.grad(jf, argnums=(0, 1))(*jj(px, py))
    tpx = torch.from_numpy(px).requires_grad_()
    tpy = torch.from_numpy(py).requires_grad_()
    out = trec.mutual_information_rows(
        tpx, tpy, tt(bnd), lo=tt(lo) if banded else None, s_range=K,
        calc_gradients=calc_gradients,
    )
    ((out[0] if calc_gradients else out) * torch.from_numpy(w)).sum().backward()
    assert calls == (["fused_rows"] if calc_gradients else ["forward_rows", "backward_rows"])
    assert_lattice_close(tpx.grad, jgx, "d px")
    assert_lattice_close(tpy.grad, jgy, "d py")


_JAX_PIPELINES = {"simple": jft.rnnt_loss_simple_pruned, "smoothed": jft.rnnt_loss_smoothed_pruned}
_TORCH_PIPELINES = {"simple": ft.rnnt_loss_simple_pruned, "smoothed": ft.rnnt_loss_smoothed_pruned}


@pytest.mark.parametrize("pipeline", ["simple", "smoothed"])
@pytest.mark.parametrize("rnnt_type", ["regular", "modified", "constrained"])
def test_pruned_pipelines_run_stage1_fused_and_stage2_the_pair(monkeypatch, rnnt_type, pipeline):
    """Both two-stage pruned pipelines run stage 1 (with occupancies) by the
    fused launch and stage 2 (the scores op and its VJP) by the forward and
    backward phases; losses, ranges and the gradient of 0.5 * stage 1 +
    stage 2 w.r.t. (am, lm) match the JAX pipeline's (impl="xla")."""
    am, lm, sym, bnd = loss_inputs(13, B=3, T=14, S=5, C=9)

    def jf(am_, lm_):
        s, p, r = _JAX_PIPELINES[pipeline](lm_, am_, jj(sym), 0, 3, boundary=jj(bnd),
                                           rnnt_type=rnnt_type, reduction="sum", impl="xla")
        return 0.5 * s + p, (s, p, r)

    (_, (s_j, p_j, r_j)), (jga, jgl) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        *jj(am, lm))
    calls = _spy_rows(monkeypatch)
    tam, tlm = tt(am).requires_grad_(), tt(lm).requires_grad_()
    s, p, r = _TORCH_PIPELINES[pipeline](tlm, tam, tt(sym), 0, 3, boundary=tt(bnd),
                                         rnnt_type=rnnt_type, reduction="sum")
    (0.5 * s + p).backward()
    assert calls == ["fused_rows", "forward_rows", "backward_rows"]
    np.testing.assert_array_equal(to_np(r), np.asarray(r_j))
    assert_loss_close(s.detach(), s_j, "stage 1")
    assert_loss_close(p.detach(), p_j, "pruned")
    assert_lattice_close(tam.grad, jga, "d am")
    assert_lattice_close(tlm.grad, jgl, "d lm")


def test_recipe_runs_stage1_fused_and_stage2_the_pair(monkeypatch):
    """The real-joiner recipe (rnnt_loss_simple with occupancies, ranges,
    do_rnnt_pruning, the joiner am_p + lm_p, rnnt_loss_pruned) takes the same
    route, and its loss and (am, lm) gradient match the JAX recipe's."""
    am, lm, sym, bnd = loss_inputs(15, B=3, T=12, S=5, C=10)

    def jf(am_, lm_):
        _, (gx, gy) = jft.rnnt_loss_simple(lm_, am_, jj(sym), 0, jj(bnd), calc_gradients=True,
                                           impl="xla")
        ranges = jft.get_rnnt_prune_ranges(gx, gy, jj(bnd), 3)
        am_p, lm_p = jft.do_rnnt_pruning(am_, lm_, ranges)
        return jft.rnnt_loss_pruned(am_p + lm_p, jj(sym), ranges, 0, jj(bnd), reduction="sum",
                                    impl="xla"), ranges

    (want, r_j), (jga, jgl) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(*jj(am, lm))
    calls = _spy_rows(monkeypatch)
    tam, tlm = tt(am).requires_grad_(), tt(lm).requires_grad_()
    _, (gx, gy) = ft.rnnt_loss_simple(tlm, tam, tt(sym), 0, tt(bnd), calc_gradients=True)
    ranges = ft.get_rnnt_prune_ranges(gx, gy, tt(bnd), 3)
    am_p, lm_p = ft.do_rnnt_pruning(tam, tlm, ranges)
    loss = ft.rnnt_loss_pruned(am_p + lm_p, tt(sym), ranges, 0, tt(bnd), reduction="sum")
    loss.backward()
    assert calls == ["fused_rows", "forward_rows", "backward_rows"]
    np.testing.assert_array_equal(to_np(ranges), np.asarray(r_j))
    assert_loss_close(loss.detach(), want, "loss")
    assert_lattice_close(tam.grad, jga, "d am")
    assert_lattice_close(tlm.grad, jgl, "d lm")
