"""Port parity, end to end: fast_rnnt_tpu_torch.rnnt_loss_simple_pruned vs
fast_rnnt_tpu.rnnt_loss_simple_pruned (simple loss, pruned loss, ranges
and the gradient of 0.5 * simple + pruned w.r.t. (am, lm))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_rnnt_tpu as frt
import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu_torch.utils import check_rnnt_inputs, from_numpy

from ._torch_parity import (
    LOSS_ATOL,
    LOSS_RTOL,
    assert_lattice_close,
    assert_loss_close,
    jj,
    loss_inputs,
    to_np,
    tt,
)

TYPES = ["regular", "modified", "constrained"]


_STATIC = ("termination_symbol", "s_range", "rnnt_type", "delay_penalty", "reduction",
           "impl", "lattice_dtype")
_jax_pipeline = jax.jit(frt.rnnt_loss_simple_pruned, static_argnames=_STATIC)


def _jax_loss(am, lm, sym, bnd, s_range, **kw):
    """The JAX pipeline, jitted (eager dispatch of its scans is slow)."""
    lm_, am_, sym_ = jj(lm, am, sym)
    return _jax_pipeline(
        lm_, am_, sym_, termination_symbol=0, s_range=s_range,
        boundary=None if bnd is None else jj(bnd), impl="xla", **kw
    )


def _agree(r_t, r_j):
    """Per-utterance mask of identical ranges.  The two sides' occupancies
    differ in the last float32 bits, so a window argmax may flip at a
    near-tie and the repair then moves whole runs of windows (ROADMAP
    Queue 3); the pruned losses are compared where the ranges agree, and
    most utterances must agree."""
    agree = (to_np(r_t) == np.asarray(r_j)).reshape(r_t.shape[0], -1).all(axis=1)
    assert agree.mean() >= 0.5, f"ranges agree on only {agree.mean():.2f} of utterances"
    return agree


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_simple_pruned_matches_jax(rnnt_type, ragged):
    am, lm, sym, bnd = loss_inputs(10, B=3, T=23, S=7, C=14, ragged=ragged)
    s_t, p_t, r_t = ft.rnnt_loss_simple_pruned(
        *tt(lm, am, sym), 0, 3, tt(bnd), rnnt_type=rnnt_type, reduction="none"
    )
    s_j, p_j, r_j = _jax_loss(am, lm, sym, bnd, 3, rnnt_type=rnnt_type, reduction="none")
    assert_loss_close(s_t, s_j, "simple")
    agree = _agree(r_t, r_j)
    assert_loss_close(to_np(p_t)[agree], np.asarray(p_j)[agree], "pruned")
    assert r_t.dtype == torch.int32 and tuple(r_t.shape) == r_j.shape


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_simple_pruned_gradient_matches_jax(rnnt_type):
    am, lm, sym, bnd = loss_inputs(11, B=2, T=15, S=5, C=10)

    def jf(am_, lm_):
        s, p, _ = frt.rnnt_loss_simple_pruned(
            lm_, am_, jj(sym), 0, 3, jj(bnd), rnnt_type=rnnt_type, reduction="sum", impl="xla"
        )
        return 0.5 * s + p

    jv, (jga, jgl) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(*jj(am, lm))
    tam = torch.from_numpy(am).requires_grad_()
    tlm = torch.from_numpy(lm).requires_grad_()
    s, p, _ = ft.rnnt_loss_simple_pruned(
        tlm, tam, tt(sym), 0, 3, tt(bnd), rnnt_type=rnnt_type, reduction="sum"
    )
    loss = 0.5 * s + p
    loss.backward()
    assert_loss_close(loss.detach(), np.asarray(jv), "loss")
    assert_lattice_close(tam.grad, jga, "d am")
    assert_lattice_close(tlm.grad, jgl, "d lm")


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_reductions_and_delay_penalty_match_jax(reduction):
    am, lm, sym, bnd = loss_inputs(12, B=3, T=18, S=6, C=9)
    s_t, p_t, _ = ft.rnnt_loss_simple_pruned(
        *tt(lm, am, sym), 0, 2, tt(bnd), delay_penalty=0.05, reduction=reduction
    )
    s_j, p_j, _ = _jax_loss(am, lm, sym, bnd, 2, delay_penalty=0.05, reduction=reduction)
    assert s_t.dim() == 0
    assert_loss_close(s_t, s_j, "simple")
    assert_loss_close(p_t, p_j, "pruned")


def test_no_boundary_and_large_s_range_match_jax():
    am, lm, sym, _ = loss_inputs(13, B=2, T=12, S=4, C=8, ragged=False)
    s_t, p_t, r_t = ft.rnnt_loss_simple_pruned(*tt(lm, am, sym), 0, 50, reduction="none")
    s_j, p_j, r_j = _jax_loss(am, lm, sym, None, 50, reduction="none")
    assert r_t.shape[2] == 5  # clamped to S + 1
    np.testing.assert_array_equal(to_np(r_t), np.asarray(r_j))
    assert_loss_close(s_t, s_j)
    assert_loss_close(p_t, p_j)  # the full band: pruned == simple


def test_bf16_lattice_storage_on_cpu_matches_jax():
    am, lm, sym, bnd = loss_inputs(14, B=2, T=16, S=5, C=9)
    s_t, p_t, _ = ft.rnnt_loss_simple_pruned(
        *tt(lm, am, sym), 0, 3, tt(bnd), reduction="none", lattice_dtype=torch.bfloat16
    )
    s_j, p_j, _ = _jax_loss(am, lm, sym, bnd, 3, reduction="none", lattice_dtype=jnp.bfloat16)
    # bf16 storage rounds each lattice entry once (~4e-3 relative)
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_j), rtol=1e-3)
    np.testing.assert_allclose(to_np(p_t), np.asarray(p_j), rtol=1e-3)


def test_input_validation_and_guards():
    am, lm, sym, bnd = loss_inputs(15, B=2, T=8, S=3, C=6)
    with pytest.raises(ValueError):
        ft.rnnt_loss_simple_pruned(*tt(lm, am, sym), 0, 1, tt(bnd), rnnt_type="constrained")
    with pytest.raises(ValueError):
        check_rnnt_inputs(lm=tt(lm), am=tt(am[:, :, :5]))
    with pytest.raises(ValueError):
        check_rnnt_inputs(lm=tt(lm), symbols=tt(sym[:, :2]))
    with pytest.raises(ValueError):
        check_rnnt_inputs(am=tt(am), symbols=torch.from_numpy(sym).float())
    with pytest.raises(ValueError):
        check_rnnt_inputs(am=tt(am), termination_symbol=6)
    with pytest.raises(ValueError):
        check_rnnt_inputs(am=tt(am), boundary=tt(bnd[:, :3]))
    with pytest.raises(ValueError):
        ft.rnnt_loss_simple_pruned(*tt(lm, am, sym), 0, 2, tt(bnd), reduction="max")


def test_from_numpy_carries_dtypes_and_device():
    am, lm, sym, bnd = loss_inputs(16, B=1, T=4, S=2, C=5)
    a, s, b, none = from_numpy(am.astype(np.float64), sym.astype(np.int64), bnd, None, device="cpu")
    assert a.dtype == torch.float32 and s.dtype == torch.int32 and b.dtype == torch.int32
    assert none is None and a.device.type == "cpu"
    np.testing.assert_allclose(to_np(a), am, rtol=0, atol=LOSS_ATOL * LOSS_RTOL)
    with pytest.raises(TypeError):
        from_numpy(np.array([True]), device="cpu")


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


_jax_simple = _jit(frt.rnnt_loss_simple, "termination_symbol", "rnnt_type", "delay_penalty",
                   "reduction", "calc_gradients", "impl")
_jax_smoothed = _jit(frt.rnnt_loss_smoothed, "termination_symbol", "lm_only_scale",
                     "am_only_scale", "rnnt_type", "delay_penalty", "reduction",
                     "calc_gradients", "impl")
_jax_smoothed_pruned = _jit(frt.rnnt_loss_smoothed_pruned, "termination_symbol", "s_range",
                            "lm_only_scale", "am_only_scale", "rnnt_type", "delay_penalty",
                            "reduction", "impl", "lattice_dtype")


def _unpruned(name):
    """(port function, jitted JAX function, extra keyword arguments)."""
    if name == "simple":
        return ft.rnnt_loss_simple, _jax_simple, {}
    return ft.rnnt_loss_smoothed, _jax_smoothed, {"lm_only_scale": 0.2, "am_only_scale": 0.1}


@pytest.mark.parametrize("calc_gradients", [False, True], ids=["loss", "occupancies"])
@pytest.mark.parametrize("name", ["simple", "smoothed"])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_unpruned_losses_match_jax(rnnt_type, name, calc_gradients):
    """rnnt_loss_simple / rnnt_loss_smoothed, reduction "none", and with
    calc_gradients the (B, S, T')-major occupancies."""
    fn, jfn, kw = _unpruned(name)
    am, lm, sym, bnd = loss_inputs(40, B=3, T=16, S=5, C=11)
    got = fn(*tt(lm, am, sym), 0, boundary=tt(bnd), rnnt_type=rnnt_type, reduction="none",
             calc_gradients=calc_gradients, **kw)
    want = jfn(*jj(lm, am, sym), termination_symbol=0, boundary=jj(bnd), rnnt_type=rnnt_type,
               reduction="none", calc_gradients=calc_gradients, impl="xla", **kw)
    if calc_gradients:
        (got, (gx, gy)), (want, (wx, wy)) = got, want
        assert_lattice_close(gx, wx, "px_grad")
        assert_lattice_close(gy, wy, "py_grad")
    assert_loss_close(got, want, name)


@pytest.mark.parametrize("name", ["simple", "smoothed"])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_unpruned_loss_gradients_match_jax(rnnt_type, name):
    """Value and (am, lm) gradient of the summed loss, with a delay penalty."""
    fn, _, kw = _unpruned(name)
    jfn = getattr(frt, fn.__name__)
    am, lm, sym, bnd = loss_inputs(41, B=2, T=14, S=4, C=9)

    def jf(am_, lm_):
        return jfn(lm_, am_, jj(sym), 0, boundary=jj(bnd), rnnt_type=rnnt_type,
                   delay_penalty=0.02, reduction="sum", impl="xla", **kw)

    jv, (jga, jgl) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(*jj(am, lm))
    tam = torch.from_numpy(am).requires_grad_()
    tlm = torch.from_numpy(lm).requires_grad_()
    loss = fn(tlm, tam, tt(sym), 0, boundary=tt(bnd), rnnt_type=rnnt_type,
              delay_penalty=0.02, reduction="sum", **kw)
    loss.backward()
    assert_loss_close(loss.detach(), np.asarray(jv), "loss")
    assert_lattice_close(tam.grad, jga, "d am")
    assert_lattice_close(tlm.grad, jgl, "d lm")


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_pruned_simple_matches_jax(rnnt_type):
    """rnnt_loss_pruned_simple on the same ranges (the JAX pipeline's), so
    no range near-tie can differ: values and (am, lm) gradients."""
    am, lm, sym, bnd = loss_inputs(42, B=3, T=15, S=5, C=10)
    _, _, r_j = _jax_loss(am, lm, sym, bnd, 3, rnnt_type=rnnt_type, reduction="none")
    rng_np = np.asarray(r_j)

    def jf(am_, lm_):
        return frt.rnnt_loss_pruned_simple(lm_, am_, jj(sym), jj(rng_np), 0, jj(bnd),
                                           rnnt_type=rnnt_type, delay_penalty=0.01,
                                           reduction="sum", impl="xla")

    jv, (jga, jgl) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(*jj(am, lm))
    tam = torch.from_numpy(am).requires_grad_()
    tlm = torch.from_numpy(lm).requires_grad_()
    loss = ft.rnnt_loss_pruned_simple(tlm, tam, tt(sym), tt(rng_np), 0, tt(bnd),
                                      rnnt_type=rnnt_type, delay_penalty=0.01, reduction="sum")
    loss.backward()
    assert_loss_close(loss.detach(), np.asarray(jv), "loss")
    assert_lattice_close(tam.grad, jga, "d am")
    assert_lattice_close(tlm.grad, jgl, "d lm")


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_smoothed_pruned_matches_jax(rnnt_type, ragged):
    am, lm, sym, bnd = loss_inputs(43, B=3, T=21, S=6, C=12, ragged=ragged)
    s_t, p_t, r_t = ft.rnnt_loss_smoothed_pruned(
        *tt(lm, am, sym), 0, 3, boundary=tt(bnd), rnnt_type=rnnt_type, reduction="none"
    )
    s_j, p_j, r_j = _jax_smoothed_pruned(
        *jj(lm, am, sym), termination_symbol=0, s_range=3, boundary=jj(bnd),
        rnnt_type=rnnt_type, reduction="none", impl="xla",
    )
    assert_loss_close(s_t, s_j, "smoothed")
    agree = _agree(r_t, r_j)
    assert_loss_close(to_np(p_t)[agree], np.asarray(p_j)[agree], "pruned")


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_smoothed_pruned_gradient_matches_jax(rnnt_type):
    """Value and (am, lm) gradient of 0.5 * smoothed + pruned (the
    smoothed-training step), default scales.  The gradient needs every
    utterance's ranges to agree; these inputs have no near-tie."""
    am, lm, sym, bnd = loss_inputs(44, B=2, T=15, S=5, C=10)

    def jf(am_, lm_):
        s, p, r = frt.rnnt_loss_smoothed_pruned(lm_, am_, jj(sym), 0, 3, boundary=jj(bnd),
                                                rnnt_type=rnnt_type, reduction="sum", impl="xla")
        return 0.5 * s + p, r

    (jv, r_j), (jga, jgl) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(*jj(am, lm))
    tam = torch.from_numpy(am).requires_grad_()
    tlm = torch.from_numpy(lm).requires_grad_()
    s, p, r_t = ft.rnnt_loss_smoothed_pruned(tlm, tam, tt(sym), 0, 3, boundary=tt(bnd),
                                             rnnt_type=rnnt_type, reduction="sum")
    np.testing.assert_array_equal(to_np(r_t), np.asarray(r_j))
    loss = 0.5 * s + p
    loss.backward()
    assert_loss_close(loss.detach(), np.asarray(jv), "loss")
    assert_lattice_close(tam.grad, jga, "d am")
    assert_lattice_close(tlm.grad, jgl, "d lm")


def test_new_losses_validate_inputs():
    am, lm, sym, bnd = loss_inputs(45, B=2, T=8, S=3, C=6)
    with pytest.raises(ValueError):
        ft.rnnt_loss_smoothed_pruned(*tt(lm, am, sym), 0, 1, boundary=tt(bnd), rnnt_type="constrained")
    with pytest.raises(ValueError):
        ft.rnnt_loss_pruned_simple(*tt(lm, am, sym), tt(np.zeros((2, 8, 1), np.int32)), 0,
                                   rnnt_type="constrained")
    with pytest.raises(ValueError):
        ft.rnnt_loss_simple(*tt(lm, am, sym), 0, rnnt_type="other")
    with pytest.raises(ValueError):
        ft.rnnt_loss_smoothed(*tt(lm, am, sym), 0, reduction="max")
    with pytest.raises(ValueError):
        ft.rnnt_loss_simple(*tt(lm, am[:, :, :5], sym), 0)
