"""Port parity: the real-joiner losses (rnnt_loss, rnnt_loss_pruned,
rnnt_loss_chunked) and the two-stage recipe with a joiner that is not
additive, vs the JAX package on the same numpy inputs.  Stage 2 of the
port always gets the JAX package's ranges, so that a near-tie window flip
(ROADMAP Queue 3) cannot make the two sides prune differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_rnnt_tpu as jft
import fast_rnnt_tpu_torch as ft

from ._torch_parity import (
    BF16_LOSS_ATOL,
    BF16_LOSS_RTOL,
    assert_close,
    assert_lattice_close,
    assert_loss_close,
    jj,
    loss_inputs,
    to_np,
    tt,
)

RNNT_TYPES = ["regular", "modified", "constrained"]
# (reduction, delay_penalty) pairs: each reduction once, the penalty on two
CASES = [("mean", 0.0), ("sum", 0.3), ("none", 0.1)]


def _jax_ranges(lm, am, sym, bnd, s_range, rnnt_type="regular"):
    _, (gx, gy) = jft.rnnt_loss_simple(
        *jj(lm, am, sym), 0, jj(bnd), rnnt_type=rnnt_type, reduction="sum", calc_gradients=True
    )
    return np.asarray(jft.get_rnnt_prune_ranges(gx, gy, jj(bnd), s_range))


@pytest.mark.parametrize("case", CASES, ids=[f"{r}-dp{d}" for r, d in CASES])
@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_rnnt_loss_matches_jax(rnnt_type, case):
    """The unpruned loss of full logits, and its gradient w.r.t. them."""
    reduction, dp = case
    am, lm, sym, bnd = loss_inputs(1, B=3, T=9, S=4, C=10)
    logits = (np.tanh(am[:, :, None, :] + lm[:, None, :, :]) * 3.0).astype(np.float32)

    def jf(lg):
        return jft.rnnt_loss(lg, jj(sym), 0, jj(bnd), rnnt_type, dp, reduction)

    want = jf(jj(logits))
    jg = jax.grad(lambda lg: jnp.sum(jf(lg)))(jj(logits))
    tl = tt(logits).requires_grad_()
    got = ft.rnnt_loss(tl, tt(sym), 0, tt(bnd), rnnt_type, dp, reduction)
    got.sum().backward()
    assert_loss_close(got, want, "loss")
    assert_lattice_close(tl.grad, jg, "d logits")


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_rnnt_loss_calc_gradients_and_additive_joiner(rnnt_type):
    """calc_gradients occupancies vs the JAX package's; with an additive
    joiner the full-logits loss equals the simple loss."""
    am, lm, sym, bnd = loss_inputs(2, B=3, T=9, S=4, C=10)
    logits = am[:, :, None, :] + lm[:, None, :, :]
    loss_t, (gx_t, gy_t) = ft.rnnt_loss(
        *tt(logits, sym), 0, tt(bnd), rnnt_type, reduction="none", calc_gradients=True
    )
    loss_j, (gx_j, gy_j) = jft.rnnt_loss(
        *jj(logits, sym), 0, jj(bnd), rnnt_type, reduction="none", calc_gradients=True
    )
    assert_loss_close(loss_t, loss_j, "loss")
    assert_lattice_close(gx_t, gx_j, "px_grad")
    assert_lattice_close(gy_t, gy_j, "py_grad")
    simple = ft.rnnt_loss_simple(*tt(lm, am, sym), 0, tt(bnd), rnnt_type, reduction="none")
    assert_loss_close(loss_t, simple, "full joiner vs simple")


@pytest.mark.parametrize("case", CASES, ids=[f"{r}-dp{d}" for r, d in CASES])
@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_rnnt_loss_pruned_matches_jax(rnnt_type, case):
    """do_rnnt_pruning -> additive joiner -> rnnt_loss_pruned on the JAX
    ranges: the loss and its gradient w.r.t. (am, lm)."""
    reduction, dp = case
    am, lm, sym, bnd = loss_inputs(3, B=3, T=12, S=5, C=10)
    ranges = _jax_ranges(lm, am, sym, bnd, 3, rnnt_type)

    def jf(am_, lm_):
        am_p, lm_p = jft.do_rnnt_pruning(am_, lm_, jj(ranges))
        return jft.rnnt_loss_pruned(am_p + lm_p, jj(sym), jj(ranges), 0, jj(bnd), rnnt_type, dp,
                                    reduction)

    want = jf(*jj(am, lm))
    jg_am, jg_lm = jax.grad(lambda a, l: jnp.sum(jf(a, l)), argnums=(0, 1))(*jj(am, lm))
    tam, tlm = tt(am).requires_grad_(), tt(lm).requires_grad_()
    am_p, lm_p = ft.do_rnnt_pruning(tam, tlm, tt(ranges))
    got = ft.rnnt_loss_pruned(am_p + lm_p, *tt(sym, ranges), 0, tt(bnd), rnnt_type, dp, reduction)
    got.sum().backward()
    assert_loss_close(got, want, "loss")
    assert_lattice_close(tam.grad, jg_am, "d am")
    assert_lattice_close(tlm.grad, jg_lm, "d lm")


def test_rnnt_loss_pruned_equals_band_native_loss():
    """With an additive joiner the materialized pruned loss equals
    rnnt_loss_pruned_simple (tests/test_losses.py:184)."""
    am, lm, sym, bnd = loss_inputs(4, B=3, T=12, S=5, C=10)
    ranges = tt(_jax_ranges(lm, am, sym, bnd, 3))
    am_p, lm_p = ft.do_rnnt_pruning(*tt(am, lm), ranges)
    a = ft.rnnt_loss_pruned(am_p + lm_p, tt(sym), ranges, 0, tt(bnd), reduction="none")
    b = ft.rnnt_loss_pruned_simple(*tt(lm, am, sym), ranges, 0, tt(bnd), reduction="none")
    assert_loss_close(a, b)


def _joiner_inputs(seed, B=2, T=11, S=4, C=12, D=8):
    rng = np.random.default_rng(seed)
    am = rng.normal(size=(B, T, D)).astype(np.float32)
    lm = rng.normal(size=(B, S + 1, D)).astype(np.float32)
    w = (rng.normal(size=(D, C)) * 0.5).astype(np.float32)
    sym = rng.integers(1, C, size=(B, S)).astype(np.int32)
    bnd = np.array([[0, 0, S, T], [0, 0, S - 1, T - 3]], np.int32)
    return am, lm, w, sym, bnd


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_rnnt_loss_chunked_matches_jax(rnnt_type):
    """The chunked loss of a tanh joiner (T not a multiple of the chunk):
    loss and gradients w.r.t. the pre-joiner features and the joiner's
    weight, vs the JAX package's chunked loss."""
    am, lm, w, sym, bnd = _joiner_inputs(5)

    def jf(am_, lm_, w_):
        joiner = lambda a, l: jnp.tanh(a[:, :, None, :] + l[:, None, :, :]) @ w_  # noqa: E731
        return jft.rnnt_loss_chunked(joiner, am_, lm_, jj(sym), 0, jj(bnd), rnnt_type, 0.2,
                                     "sum", chunk=4)

    want, jgs = jax.value_and_grad(jf, argnums=(0, 1, 2))(*jj(am, lm, w))
    tam, tlm, tw = (tt(x).requires_grad_() for x in (am, lm, w))
    joiner = lambda a, l: torch.tanh(a[:, :, None, :] + l[:, None, :, :]) @ tw  # noqa: E731
    got = ft.rnnt_loss_chunked(joiner, tam, tlm, tt(sym), 0, tt(bnd), rnnt_type, 0.2, "sum",
                               chunk=4)
    got.backward()
    assert_loss_close(got, want, "loss")
    for g, jg, what in zip((tam.grad, tlm.grad, tw.grad), jgs, ("d am", "d lm", "d w")):
        assert_lattice_close(g, jg, what)


def test_rnnt_loss_chunked_calc_gradients_equals_materialized():
    am, lm, w, sym, bnd = _joiner_inputs(6)
    joiner = lambda a, l: torch.tanh(a[:, :, None, :] + l[:, None, :, :]) @ tt(w)  # noqa: E731
    a = ft.rnnt_loss_chunked(joiner, *tt(am, lm, sym), 0, tt(bnd), reduction="none", chunk=3,
                             calc_gradients=True)
    b = ft.rnnt_loss(joiner(*tt(am, lm)), tt(sym), 0, tt(bnd), reduction="none",
                     calc_gradients=True)
    assert_loss_close(a[0], b[0])
    assert_lattice_close(a[1][0], b[1][0], "px_grad")
    assert_lattice_close(a[1][1], b[1][1], "py_grad")


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_recipe_with_nonadditive_joiner_matches_jax_grad(rnnt_type):
    """The recipe a real joiner trains with: simple loss with occupancies,
    ranges (the JAX package's, fed to both), do_rnnt_pruning, the joiner
    ``tanh(am_p + lm_p) @ W`` (W made in numpy, given to both), and
    rnnt_loss_pruned; the value and gradient of ``0.5*simple + pruned``
    w.r.t. (am, lm, W) vs jax.value_and_grad."""
    am, lm, sym, bnd = loss_inputs(7, B=3, T=12, S=5, C=10)
    w = (np.random.default_rng(8).normal(size=(10, 10)) * 0.4).astype(np.float32)
    ranges = _jax_ranges(lm, am, sym, bnd, 3, rnnt_type)

    def jf(am_, lm_, w_):
        simple, _ = jft.rnnt_loss_simple(lm_, am_, jj(sym), 0, jj(bnd), rnnt_type,
                                         reduction="sum", calc_gradients=True)
        am_p, lm_p = jft.do_rnnt_pruning(am_, lm_, jj(ranges))
        logits = jnp.tanh(am_p + lm_p) @ w_
        pruned = jft.rnnt_loss_pruned(logits, jj(sym), jj(ranges), 0, jj(bnd), rnnt_type,
                                      reduction="sum")
        return 0.5 * simple + pruned

    want, jgs = jax.value_and_grad(jf, argnums=(0, 1, 2))(*jj(am, lm, w))
    tam, tlm, tw = (tt(x).requires_grad_() for x in (am, lm, w))
    simple, (gx, gy) = ft.rnnt_loss_simple(tlm, tam, tt(sym), 0, tt(bnd), rnnt_type,
                                           reduction="sum", calc_gradients=True)
    np.testing.assert_array_equal(to_np(ft.get_rnnt_prune_ranges(gx, gy, tt(bnd), 3)), ranges)
    am_p, lm_p = ft.do_rnnt_pruning(tam, tlm, tt(ranges))
    logits = torch.tanh(am_p + lm_p) @ tw
    pruned = ft.rnnt_loss_pruned(logits, *tt(sym, ranges), 0, tt(bnd), rnnt_type, reduction="sum")
    got = 0.5 * simple + pruned
    got.backward()
    assert_loss_close(got, want, "loss")
    for g, jg, what in zip((tam.grad, tlm.grad, tw.grad), jgs, ("d am", "d lm", "d W")):
        assert_lattice_close(g, jg, what)


def test_recipe_bf16_logits_within_bf16_bound():
    """The mixed-precision form: pruned logits in bf16 (a bf16 lattice in
    the recursion) stay within the JAX package's bf16 bound of the float32
    recipe, and the bf16 losses agree with the JAX package's bf16 losses."""
    am, lm, sym, bnd = loss_inputs(9, B=3, T=12, S=5, C=10)
    ranges = _jax_ranges(lm, am, sym, bnd, 3)
    am_p, lm_p = ft.do_rnnt_pruning(*tt(am, lm, ranges))
    f32 = ft.rnnt_loss_pruned(am_p + lm_p, *tt(sym, ranges), 0, tt(bnd), reduction="none")
    lg16 = (am_p + lm_p).bfloat16().requires_grad_()
    bf16 = ft.rnnt_loss_pruned(lg16, *tt(sym, ranges), 0, tt(bnd), reduction="none")
    bf16.sum().backward()
    assert bf16.dtype == torch.float32 and lg16.grad.dtype == torch.bfloat16
    assert torch.isfinite(bf16).all() and torch.isfinite(lg16.grad.float()).all()
    assert_close(bf16, f32, BF16_LOSS_ATOL, BF16_LOSS_RTOL, "bf16 vs f32")
    jam_p, jlm_p = jft.do_rnnt_pruning(*jj(am, lm, ranges))
    want = jft.rnnt_loss_pruned((jam_p + jlm_p).astype(jnp.bfloat16), *jj(sym, ranges), 0,
                                jj(bnd), reduction="none")
    assert_close(bf16, want, BF16_LOSS_ATOL, BF16_LOSS_RTOL, "bf16 vs JAX bf16")


def test_constrained_s_range_1_raises():
    """A width-1 band is infeasible for constrained RNN-T: every path of the
    port raises, as the JAX package does."""
    am, lm, sym, bnd = tt(*loss_inputs(10, B=2, T=12, S=4, C=8))
    ranges = torch.zeros((2, 12, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="constrained.*s_range >= 2"):
        ft.rnnt_loss_simple_pruned(lm, am, sym, 0, 1, bnd, rnnt_type="constrained")
    with pytest.raises(ValueError, match="constrained.*s_range >= 2"):
        ft.rnnt_loss_pruned_simple(lm, am, sym, ranges, 0, bnd, "constrained")
    am_p, lm_p = ft.do_rnnt_pruning(am, lm, ranges)
    with pytest.raises(ValueError, match="constrained.*s_range >= 2"):
        ft.rnnt_loss_pruned(am_p + lm_p, sym, ranges, 0, bnd, "constrained")
    with pytest.raises(ValueError, match="constrained.*s_range >= 2"):
        ft.get_rnnt_logprobs_pruned_simple(lm, am, sym, ranges, 0, bnd, "constrained")
    # modified stays legal at s_range = 1
    out = ft.rnnt_loss_simple_pruned(lm, am, sym, 0, 1, bnd, rnnt_type="modified", reduction="none")
    assert torch.isfinite(out[0]).all()


def test_rnnt_loss_bf16_logits_matches_jax():
    """bf16 full logits make a float32 px and a bf16 py, as in the JAX
    package; the recursion stores both in float32 (the wider of the two)
    and the loss stays within the bf16 bound of the JAX package's."""
    am, lm, sym, bnd = loss_inputs(11, B=3, T=9, S=4, C=10)
    logits = (np.tanh(am[:, :, None, :] + lm[:, None, :, :]) * 3.0).astype(np.float32)
    lg16 = tt(logits).bfloat16()
    px, py = ft.get_rnnt_logprobs_joint(lg16, tt(sym), 0, tt(bnd))
    assert px.dtype == torch.float32 and py.dtype == torch.bfloat16
    loss, (gx, gy) = ft.rnnt_loss(lg16, tt(sym), 0, tt(bnd), reduction="none", calc_gradients=True)
    assert gx.dtype == torch.float32 and gy.dtype == torch.float32
    want = jft.rnnt_loss(jnp.asarray(logits).astype(jnp.bfloat16), jj(sym), 0, jj(bnd),
                         reduction="none")
    assert_close(loss, want, BF16_LOSS_ATOL, BF16_LOSS_RTOL, "bf16 logits")
