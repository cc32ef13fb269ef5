"""The bf16-input mode (bf16 lm and am, ``lattice_dtype=bf16``: the JAX
package's mixed-precision training step, bench.py's second row) on the
port against the JAX package, float16 lm and am on the plain route, the
build kernels' input guard, and a model of the kernels' 3xTF32 products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_rnnt_tpu as frt
import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu.ops.lattice import get_rnnt_logprobs_rows as jax_rows
from fast_rnnt_tpu_torch.ops.kernels import latbuild
from fast_rnnt_tpu_torch.ops.lattice import get_rnnt_logprobs_rows

from ._torch_parity import LOSS_ATOL, LOSS_RTOL, assert_close, jj, loss_inputs, to_np, tt
from .test_torch_losses import TYPES, _agree

# bf16 gradients: each side rounds its own chain of bf16 ops (the exps'
# VJPs, the casts), so two results may sit a few bf16 steps (2^-8
# relative) apart; held to 2^-5 of the largest |gradient| (both ~1)
BF16_GRAD_TOL = 2.0**-5


def _bf16(*arrays):
    return tuple(torch.from_numpy(a).bfloat16() for a in arrays)


@pytest.mark.parametrize("seed", [14, 15])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_bf16_inputs_pipeline_matches_jax(rnnt_type, seed):
    """Losses to relative 1e-4 (the pruned one where the ranges agree) and
    the gradient of 0.5 * simple + pruned to the bf16 bound."""
    am, lm, sym, bnd = loss_inputs(seed, B=2, T=16, S=5, C=9)
    am_t, lm_t = (x.requires_grad_() for x in _bf16(am, lm))
    s_t, p_t, r_t = ft.rnnt_loss_simple_pruned(lm_t, am_t, tt(sym), 0, 3, tt(bnd), rnnt_type=rnnt_type,
                                               reduction="none", lattice_dtype=torch.bfloat16)
    am_j, lm_j = jnp.asarray(am).astype(jnp.bfloat16), jnp.asarray(lm).astype(jnp.bfloat16)
    # eager: under jit XLA fuses py's bf16 gather sum into float32 (the
    # jitted JAX pipeline differs from its eager self by ~4e-4 here); the
    # port follows the op-by-op bf16 rounding
    s_j, p_j, r_j = frt.rnnt_loss_simple_pruned(lm_j, am_j, jj(sym), 0, 3, jj(bnd), rnnt_type=rnnt_type,
                                                reduction="none", impl="xla",
                                                lattice_dtype=jnp.bfloat16)
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_j), rtol=1e-4, err_msg="simple")
    agree = _agree(r_t, r_j)
    np.testing.assert_allclose(to_np(p_t)[agree], np.asarray(p_j)[agree], rtol=1e-4, err_msg="pruned")
    if not agree.all():
        return  # the gradient needs every utterance's ranges to agree

    def jf(a, l):
        s, p, _ = frt.rnnt_loss_simple_pruned(l, a, jj(sym), 0, 3, jj(bnd), rnnt_type=rnnt_type,
                                              reduction="sum", impl="xla", lattice_dtype=jnp.bfloat16)
        return 0.5 * s + p

    _, (ga_j, gl_j) = jax.value_and_grad(jf, argnums=(0, 1))(am_j, lm_j)
    (0.5 * s_t.sum() + p_t.sum()).backward()
    assert am_t.grad.dtype == torch.bfloat16 and lm_t.grad.dtype == torch.bfloat16
    for got, want, name in ((am_t.grad, ga_j, "d am"), (lm_t.grad, gl_j, "d lm")):
        got, want = to_np(got), np.asarray(want.astype(jnp.float32))
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_GRAD_TOL, f"{name}: {err:.3e} of max"


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_plain_bf16_build_matches_jax_rows(rnnt_type):
    """The plain build on bf16 lm and am against the JAX package's XLA
    build: float32 px and py to the loss tolerance 1e-4 + 1e-5|x|."""
    am, lm, sym, bnd = loss_inputs(21, B=3, T=12, S=6, C=11)
    px, py = get_rnnt_logprobs_rows(*_bf16(lm, am), tt(sym), 2, rnnt_type, tt(bnd))
    assert px.dtype == torch.float32 and py.dtype == torch.float32
    px_j, py_j = jax_rows(jnp.asarray(lm).astype(jnp.bfloat16), jnp.asarray(am).astype(jnp.bfloat16),
                          jj(sym), 2, rnnt_type, jj(bnd), impl="xla")
    assert_close(px, px_j, LOSS_ATOL, LOSS_RTOL, "px")
    assert_close(py, py_j, LOSS_ATOL, LOSS_RTOL, "py")


def test_float32_plain_build_unchanged_by_the_bf16_contract():
    """float32 inputs take the same ops as before the bf16 mode: the plain
    build equals the einsum written out on float32 tensors, bit for bit."""
    am, lm, sym, bnd = loss_inputs(22, B=2, T=9, S=4, C=7)
    lm_t, am_t, sym_t = tt(lm, am, sym)
    px, py = get_rnnt_logprobs_rows(lm_t, am_t, sym_t, 0, "regular", tt(bnd))
    amx, lmx = am_t.amax(2, keepdim=True), lm_t.amax(2, keepdim=True)
    norm = torch.log(torch.einsum("bsc,btc->sbt", torch.exp(lm_t - lmx), torch.exp(am_t - amx))
                     + float(np.finfo(np.float32).tiny))
    norm = norm + lmx.permute(1, 0, 2) + amx.permute(2, 0, 1)
    want_py = am_t[:, :, 0][None] + lm_t[:, :, 0].t()[:, :, None] - norm
    assert torch.equal(py, want_py)
    assert px.dtype == torch.float32


@pytest.mark.parametrize("seed", [14, 15, 21])
@pytest.mark.parametrize("rnnt_type", TYPES)
def test_bf16_smoothed_losses_match_jax(rnnt_type, seed):
    """The smoothed losses on bf16 lm and am against the JAX package's eager
    XLA pipeline, to relative 1e-4 (the pruned one where the ranges agree).
    The JAX build contracts the am-only normalizer and the px gathers into
    float32, so px_am + px_lm and px_am + px_uni are float32 sums there."""
    am, lm, sym, bnd = loss_inputs(seed, B=2, T=16, S=5, C=9)
    am_t, lm_t = _bf16(am, lm)
    am_j, lm_j = jnp.asarray(am).astype(jnp.bfloat16), jnp.asarray(lm).astype(jnp.bfloat16)
    got = ft.rnnt_loss_smoothed(lm_t, am_t, tt(sym), 0, 0.2, 0.1, tt(bnd), rnnt_type,
                                reduction="none")
    want = frt.rnnt_loss_smoothed(lm_j, am_j, jj(sym), 0, 0.2, 0.1, jj(bnd), rnnt_type,
                                  reduction="none", impl="xla")
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, err_msg="smoothed")
    s_t, p_t, r_t = ft.rnnt_loss_smoothed_pruned(lm_t, am_t, tt(sym), 0, 3, 0.2, 0.1, tt(bnd),
                                                 rnnt_type, reduction="none")
    s_j, p_j, r_j = frt.rnnt_loss_smoothed_pruned(lm_j, am_j, jj(sym), 0, 3, 0.2, 0.1, jj(bnd),
                                                  rnnt_type, reduction="none", impl="xla")
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_j), rtol=1e-4, err_msg="smoothed stage")
    agree = _agree(r_t, r_j)
    np.testing.assert_allclose(to_np(p_t)[agree], np.asarray(p_j)[agree], rtol=1e-4, err_msg="pruned")


# float16 gradients: each side rounds its exps and their VJPs to float16
# (2^-11 relative), so two results may sit a few float16 steps apart; held
# to 2^-8 of the largest |gradient|
F16_GRAD_TOL = 2.0**-8


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_f16_inputs_match_jax(rnnt_type):
    """float16 lm and am on the plain route (the card casts them to float32
    for its build kernels, as the Pallas build does): the simple, pruned
    and smoothed losses against the JAX package's XLA pipeline on the same
    float16 inputs to relative 1e-4 (the pruned ones where the ranges
    agree), and the gradient of 0.5 * simple + pruned, in float16, to the
    float16 bound."""
    am, lm, sym, bnd = loss_inputs(60, B=3, T=30, S=6, C=12)
    am_t, lm_t = (torch.from_numpy(x).half().requires_grad_() for x in (am, lm))
    am_j, lm_j = jnp.asarray(am).astype(jnp.float16), jnp.asarray(lm).astype(jnp.float16)
    s_t, p_t, r_t = ft.rnnt_loss_simple_pruned(lm_t, am_t, tt(sym), 0, 3, tt(bnd), rnnt_type=rnnt_type,
                                               reduction="none")

    def jf(a, l):
        s, p, r = frt.rnnt_loss_simple_pruned(l, a, jj(sym), 0, 3, jj(bnd), rnnt_type=rnnt_type,
                                              reduction="none", impl="xla")
        return 0.5 * s.sum() + p.sum(), (s, p, r)

    (_, (s_j, p_j, r_j)), (ga_j, gl_j) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(am_j, lm_j)
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_j), rtol=1e-4, err_msg="simple")
    agree = _agree(r_t, r_j)
    np.testing.assert_allclose(to_np(p_t)[agree], np.asarray(p_j)[agree], rtol=1e-4, err_msg="pruned")
    sm_t = ft.rnnt_loss_smoothed(lm_t.detach(), am_t.detach(), tt(sym), 0, 0.2, 0.1, tt(bnd), rnnt_type,
                                 reduction="none")
    sm_j = frt.rnnt_loss_smoothed(lm_j, am_j, jj(sym), 0, 0.2, 0.1, jj(bnd), rnnt_type,
                                  reduction="none", impl="xla")
    np.testing.assert_allclose(to_np(sm_t), np.asarray(sm_j), rtol=1e-4, err_msg="smoothed")
    if not agree.all():
        return  # the gradient needs every utterance's ranges to agree
    (0.5 * s_t.sum() + p_t.sum()).backward()
    assert am_t.grad.dtype == torch.float16 and lm_t.grad.dtype == torch.float16
    for got, want, name in ((am_t.grad, ga_j, "d am"), (lm_t.grad, gl_j, "d lm")):
        got, want = to_np(got).astype(np.float32), np.asarray(want.astype(jnp.float32))
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= F16_GRAD_TOL, f"{name}: {err:.3e} of max"


def test_float32_smoothed_build_unchanged_by_the_bf16_contract():
    """float32 inputs take the same ops as before the bf16 repair: the
    plain smoothed build equals the interpolation written out on float32
    tensors, bit for bit."""
    from fast_rnnt_tpu_torch.ops import lattice as tlat

    am, lm, sym, bnd = loss_inputs(24, B=2, T=9, S=4, C=7)
    lm_t, am_t, sym_t, bnd_t = tt(lm, am, sym, bnd)
    px, py = tlat.get_rnnt_logprobs_smoothed_rows(lm_t, am_t, sym_t, 0, 0.2, 0.1, bnd_t)
    norm, amx, amp, lmx, lmp = tlat._normalizers_plain(lm_t, am_t)
    lsum = lmp.sum(dim=2, keepdim=True)
    uni = (lmp / lsum).mean(dim=(0, 1)) + float(np.finfo(np.float32).tiny)
    amonly = torch.log(torch.einsum("btc,c->bt", amp, uni))[None] + amx.permute(2, 0, 1)
    lmonly = torch.log(lsum).permute(1, 0, 2) + lmx.permute(1, 0, 2)
    px_am, px_lm = tlat._px_gathers(lm_t, am_t, sym_t)
    px_uni = torch.log(uni)[sym_t.long()].t()[:, :, None]
    pad = tlat._pad_px
    c, l, a = tlat._smoothing_scales(0.2, 0.1)
    want_px = (pad(px_am + px_lm, False) - pad(norm[:4], False, 0.0)) * c + (px_lm - lmonly[:4]) * l
    want_px = want_px + (pad(px_am + px_uni, False) - pad(amonly.expand(4, -1, -1), False, 0.0)) * a
    want_px = tlat._kill_t_end(want_px, bnd_t[:, 3])
    want_py = (am_t[:, :, 0][None] + lm_t[:, :, 0].t()[:, :, None] - norm) * c
    want_py = want_py + (lm_t[:, :, 0].t()[:, :, None] - lmonly) * l
    want_py = want_py + (am_t[:, :, 0][None] + torch.log(uni)[0] - amonly) * a
    assert px.dtype == torch.float32 and torch.equal(px, want_px)
    assert torch.equal(py, want_py)


def test_do_rnnt_pruning_bf16_lm_returns_float32():
    """lm_pruned is float32 for a bf16 or f16 lm, as the JAX package's
    float32 one-hot product gives, with the same values; am_pruned keeps
    am's dtype."""
    am, lm, sym, bnd = loss_inputs(25, B=2, T=8, S=4, C=6)
    ranges = np.minimum(np.arange(8)[None, :, None] // 2 + np.arange(3), 4).repeat(2, 0).astype(np.int32)
    am_j, lm_j = jnp.asarray(am).astype(jnp.bfloat16), jnp.asarray(lm).astype(jnp.bfloat16)
    jam_p, jlm_p = frt.do_rnnt_pruning(am_j, lm_j, jj(ranges))
    for dt in (torch.bfloat16, torch.float16):
        am_t, lm_t = torch.from_numpy(am).to(dt), torch.from_numpy(lm).to(dt)
        am_p, lm_p = ft.do_rnnt_pruning(am_t, lm_t, tt(ranges))
        assert am_p.dtype == dt and lm_p.dtype == torch.float32
        if dt == torch.bfloat16:
            assert jam_p.dtype == jnp.bfloat16 and jlm_p.dtype == jnp.float32
            np.testing.assert_array_equal(to_np(lm_p), np.asarray(jlm_p))
            np.testing.assert_array_equal(to_np(am_p), np.asarray(jam_p.astype(jnp.float32)))
    lm_p = ft.do_rnnt_pruning(*tt(am, lm, ranges))[1]
    assert lm_p.dtype == torch.float32


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_bf16_recipe_with_tanh_joiner_matches_jax(rnnt_type):
    """The recipe on bf16 am and lm: do_rnnt_pruning, the joiner
    tanh(am_p + lm_p) (summed in float32, as the JAX package's float32
    lm_p makes it; not cast), rnnt_loss_pruned with the JAX ranges; losses
    to relative 1e-4."""
    am, lm, sym, bnd = loss_inputs(26, B=3, T=12, S=5, C=10)
    am_j, lm_j = jnp.asarray(am).astype(jnp.bfloat16), jnp.asarray(lm).astype(jnp.bfloat16)
    _, (gx, gy) = frt.rnnt_loss_simple(lm_j, am_j, jj(sym), 0, jj(bnd), rnnt_type, reduction="sum",
                                       calc_gradients=True, impl="xla")
    ranges = np.asarray(frt.get_rnnt_prune_ranges(gx, gy, jj(bnd), 3))
    jam_p, jlm_p = frt.do_rnnt_pruning(am_j, lm_j, jj(ranges))
    want = frt.rnnt_loss_pruned(jnp.tanh(jam_p + jlm_p), jj(sym), jj(ranges), 0, jj(bnd), rnnt_type,
                                reduction="none", impl="xla")
    am_t, lm_t = _bf16(am, lm)
    am_p, lm_p = ft.do_rnnt_pruning(am_t, lm_t, tt(ranges))
    got = ft.rnnt_loss_pruned(torch.tanh(am_p + lm_p), tt(sym), tt(ranges), 0, tt(bnd), rnnt_type,
                              reduction="none")
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, err_msg="pruned")


def _tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest, ties
    away from zero: cvt.rna.tf32.f32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_split_product_error_at_k500():
    """The kernels' 3xTF32 product (hi = tf32(x), lo = tf32(x - hi);
    lo_a hi_b + hi_a lo_b + hi_a hi_b) on the build's operands (exps in
    (0, 1]) at K = C = 500, against float64.  The split alone (terms summed
    in float64) is within 2^-20 relative; with float32 sums, as the tensor
    cores accumulate, within 4x a plain float32 sum's own error and 2e-6
    relative, inside chip_smoke's 1e-5 on log D.  One TF32 pass (hi hi)
    misses by ~2^-12."""
    rng = np.random.default_rng(3)
    a = np.exp(rng.normal(size=(64, 500)) - 3.0).astype(np.float32)
    b = np.exp(rng.normal(size=(500, 104)) - 3.0).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    f64 = lambda x: x.astype(np.float64)  # noqa: E731
    split = f64(al) @ f64(bh) + f64(ah) @ f64(bl) + f64(ah) @ f64(bh)

    def rel(x):
        return np.abs(x - want).max() / np.abs(want).min()

    assert rel(split) < 2.0**-20
    acc = np.zeros(want.shape, np.float32)
    plain = np.zeros(want.shape, np.float32)
    for k in range(500):  # float32 accumulation, one k at a time
        acc += np.outer(al[:, k], bh[k]) + np.outer(ah[:, k], bl[k]) + np.outer(ah[:, k], bh[k])
        plain += np.outer(a[:, k], b[k])
    assert rel(acc) < min(2e-6, 4 * rel(plain))
    assert rel(f64(ah) @ f64(bh)) > 2.0**-14


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_build_wrappers_take_float32_and_bf16_only(dtype):
    am, lm, sym, bnd = loss_inputs(23, B=2, T=5, S=3, C=6)
    lm_t, am_t = torch.from_numpy(lm).to(dtype), torch.from_numpy(am).to(dtype)
    te = torch.full((2,), -1, dtype=torch.int32)
    args = (lm_t, am_t, tt(sym), te, 0)
    if dtype in (torch.float32, torch.bfloat16):
        assert latbuild._check_inputs(*args)[:4] == (2, 3, 5, 6)
        if dtype == torch.bfloat16:  # the smoothed build is float32 only
            with pytest.raises(TypeError):
                latbuild._check_inputs(*args, uni=torch.ones(6))
        return
    with pytest.raises(TypeError):
        latbuild._check_inputs(*args)
    with pytest.raises(TypeError):
        latbuild.build_fwd(*args, modified=False)
    with pytest.raises(TypeError):
        latbuild.build_bwd(*args, False, None, None, None)
    with pytest.raises(TypeError):  # mixed dtypes
        latbuild._check_inputs(lm_t.float(), am_t.bfloat16(), tt(sym), te, 0)
