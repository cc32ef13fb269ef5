"""The matmul precision knob (``set_matmul_precision``) of the port against
the JAX package's.

The JAX package's knob reaches only TPU contractions: on the CPU its XLA
build computes float32 at every setting (checked first, below).  The port's
plain build emulates the CUDA kernels' operand modes, so at ``"high"``
(1xTF32) and ``"default"`` (one bf16 pass) its lattice lies within the
operands' rounding bound of the JAX package's float32 lattice: both exp
operands rounded, each by at most 2^-11 (TF32, to nearest) or 2^-9 (bf16)
relative, move a product of positive terms, so D, by at most 2 * 2^-11
(< 1e-3) or 2 * 2^-9 (< 4e-3) relative, and its log by no more; a loss is
a log-sum over paths of S_b + T_b arcs each.  Tolerances:

  * px, py at ``"highest"``: the lattice tolerance (``_torch_parity``);
  * per cell at ``"high"`` / ``"default"``: 1e-3 + 1e-5 / 4e-3 + 1e-5;
  * per utterance loss: (S_b + T_b) times that bound, plus the loss
    tolerance;
  * the emulation against a numpy model of the kernels' rounding (``ml_dtypes``
    bf16 or the TF32 bit rule, products in float64): 1e-5;
  * gradients at every setting: 1e-2 of max |JAX|.

Both packages' knobs are process globals (and xdist workers run a file's
tests in one process), so a fixture sets both back to ``"highest"`` after
each test.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu.ops import lattice as jlat
from fast_rnnt_tpu.ops.losses import rnnt_loss_simple as jrnnt_loss_simple
from fast_rnnt_tpu_torch.ops import lattice as tlat
from fast_rnnt_tpu_torch.ops.kernels import latbuild

from ._torch_parity import LOSS_ATOL, assert_lattice_close, jj, loss_inputs, to_np, tt

TYPES = ["regular", "modified"]
LEVELS = ["highest", "high", "default"]
# per-cell bound of the rounded levels (see the module docstring)
BOUND = {"highest": 0.0, "high": 1e-3, "default": 4e-3}


@pytest.fixture(autouse=True)
def restore_precision():
    yield
    tlat.set_matmul_precision("highest")
    jlat.set_matmul_precision("highest")


def _jax_rows(lm, am, sym, bnd, rnnt_type):
    return jlat.get_rnnt_logprobs_rows(*jj(lm, am, sym), 0, rnnt_type, jj(bnd), impl="xla")


def _finite_max_diff(got, want):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    return np.abs(got[fin] - want[fin]).max()


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_jax_on_the_cpu_ignores_the_knob(rnnt_type):
    am, lm, sym, bnd = loss_inputs(60, B=3, T=14, S=6, C=24)
    jlat.set_matmul_precision("default")
    px_d, py_d = _jax_rows(lm, am, sym, bnd, rnnt_type)
    jlat.set_matmul_precision("highest")
    px_h, py_h = _jax_rows(lm, am, sym, bnd, rnnt_type)
    assert _finite_max_diff(px_d, px_h) <= 1e-6
    assert _finite_max_diff(py_d, py_h) <= 1e-6


@pytest.mark.parametrize("rnnt_type", TYPES)
def test_highest_matches_jax(rnnt_type):
    am, lm, sym, bnd = loss_inputs(61, B=3, T=14, S=6, C=24)
    assert tlat.matmul_precision() == "highest"
    px_t, py_t = tlat.get_rnnt_logprobs_rows(*tt(lm, am, sym), 0, rnnt_type, tt(bnd))
    px_j, py_j = _jax_rows(lm, am, sym, bnd, rnnt_type)
    assert_lattice_close(px_t, px_j, "px")
    assert_lattice_close(py_t, py_j, "py")


@pytest.mark.parametrize("rnnt_type", TYPES)
@pytest.mark.parametrize("level", ["high", "default"])
def test_rounded_levels_lie_within_the_bound_of_jax(level, rnnt_type):
    am, lm, sym, bnd = loss_inputs(62, B=3, T=16, S=7, C=32)
    px_j, py_j = _jax_rows(lm, am, sym, bnd, rnnt_type)
    tlat.set_matmul_precision(level)
    px_t, py_t = tlat.get_rnnt_logprobs_rows(*tt(lm, am, sym), 0, rnnt_type, tt(bnd))
    d = max(_finite_max_diff(px_t, px_j), _finite_max_diff(py_t, py_j))
    assert d <= BOUND[level] + 1e-5, d
    if level == "default":
        assert d > 1e-5  # the switch acts
    loss_t = ft.rnnt_loss_simple(*tt(lm, am, sym), 0, tt(bnd), rnnt_type, reduction="none")
    loss_j = jrnnt_loss_simple(*jj(lm, am, sym), 0, jj(bnd), rnnt_type, reduction="none", impl="xla")
    arcs = bnd[:, 2] + bnd[:, 3]
    dl = np.abs(to_np(loss_t).astype(np.float64) - np.asarray(loss_j, np.float64))
    assert (dl <= arcs * BOUND[level] + LOSS_ATOL).all(), (dl, arcs * BOUND[level])


def _tf32_np(x):
    """float32 -> TF32 as cvt.rna rounds: to nearest, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def _round_np(x, level):
    if level == "default":
        return x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return _tf32_np(x) if level == "high" else x


@pytest.mark.parametrize("level", LEVELS)
def test_emulation_matches_a_numpy_model(level):
    """The plain build's normalizers and the smoothed build's am-only
    denominator against numpy: the same float32 exps, rounded by
    ``ml_dtypes`` or the TF32 bit rule, their products summed in float64."""
    am, lm, sym, bnd = loss_inputs(63, B=2, T=12, S=5, C=29)
    uni = np.random.default_rng(64).dirichlet(np.ones(29)).astype(np.float32)
    tam, tlm = tt(am, lm)
    amp = torch.exp(tam - tam.amax(2, keepdim=True)).numpy()
    lmp = torch.exp(tlm - tlm.amax(2, keepdim=True)).numpy()
    ra, rl, ru = (_round_np(x, level).astype(np.float64) for x in (amp, lmp, uni))
    want = np.log(np.einsum("bsc,btc->sbt", rl, ra) + np.finfo(np.float32).tiny)
    want += lm.max(2).T[:, :, None] + am.max(2)[None]
    tlat.set_matmul_precision(level)
    got = tlat._normalizers_plain(tlm, tam, level)[0]
    np.testing.assert_allclose(to_np(got), want, atol=1e-5, rtol=0)
    te = torch.full((2,), -1, dtype=torch.int32)
    normd = latbuild.lattice_rows_parts_plain(tlm, tam, tt(sym), te, torch.from_numpy(uni), 0, True)[2]
    want_nd = want - (np.log(np.einsum("btc,c->bt", ra, ru)) + am.max(2))[None]
    np.testing.assert_allclose(to_np(normd), want_nd, atol=1e-5, rtol=0)


def test_tf32_rule_rounds_ties_away_from_zero():
    one = 1.0
    x = torch.tensor([one, one + 2**-11, one + 2**-10 + 2**-11, -one - 2**-11, one + 2**-11 - 2**-23,
                      3.0e-3, 0.0])
    got = tlat._round_tf32(x)
    assert got.tolist()[:5] == [one, one + 2**-10, one + 2**-9, -one - 2**-10, one]
    np.testing.assert_array_equal(got.numpy(), _tf32_np(x.numpy()))
    assert got[5] == _tf32_np(np.float32(3.0e-3)) and got[6] == 0.0


@pytest.mark.parametrize("smoothed", [False, True], ids=["simple", "smoothed"])
@pytest.mark.parametrize("level", LEVELS)
def test_gradients_stay_near_jax(level, smoothed):
    am, lm, sym, bnd = loss_inputs(65, B=3, T=13, S=5, C=20)
    rng = np.random.default_rng(66)

    def jbuild(l, a):
        if smoothed:
            return jlat.get_rnnt_logprobs_smoothed_rows(l, a, jj(sym), 0, 0.2, 0.1, jj(bnd), impl="xla")
        return jlat.get_rnnt_logprobs_rows(l, a, jj(sym), 0, "regular", jj(bnd), impl="xla")

    px_j, py_j = jbuild(*jj(lm, am))
    cpx = np.where(np.isneginf(np.asarray(px_j)), 0.0, rng.normal(size=px_j.shape)).astype(np.float32)
    cpy = rng.normal(size=py_j.shape).astype(np.float32)

    def f(l, a):
        px, py = jbuild(l, a)
        return jnp.sum(jnp.where(cpx != 0, px, 0.0) * cpx) + jnp.sum(py * cpy)

    want = jax.grad(f, argnums=(0, 1))(*jj(lm, am))
    tlat.set_matmul_precision(level)
    tlm, tam = torch.from_numpy(lm).requires_grad_(), torch.from_numpy(am).requires_grad_()
    if smoothed:
        px, py = tlat.get_rnnt_logprobs_smoothed_rows(tlm, tam, tt(sym), 0, 0.2, 0.1, tt(bnd))
    else:
        px, py = tlat.get_rnnt_logprobs_rows(tlm, tam, tt(sym), 0, "regular", tt(bnd))
    px = torch.where(torch.from_numpy(cpx) != 0, px, 0.0)
    got = torch.autograd.grad([px, py], [tlm, tam], [torch.from_numpy(cpx), torch.from_numpy(cpy)])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(to_np(g) - w).max() <= 1e-2 * np.abs(w).max()


@pytest.mark.parametrize("rnnt_type", TYPES)
@pytest.mark.parametrize("level", ["high", "default"])
def test_smoothed_rows_within_the_bound(level, rnnt_type):
    """The smoothed lattice mixes the combined lattice (its normalizer D)
    and the am-only one (the unigram product), each moved by at most the
    bound; the interpolation weights sum to 1."""
    am, lm, sym, bnd = loss_inputs(67, B=3, T=15, S=6, C=26)
    want = jlat.get_rnnt_logprobs_smoothed_rows(*jj(lm, am, sym), 0, 0.2, 0.1, jj(bnd), rnnt_type,
                                                impl="xla")
    tlat.set_matmul_precision(level)
    got = tlat.get_rnnt_logprobs_smoothed_rows(*tt(lm, am, sym), 0, 0.2, 0.1, tt(bnd), rnnt_type)
    d = max(_finite_max_diff(g, w) for g, w in zip(got, want))
    assert 0.0 < d <= BOUND[level] + 1e-5, d
    # the kernel route's plain side (the smoothed build's autograd function)
    # rounds as the plain smoothed build does
    comp = latbuild.lattice_rows_smoothed(*tt(lm, am, sym), 0, 0.2, 0.1, tt(bnd), rnnt_type)
    for g, c in zip(got, comp):
        assert_lattice_close(c, g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("smoothed", [False, True], ids=["simple", "smoothed"])
def test_narrow_inputs_ignore_the_knob(dtype, smoothed):
    am, lm, sym, bnd = loss_inputs(68, B=2, T=12, S=5, C=18)
    tlm, tam = torch.from_numpy(lm).to(dtype), torch.from_numpy(am).to(dtype)
    out = {}
    for level in LEVELS:
        tlat.set_matmul_precision(level)
        if smoothed:
            out[level] = tlat.get_rnnt_logprobs_smoothed_rows(tlm, tam, tt(sym), 0, 0.2, 0.1, tt(bnd))
        else:
            out[level] = tlat.get_rnnt_logprobs_rows(tlm, tam, tt(sym), 0, "regular", tt(bnd))
    for level in ("high", "default"):
        for a, b in zip(out[level], out["highest"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name,level", [
    ("default", "default"), ("bfloat16", "default"), ("high", "high"),
    ("tensorfloat32", "high"), ("highest", "highest"), ("float32", "highest"),
])
def test_names(name, level):
    ft.set_matmul_precision(name)
    assert ft.matmul_precision() == level == tlat.matmul_precision()
    # the kernels' operand mode for float32 lm and am, and bf16's one mode
    am = torch.zeros(1, 2, 3)
    assert latbuild._prec_code(am, None) == tlat._PREC_CODE[level]
    assert latbuild._prec_code(am.bfloat16(), None) == 2
    assert latbuild._prec_code(am.half(), None) == 2


@pytest.mark.parametrize("bad", ["HIGHEST", "fastest", "", None, 2])
def test_bad_names_raise(bad):
    ft.set_matmul_precision("high")
    with pytest.raises(ValueError, match="precision"):
        ft.set_matmul_precision(bad)
    assert ft.matmul_precision() == "high"


def test_round_exps_needs_the_card():
    x = torch.zeros(2, 3)
    with pytest.raises(TypeError, match="CUDA"):
        latbuild.round_exps(x, x.amax(1), 1)
