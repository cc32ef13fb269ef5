"""The port's parity gate (``fast_rnnt_tpu_torch/utils/parity.py``) and the
route switches it uses (``recursion.set_default_impl``,
``lattice.set_lattice_build_impl``), on the CPU.

The gate runs on tests/test_parity_gate.py's inputs (B=4, T=64, S=12, C=32,
s_range=4), made in numpy, beside the JAX gate run as that file runs it
(the Pallas kernels in interpret mode as the process default).  On CPU
tensors both of the port's routes are the plain versions, so its
kernel-vs-plain metrics are exactly 0; the metrics that measure the same
function on both sides are held to each other:

  * ``roundtrip_max_abs_err``: within 1e-4 absolute.  Both are float32
    round-off of a unit seed carried over the T + S arcs of a path, summed
    in another order by each recursion (measured: 3.2e-5 and 4.3e-5);
  * the golden errors: within 1e-6 absolute, a float32 ulp of the O(10)
    scores, since both recursions are compared with the same float64
    enumeration (measured: equal);
  * ``bf16_loss_rel_err`` and ``bf16_occupancy_rel_err``: within 1e-3 of
    each other relative; both round the same float32 lattice to bf16
    (measured: 1e-5 apart and equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu.ops import recursion as jrec
from fast_rnnt_tpu.ops.kernels import register
from fast_rnnt_tpu.utils.parity import enforce_parity as jenforce_parity
from fast_rnnt_tpu.utils.parity import onchip_parity_gate as jonchip_parity_gate
from fast_rnnt_tpu_torch.ops import lattice, recursion
from fast_rnnt_tpu_torch.ops.kernels import latbuild, ranges, wavefront
from fast_rnnt_tpu_torch.utils import parity
from fast_rnnt_tpu_torch.utils.parity import (
    MINIMUMS,
    TOLERANCES,
    enforce_parity,
    onchip_parity_gate,
)

from ._torch_parity import loss_inputs, tt

S_RANGE = 4
ROUNDTRIP_ATOL = 1e-4
GOLDEN_ATOL = 1e-6
BF16_METRIC_RTOL = 1e-3


def gate_inputs():
    """tests/test_parity_gate.py's inputs."""
    rng = np.random.default_rng(0)
    B, T, S, C = 4, 64, 12, 32
    am = rng.normal(size=(B, T, C)).astype(np.float32)
    lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
    symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
    t_end = np.clip(rng.integers(T // 2, T + 1, size=B), S + 2, T).astype(np.int32)
    s_end = np.clip(rng.integers(S // 2, S + 1, size=B), 2, S).astype(np.int32)
    boundary = np.stack([np.zeros(B, np.int32), np.zeros(B, np.int32), s_end, t_end], 1)
    return am, lm, symbols, boundary


@pytest.fixture
def restore_switches(monkeypatch):
    """The switches' values at the start, restored after the test."""
    monkeypatch.setattr(recursion, "_DEFAULT_IMPL", recursion._DEFAULT_IMPL)
    monkeypatch.setattr(lattice, "_LATTICE_BUILD_IMPL", lattice._LATTICE_BUILD_IMPL)


def launches():
    return [dict(m.LAUNCHES) for m in (wavefront, latbuild, ranges)]


def test_gate_matches_the_jax_gate():
    am, lm, symbols, boundary = gate_inputs()
    before = launches()
    got = onchip_parity_gate(*tt(am, lm, symbols, boundary), s_range=S_RANGE)
    assert launches() == before  # CPU tensors: the plain versions only

    register(default=False, interpret=True)
    old = jrec._DEFAULT_IMPL
    try:
        jrec._DEFAULT_IMPL = "pallas"
        want = jonchip_parity_gate(*(jnp.asarray(x) for x in (am, lm, symbols, boundary)),
                                   s_range=S_RANGE)
    finally:
        jrec._DEFAULT_IMPL = old

    assert set(TOLERANCES) | set(MINIMUMS) <= set(got)
    enforce_parity(got)
    jenforce_parity(want)
    assert got["golden_cases"] == want["golden_cases"] == 5
    # both routes are the plain versions on the CPU
    assert got["range_agree_frac"] == 1.0 and got["range_flips"] == 0
    assert got["kernel_vs_plain_loss_rel_err"] == got["kernel_vs_plain_grad_rel_err"] == 0.0
    assert got["range_flip_max_gap"] == 0.0
    assert abs(got["roundtrip_max_abs_err"] - want["roundtrip_max_abs_err"]) <= ROUNDTRIP_ATOL
    for k in ("golden_scores_max_abs_err", "golden_grads_max_abs_err"):
        assert abs(got[k] - want[k]) <= GOLDEN_ATOL, k
    for k in ("bf16_loss_rel_err", "bf16_occupancy_rel_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=BF16_METRIC_RTOL, err_msg=k)


def test_gate_fails_on_scaled_occupancies(monkeypatch, restore_switches):
    """The plain fused recursion's occupancies scaled by 1.01: the golden
    gradients leave their limit and enforce_parity names them."""
    plain = wavefront.fused_rows_plain

    def scaled(*args):
        scores, gx, gy = plain(*args)
        return scores, 1.01 * gx, 1.01 * gy

    monkeypatch.setattr(wavefront, "fused_rows_plain", scaled)
    got = onchip_parity_gate(*tt(*gate_inputs()), s_range=S_RANGE)
    assert got["golden_grads_max_abs_err"] > TOLERANCES["golden_grads_max_abs_err"]
    with pytest.raises(FloatingPointError, match="golden_grads_max_abs_err"):
        enforce_parity(got)


def test_enforce_parity_fails_loudly():
    good = {**{k: 0.0 for k in TOLERANCES}, **{k: 1.0 for k in MINIMUMS}}
    enforce_parity(good)
    bad = dict(good, golden_grads_max_abs_err=1.0)
    with pytest.raises(FloatingPointError, match="golden_grads_max_abs_err"):
        enforce_parity(bad)
    nan = dict(good, roundtrip_max_abs_err=float("nan"))
    with pytest.raises(FloatingPointError, match="roundtrip"):
        enforce_parity(nan)
    low = dict(good, range_agree_frac=0.4)
    with pytest.raises(FloatingPointError, match="range_agree_frac"):
        enforce_parity(low)
    nan_min = dict(good, range_agree_frac=float("nan"))
    with pytest.raises(FloatingPointError, match="range_agree_frac"):
        enforce_parity(nan_min)
    gap = dict(good, range_flip_max_gap=2e-3)
    with pytest.raises(FloatingPointError, match="range_flip_max_gap"):
        enforce_parity(gap)


def test_tolerances_keep_the_jax_values():
    from fast_rnnt_tpu.utils.parity import MINIMUMS as JMINIMUMS
    from fast_rnnt_tpu.utils.parity import TOLERANCES as JTOLERANCES

    renamed = {k.replace("kernel_vs_plain", "fused_vs_xla"): v for k, v in TOLERANCES.items()
               if k != "range_flip_max_gap"}
    assert renamed == JTOLERANCES
    assert MINIMUMS == JMINIMUMS
    assert TOLERANCES["range_flip_max_gap"] == 1e-3


# --- the route switches ----------------------------------------------------

def test_switch_defaults():
    assert recursion._DEFAULT_IMPL is None
    assert lattice._LATTICE_BUILD_IMPL == "auto"
    assert ft.set_lattice_build_impl is lattice.set_lattice_build_impl
    assert ft.__version__ == "0.1.0"


def _simple_pruned(loss_fn):
    am, lm, sym, bnd = loss_inputs(31, B=3, T=12, S=5, C=9)
    tam, tlm = tt(am).requires_grad_(), tt(lm).requires_grad_()
    s, p, r = loss_fn(tlm, tam, tt(sym), 0, 3, boundary=tt(bnd), reduction="none")
    g = torch.autograd.grad(s.sum() + p.sum(), (tam, tlm))
    return s.detach(), p.detach(), r, *g


@pytest.mark.parametrize("loss_fn", [ft.rnnt_loss_simple_pruned, ft.rnnt_loss_smoothed_pruned],
                         ids=["simple", "smoothed"])
def test_plain_switch_is_bit_identical_on_cpu(restore_switches, loss_fn):
    want = _simple_pruned(loss_fn)
    before = launches()
    recursion.set_default_impl("plain")
    lattice.set_lattice_build_impl("plain")
    got = _simple_pruned(loss_fn)
    assert launches() == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_switches_on_cpu_raise(restore_switches):
    am, lm, sym, bnd = tt(*loss_inputs(32, B=2, T=10, S=4, C=7))
    recursion.set_default_impl("cuda")
    with pytest.raises(ValueError, match="cuda"):
        ft.rnnt_loss_simple(lm, am, sym, 0, bnd)
    with pytest.raises(ValueError, match="cuda"):
        ranges.window_starts(torch.zeros(5, 2, 10), torch.zeros(4, 2, 11), 2, bnd, 2)
    recursion.set_default_impl(None)
    lattice.set_lattice_build_impl("kernel")
    with pytest.raises(ValueError, match="kernel"):
        ft.rnnt_loss_simple(lm, am, sym, 0, bnd)
    with pytest.raises(ValueError, match="kernel"):
        ft.rnnt_loss_smoothed(lm, am, sym, 0, boundary=bnd)


@pytest.mark.parametrize("name", ["pallas", "xla", "CUDA", "auto"])
def test_unknown_impl_raises(restore_switches, name):
    with pytest.raises(ValueError, match="impl"):
        recursion.set_default_impl(name)
    assert recursion._DEFAULT_IMPL is None


@pytest.mark.parametrize("name", ["fused", "xla", "cuda", None])
def test_unknown_build_impl_raises(restore_switches, name):
    with pytest.raises(ValueError, match="impl"):
        lattice.set_lattice_build_impl(name)
    assert lattice._LATTICE_BUILD_IMPL == "auto"


def test_backward_takes_the_forward_route(restore_switches):
    """The scores op records its route in the forward: switched to "cuda"
    between forward and backward, the CPU backward still runs plain."""
    am, lm, sym, bnd = loss_inputs(33, B=2, T=10, S=4, C=7)
    tam = tt(am).requires_grad_()
    loss = ft.rnnt_loss_simple(tt(lm), tam, tt(sym), 0, tt(bnd), reduction="sum")
    recursion.set_default_impl("cuda")
    (g,) = torch.autograd.grad(loss, tam)
    assert recursion._DEFAULT_IMPL == "cuda"  # pinned only inside the backward
    recursion.set_default_impl(None)
    tam2 = tt(am).requires_grad_()
    (want,) = torch.autograd.grad(
        ft.rnnt_loss_simple(tt(lm), tam2, tt(sym), 0, tt(bnd), reduction="sum"), tam2)
    assert torch.equal(g, want)


@pytest.mark.parametrize("raises", [False, True], ids=["passes", "raises"])
def test_gate_restores_the_switches(monkeypatch, restore_switches, raises):
    recursion.set_default_impl("plain")
    lattice.set_lattice_build_impl("plain")
    if raises:
        calls = []
        loss = parity.rnnt_loss_simple_pruned

        def fail_on_plain(*a, **k):
            calls.append(recursion._DEFAULT_IMPL)
            if recursion._DEFAULT_IMPL == "plain":
                raise RuntimeError("plain route failed")
            return loss(*a, **k)

        monkeypatch.setattr(parity, "rnnt_loss_simple_pruned", fail_on_plain)
        with pytest.raises(RuntimeError, match="plain route failed"):
            onchip_parity_gate(*tt(*gate_inputs()), s_range=S_RANGE)
        assert calls == [None, "plain"]  # the shipped route first, on the default switches
    else:
        onchip_parity_gate(*tt(*gate_inputs()), s_range=S_RANGE)
    assert recursion._DEFAULT_IMPL == "plain"
    assert lattice._LATTICE_BUILD_IMPL == "plain"
