"""The benchmark's plain pruned-loss reference on the CPU: the vectorised
recursion against a frozen copy of the explicit loop, and each lattice,
the ranges and the whole pipeline against the port's plain versions at
small shapes.  The test may import the port; the reference may not."""

import numpy as np
import pytest
import torch

import fast_rnnt_tpu_torch as frt
from perfbench.reference import pruned_loss as rl
from perfbench.tests._oracle_loop import mi_loop


def _boundary(rng, B, S, T):
    bnd = np.zeros((B, 4), np.int64)
    bnd[:, 2] = rng.integers(0, S + 1, size=B)
    bnd[:, 3] = rng.integers(max(1, T // 2), T + 1, size=B)
    bnd[0, 2:] = (S, T)
    return bnd


@pytest.mark.parametrize("S,T", [(0, 1), (0, 6), (1, 1), (3, 5), (6, 4), (5, 9)])
def test_recursion_equals_loop(S, T):
    rng = np.random.default_rng(100 * S + T)
    B = 3
    px = rng.normal(size=(B, S, T + 1)) - 2.0
    py = rng.normal(size=(B, S + 1, T)) - 2.0
    bnd = _boundary(rng, B, S, T)
    scores, gx, gy, _ = mi_loop(px, py, bnd)
    tpx = torch.tensor(px, requires_grad=True)
    tpy = torch.tensor(py, requires_grad=True)
    got = rl.recursion(tpx, tpy, torch.tensor(bnd))
    np.testing.assert_allclose(got.detach().numpy(), scores, rtol=1e-12, atol=1e-12)
    ggx, ggy = torch.autograd.grad(got.sum(), (tpx, tpy))
    np.testing.assert_allclose(ggx.numpy(), gx, atol=1e-12)
    np.testing.assert_allclose(ggy.numpy(), gy, atol=1e-12)


@pytest.mark.parametrize("S,T,K", [(3, 5, 2), (6, 9, 3), (9, 30, 5)])
def test_band_recursion_equals_loop(S, T, K):
    """On a band lattice (NEG outside each frame's window) the row sweep
    equals the loop, value and occupancies; windows that are no one run of
    frames a row give NaN."""
    rng = np.random.default_rng(7 * S + T)
    B = 3
    px = torch.tensor(rng.normal(size=(B, S, T + 1)) - 2.0)
    py = torch.tensor(rng.normal(size=(B, S + 1, T)) - 2.0)
    bnd = torch.tensor(_boundary(rng, B, S, T))
    bnd[:, 2] = bnd[:, 2].clamp(min=1)
    bnd[:, 3] = bnd[:, 3].clamp(min=S + 1)
    score = rl.recursion(px.requires_grad_(), py.requires_grad_(), bnd)
    gx, gy = torch.autograd.grad(score.sum(), (px, py))
    ranges = rl.prune_ranges(gx, gy, bnd, K)
    bx, by = (x.detach().requires_grad_() for x in rl.band_lattice(px.detach(), py.detach(), ranges))
    got = rl.recursion(bx, by, bnd)
    scores, lx, ly, _ = mi_loop(bx.detach().numpy(), by.detach().numpy(), bnd.numpy())
    np.testing.assert_allclose(got.detach().numpy(), scores, rtol=1e-12, atol=1e-9)
    hx, hy = torch.autograd.grad(got.sum(), (bx, by))
    np.testing.assert_allclose(hx.numpy(), lx, atol=1e-12)
    np.testing.assert_allclose(hy.numpy(), ly, atol=1e-12)
    # a row with two runs of kept blank arcs
    broken = by.detach().clone()
    row = int(ranges[0, T // 2, 0])
    broken[0, row, :] = by.detach()[0, row, 0]
    broken[0, row, T // 2] = rl.NEG
    assert torch.isnan(rl.recursion(bx.detach(), broken, bnd)[0])


def _inputs(seed, B=3, S=5, T=9, C=7):
    g = torch.Generator().manual_seed(seed)
    am = torch.randn((B, T, C), generator=g)
    lm = torch.randn((B, S + 1, C), generator=g)
    sym = torch.randint(1, C, (B, S), generator=g, dtype=torch.int32)
    bnd = torch.from_numpy(_boundary(np.random.default_rng(seed), B, S, T)).to(torch.int32)
    bnd[:, 2] = bnd[:, 2].clamp(min=2)
    bnd[:, 3] = bnd[:, 3].clamp(min=S + 2 if S + 2 <= T else T)
    return am, lm, sym, bnd


def _finite(x):
    """The port's -inf cells as the reference's NEG."""
    return torch.where(torch.isinf(x), torch.full_like(x, rl.NEG), x)


def test_simple_and_smoothed_lattices_equal_the_ports():
    am, lm, sym, bnd = _inputs(1)
    px, py = rl.simple_lattice(lm.double(), am.double(), sym, 0, bnd)
    fpx, fpy = frt.get_rnnt_logprobs(lm, am, sym, 0, boundary=bnd)
    torch.testing.assert_close(px, _finite(fpx.double()), rtol=0, atol=1e-5)
    torch.testing.assert_close(py, fpy.double(), rtol=0, atol=1e-5)
    for l_only, a_only in [(0.25, 0.0), (0.1, 0.1)]:
        px, py = rl.smoothed_lattice(lm.double(), am.double(), sym, 0, l_only, a_only, bnd)
        fpx, fpy = frt.get_rnnt_logprobs_smoothed(lm, am, sym, 0, l_only, a_only, boundary=bnd)
        torch.testing.assert_close(px, _finite(fpx.double()), rtol=0, atol=1e-5)
        torch.testing.assert_close(py, fpy.double(), rtol=0, atol=1e-5)


def test_ranges_and_pruned_lattices_equal_the_ports():
    am, lm, sym, bnd = _inputs(2)
    _, (gx, gy) = frt.rnnt_loss_simple(lm, am, sym, 0, bnd, reduction="none", calc_gradients=True)
    want = frt.get_rnnt_prune_ranges(gx, gy, bnd, 3)
    got = rl.prune_ranges(gx.double(), gy.double(), bnd, 3)
    assert torch.equal(got, want.long())
    px, py = rl.simple_lattice(lm.double(), am.double(), sym, 0, bnd)
    bpx, bpy = rl.band_lattice(px, py, want)
    fpx, fpy = frt.get_rnnt_logprobs_pruned_simple(lm, am, sym, want, 0, bnd)
    torch.testing.assert_close(bpx, _finite(fpx.double()), rtol=0, atol=1e-5)
    torch.testing.assert_close(bpy, _finite(fpy.double()), rtol=0, atol=1e-5)
    logits = torch.randn((*want.shape, am.shape[2]), generator=torch.Generator().manual_seed(3))
    ppx, ppy = rl.pruned_lattice(logits.double(), sym, want, 0, bnd)
    fpx, fpy = frt.get_rnnt_logprobs_pruned(logits, sym, want, 0, bnd)
    torch.testing.assert_close(ppx, _finite(fpx.double()), rtol=0, atol=1e-5)
    torch.testing.assert_close(ppy, _finite(fpy.double()), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [4, 5])
def test_pipeline_equals_the_ports(seed):
    am, lm, sym, bnd = _inputs(seed, B=4, S=6, T=12, C=9)
    simple, pruned, ranges = frt.rnnt_loss_simple_pruned(lm, am, sym, 0, 3, bnd, reduction="none")
    am64, lm64 = am.double().requires_grad_(), lm.double().requires_grad_()
    px, py = rl.simple_lattice(lm64, am64, sym, 0, bnd)
    ref = -rl.recursion(px, py, bnd)
    gx, gy = torch.autograd.grad(ref.sum(), (px, py), retain_graph=True)
    assert torch.equal(rl.prune_ranges(-gx, -gy, bnd, 3), ranges.long())
    ref_pruned = -rl.recursion(*rl.band_lattice(px, py, ranges), bnd)
    torch.testing.assert_close(ref.detach(), simple.double(), rtol=1e-6, atol=0)
    torch.testing.assert_close(ref_pruned.detach(), pruned.double(), rtol=1e-6, atol=0)
