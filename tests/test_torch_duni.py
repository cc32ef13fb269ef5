"""The smoothed build backward's unigram weight rd = -sum_s dnd / duni:
``latbuild.unigram_weight_kernel_order`` (the backward prep kernel's
summation order, ``csrc/latbuild_bwd.cu``) against a numpy loop model of
that kernel, bit for bit; ``lattice_rows_bwd_plain`` given the forward's
residual ``duni`` (the kernels' exact contract) against the call without
it, which recomputes the denominator and sums in torch's order, as it
always did.  On the CPU; the card holds the kernel's own rd to these bits
(chip_smoke's ``duni-sweep``, ``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from fast_rnnt_tpu_torch.ops.kernels import latbuild
from fast_rnnt_tpu_torch.ops.lattice import _round_operand

from ._torch_parity import loss_inputs, tt


def _loop_model(dnd, duni):
    """The prep kernel in numpy float32: thread k of a frame adds the rows
    s = k (mod 4) in increasing s, from +0; the four partials added
    ((p0 + p1) + p2) + p3, negated, divided by duni."""
    p = np.zeros((4, *dnd.shape[1:]), np.float32)
    for s in range(dnd.shape[0]):
        p[s % 4] = p[s % 4] + dnd[s]
    tot = ((p[0] + p[1]) + p[2]) + p[3]
    return (-tot / duni).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("S1", [1, 3, 4, 5, 101, 300])
def test_rd_helper_is_the_prep_kernels_order(S1):
    """Bit for bit against the loop model, on terms of widely spread
    magnitudes (the order matters) with exact zeros and negative zeros."""
    rng = np.random.default_rng(S1)
    B, T = 3, 64
    dnd = (rng.normal(size=(S1, B, T)) * 10.0 ** rng.uniform(-4, 4, size=(S1, B, T))).astype(np.float32)
    dnd[rng.random(size=dnd.shape) < 0.05] = 0.0
    dnd[rng.random(size=dnd.shape) < 0.05] = -0.0
    duni = rng.uniform(0.05, 3.0, size=(B, T)).astype(np.float32)
    got = latbuild.unigram_weight_kernel_order(torch.from_numpy(dnd), torch.from_numpy(duni))
    assert got.dtype == torch.float32 and got.shape == (B, T)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_loop_model(dnd, duni)))
    if S1 == 300:  # the order is not torch's: some sums land on other bits
        naive = -torch.from_numpy(dnd).sum(dim=0) / torch.from_numpy(duni)
        assert not torch.equal(got, naive)


def _case(dtype, modified, seed=60):
    """Smoothed-build backward inputs on the CPU, and the forward's unigram
    denominator duni = sum_c amp[t, c] u[c] as the plain forward forms it
    (bf16: the exps and u rounded to bf16, as the Pallas rounding does)."""
    B, T, S, C = 3, 13, 6, 17
    am, lm, sym, bnd = loss_inputs(seed, B=B, T=T, S=S, C=C)
    rng = np.random.default_rng(seed + 1)
    te = bnd[:, 3].astype(np.int32) if not modified else np.full(B, -1, np.int32)
    dpx = rng.normal(size=(S, B, T if modified else T + 1)).astype(np.float32)
    dpy, dnd = (rng.normal(size=(S + 1, B, T)).astype(np.float32) for _ in range(2))
    uni = (np.exp(rng.normal(size=C)) / C + 1e-3).astype(np.float32)
    lm_t, am_t = (torch.from_numpy(x).to(dtype) for x in (lm, am))
    amp = latbuild._lm_probs(am_t, True).float()
    u = torch.from_numpy(uni)
    if dtype == torch.bfloat16:
        u = u.bfloat16().float()
    duni = torch.einsum("btc,c->bt", amp, u)
    args = (lm_t, am_t, *tt(sym, te, dpx, dpy), 0, modified, *tt(uni, dnd))
    return args, duni, amp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_plain_with_residual_duni_agrees_with_the_call_without(dtype, modified):
    """The two rd differ only in their summation order (ulps), so d_lm is
    the same bits, d_am within 1e-5 of max (a bf16 d_am plus one bf16
    step), and d_uni within 1e-5 of max in float32; in bf16 each rd is
    rounded to bf16 before d_uni's product, and one that sits at a
    rounding boundary may take the neighbouring step: d_uni within 1e-5 of
    max plus one bf16 step (2^-8 relative) of each of its terms."""
    args, duni, amp = _case(dtype, modified)
    want = latbuild.lattice_rows_bwd_plain(*args, return_rd=True)
    got = latbuild.lattice_rows_bwd_plain(*args, duni=duni, return_rd=True)
    assert torch.equal(got[0], want[0])
    step = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    excess = (got[1].double() - want[1].double()).abs() - step * want[1].double().abs()
    assert float(excess.max()) <= 1e-5 * float(want[1].abs().max())
    # the rd agree to float32 round-off of the sum of S+1 terms
    scale = args[-1].abs().sum(dim=0) / duni
    assert float(((got[3] - want[3]).abs() / scale).max()) <= 1e-6
    slack = 0.0
    if dtype == torch.bfloat16:
        slack = 2.0**-8 * torch.einsum("bt,btc->c", want[3].abs(), amp)
    err = (got[2] - want[2]).abs() - slack
    assert float(err.max()) <= 1e-5 * float(want[2].abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_residual_duni_is_read(dtype):
    """Doubling the residual halves rd exactly, and d_uni moves with it."""
    args, duni, _ = _case(dtype, False, seed=61)
    one = latbuild.lattice_rows_bwd_plain(*args, duni=duni, return_rd=True)
    two = latbuild.lattice_rows_bwd_plain(*args, duni=2 * duni, return_rd=True)
    assert torch.equal(two[3], one[3] / 2)
    assert not torch.equal(two[2], one[2])
    assert torch.equal(one[3], latbuild.unigram_weight_kernel_order(args[-1], duni))


@pytest.mark.parametrize("dtype,prec", [(torch.float32, "highest"), (torch.float32, "high"),
                                        (torch.float32, "default"), (torch.bfloat16, None)],
                         ids=["f32-highest", "f32-high", "f32-default", "bf16"])
def test_call_without_residuals_is_unchanged(dtype, prec):
    """Without ``duni`` the plain backward computes rd as it always did,
    -sum_s dnd (torch's order) over the recomputed denominator, and d_uni
    as the product of its rounded weights: the same bits as that formula
    written out here, and ``return_rd`` adds an output without changing
    the others."""
    args, _, amp = _case(dtype, False, seed=62)
    plain = latbuild.lattice_rows_bwd_plain(*args, prec=prec)
    got = latbuild.lattice_rows_bwd_plain(*args, prec=prec, return_rd=True)
    assert len(plain) == 3 and all(torch.equal(a, b) for a, b in zip(plain, got[:3]))
    level = prec if dtype == torch.float32 else "highest"
    u = args[-2].bfloat16().float() if dtype == torch.bfloat16 else args[-2]
    rd = -args[-1].permute(1, 0, 2).sum(dim=1) / torch.einsum(
        "btc,c->bt", _round_operand(amp, level), _round_operand(u, level))
    assert torch.equal(got[3], rd)
    w = rd.bfloat16().float() if dtype == torch.bfloat16 else rd
    d_uni = torch.einsum("bt,btc->c", _round_operand(w, level), _round_operand(amp, level))
    assert torch.equal(got[2], d_uni)
