"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU (the kernels have no CPU or interpret mode) and
skip without one; run them there with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: tests/conftest.py sets JAX up, and the GPU machine
needs no JAX).
chip_smoke.py compares every kernel with its plain version at small
ragged shapes and at the headline shape, and drives the main path; the
cases here are the ones it does not cover: random shapes, very long
utterances, out-of-range symbols and the CUDA dtype and gradient rules."""

import numpy as np
import pytest
import torch

import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu_torch.ops.kernels import latbuild, ranges, wavefront
from fast_rnnt_tpu_torch.ops.pruning import _window_scores
from fast_rnnt_tpu_torch.utils import from_numpy

from ._torch_parity import (
    assert_close,
    assert_lattice_close,
    assert_loss_close,
    assert_ranges_match,
    band,
    loss_inputs,
    rows_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified", "constrained"])
def test_latbuild_kernel_out_of_range_symbols(dev, rnnt_type):
    """A symbol outside [0, C) reads am = lm = 0, as in the plain build and
    the JAX package's one-hot gathers, and never reads outside its row
    (the last utterance's last symbol sits at the end of am)."""
    am, lm, sym, bnd = loss_inputs(3, B=3, T=70, S=9, C=33)
    sym[0, 0], sym[1, 4], sym[2, 8] = -1, 33, 10**6
    am, lm, sym, bnd = from_numpy(am, lm, sym, bnd, device=dev)
    a = latbuild.lattice_rows(lm, am, sym, 0, rnnt_type, bnd)
    base = "modified" if rnnt_type == "constrained" else rnnt_type
    px, py = latbuild.lattice_rows_plain(lm, am, sym, 0, base, bnd)
    if rnnt_type == "constrained":
        px = px + py[1:]
    assert_lattice_close(a[0], px)
    assert_lattice_close(a[1], py)


def test_dtype_policy_and_build_gradient_on_cuda(dev):
    px, py, bnd = from_numpy(*rows_inputs(6, B=2, S=3, T=8), device=dev)
    with pytest.raises(TypeError):
        ft.mutual_information_rows(px.double(), py.double(), bnd)
    am, lm, sym, b = from_numpy(*loss_inputs(7, B=2, T=8, S=3, C=6), device=dev)
    am.requires_grad_()
    s, p, _ = ft.rnnt_loss_simple_pruned(lm, am, sym, 0, 2, b)
    with pytest.raises(NotImplementedError):
        (s + p).backward()
    # the recursion's own gradient works on the card
    px.requires_grad_()
    scores = ft.mutual_information_rows(px, py, bnd)
    scores.sum().backward()
    assert torch.isfinite(px.grad).all()
    assert np.isfinite(px.grad.cpu().numpy()).all()


@pytest.mark.parametrize("seed", range(12))
def test_kernels_match_plain_on_random_shapes(dev, seed):
    """Random ragged shapes: segments of several cells per thread (T > 1024),
    S = 0 and 1, width-1 and full-width bands, one-utterance batches."""
    rng = np.random.default_rng(100 + seed)
    B, S, T = int(rng.integers(1, 6)), int(rng.integers(0, 13)), int(rng.integers(1, 2200))
    modified, offset = bool(rng.integers(2)), bool(rng.integers(2))
    px, py, bnd = rows_inputs(seed, B=B, S=S, T=T, modified=modified, offset=offset)
    K = int(rng.integers(1, S + 2)) if rng.integers(2) else 0
    lo = band(seed, B, S, T, K) if K else None
    px, py, bnd, lo = from_numpy(px, py, bnd, lo, device=dev)
    p_k, s_k = wavefront.forward_rows(px, py, bnd, lo, K)
    p_p, s_p = wavefront.forward_rows_plain(px, py, bnd, lo, K)
    assert_loss_close(s_k, s_p)
    assert_close(p_k, p_p, 1e-4, 1e-5)
    ag = torch.rand(B, device=dev) + 0.5
    for a, b in zip(wavefront.backward_rows(px, py, p_k, bnd, ag, lo, K),
                    wavefront.backward_rows_plain(px, py, p_k, bnd, ag, lo, K)):
        assert_close(a, b, 1e-5, 1e-4)
    if S >= 1 and not K:
        gx, gy = wavefront.backward_rows(px, py, p_k, bnd, torch.ones(B, device=dev))
        Kr = int(rng.integers(1 if modified else 2, S + 2)) if S >= 1 else 1
        step = 2 if modified else Kr
        assert_ranges_match(
            ranges.window_starts(gy, gx, Kr, bnd, step),
            ranges.window_starts_plain(gy, gx, Kr, bnd, step),
            _window_scores(gx, gy, Kr),
        )
    C = int(rng.integers(2, 70))
    lm = torch.randn(B, S + 1, C, device=dev)
    am = torch.randn(B, T, C, device=dev) * 3
    sym = torch.randint(0, C, (B, S), device=dev, dtype=torch.int32)
    rt = "modified" if modified else "regular"
    blank = int(rng.integers(C))
    px_p, py_p = latbuild.lattice_rows_plain(lm, am, sym, blank, rt, bnd)
    for a, b in zip(latbuild.lattice_rows(lm, am, sym, blank, rt, bnd), (px_p, py_p)):
        assert_close(a, b, 1e-4, 1e-5)
    if modified:
        px_c, _ = latbuild.lattice_rows(lm, am, sym, blank, "constrained", bnd)
        assert_close(px_c, px_p + py_p[1:], 1e-4, 1e-5)


@pytest.mark.parametrize("modified", [False, True])
def test_wavefront_kernels_long_utterance(dev, modified):
    """T = 12000 (the ROADMAP's longest scaling shape): twelve cells per
    thread, the largest rows the kernels keep in shared memory."""
    px, py, bnd = from_numpy(*rows_inputs(9, B=2, S=12, T=12000, modified=modified), device=dev)
    p_k, s_k = wavefront.forward_rows(px, py, bnd)
    p_p, s_p = wavefront.forward_rows_plain(px, py, bnd)
    assert_loss_close(s_k, s_p)
    ones = torch.ones(2, device=dev)
    for a, b in zip(wavefront.backward_rows(px, py, p_k, bnd, ones),
                    wavefront.backward_rows_plain(px, py, p_k, bnd, ones)):
        assert_close(a, b, 1e-5, 1e-3)
