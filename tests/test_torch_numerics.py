"""Port parity: fast_rnnt_tpu_torch.ops.numerics vs fast_rnnt_tpu.ops.numerics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.ops import numerics as jn
from fast_rnnt_tpu_torch.ops import numerics as tn

from ._torch_parity import assert_close, to_np

SPECIAL = np.array([-np.inf, -1e30, -3.0, 0.0, 2.5, 88.0, 89.0, np.nan], np.float32)


def test_logaddexp_matches_jax_on_special_values():
    x, y = np.meshgrid(SPECIAL, SPECIAL)
    got = to_np(tn.logaddexp(torch.from_numpy(x), torch.from_numpy(y)))
    want = np.asarray(jn.logaddexp(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert_close(np.nan_to_num(got, nan=0.0), np.nan_to_num(want, nan=0.0), 1e-6, 1e-6)
    assert tn.logaddexp(torch.tensor(-np.inf), torch.tensor(-np.inf)).item() == -np.inf


def test_safe_exp_matches_jax_on_special_values():
    got = to_np(tn.safe_exp(torch.from_numpy(SPECIAL)))
    want = np.asarray(jn.safe_exp(jnp.asarray(SPECIAL)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] == 0.0 and got[-2] == 0.0  # NaN and overflow map to 0


@pytest.mark.parametrize("width", [1, 2, 7, 64])
def test_log_linear_scan_matches_jax(width):
    rng = np.random.default_rng(width)
    coeff = rng.normal(size=(3, width)).astype(np.float32)
    bias = rng.normal(size=(3, width)).astype(np.float32)
    coeff[rng.random(coeff.shape) < 0.2] = -np.inf
    bias[rng.random(bias.shape) < 0.2] = -np.inf
    got = tn.log_linear_scan(torch.from_numpy(coeff), torch.from_numpy(bias))
    want = jax.jit(jn.log_linear_scan)(jnp.asarray(coeff), jnp.asarray(bias))
    assert_close(got, want, 1e-5, 1e-5, "log_linear_scan")


@pytest.mark.parametrize("reverse", [False, True])
def test_linear_scans_match_jax(reverse):
    rng = np.random.default_rng(3)
    coeff = rng.random((4, 37)).astype(np.float32)
    bias = rng.random((4, 37)).astype(np.float32)
    tf, jf = (
        (tn.reverse_linear_scan, jn.reverse_linear_scan)
        if reverse else (tn.linear_scan, jn.linear_scan)
    )
    got = tf(torch.from_numpy(coeff), torch.from_numpy(bias))
    want = jax.jit(jf)(jnp.asarray(coeff), jnp.asarray(bias))
    assert_close(got, want, 1e-5, 1e-5, "linear scan")


def test_log_linear_scan_other_axis():
    rng = np.random.default_rng(4)
    coeff = rng.normal(size=(9, 2)).astype(np.float32)
    bias = rng.normal(size=(9, 2)).astype(np.float32)
    got = tn.log_linear_scan(torch.from_numpy(coeff), torch.from_numpy(bias), dim=0)
    want = jax.jit(jn.log_linear_scan, static_argnums=2)(jnp.asarray(coeff), jnp.asarray(bias), 0)
    assert_close(got, want, 1e-5, 1e-5)
