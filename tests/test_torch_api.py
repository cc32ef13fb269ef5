"""The port's public surface against the JAX package's: every name in each
JAX module's ``__all__`` (the package, ``ops``, ``models``, ``utils``,
``parallel``, ``data``) is in the port's counterpart's ``__all__`` and
defined there, and every public function of the JAX package that takes
``impl`` has a counterpart that takes it too (``LossConfig.impl``
included)."""

import dataclasses
import importlib
import inspect

import pytest

PAIRS = ["", ".ops", ".models", ".utils", ".parallel", ".data"]


def _modules(sub):
    return (importlib.import_module("fast_rnnt_tpu" + sub),
            importlib.import_module("fast_rnnt_tpu_torch" + sub))


@pytest.mark.parametrize("sub", PAIRS, ids=lambda s: s.strip(".") or "top")
def test_every_jax_name_has_a_counterpart(sub):
    jmod, tmod = _modules(sub)
    missing = sorted(set(jmod.__all__) - set(tmod.__all__))
    assert not missing, f"fast_rnnt_tpu_torch{sub} lacks {missing}"
    undefined = [n for n in tmod.__all__ if not hasattr(tmod, n)]
    assert not undefined, undefined


def _impl_functions():
    """(module path, name) of every function in a JAX ``ops`` or ``models``
    module's ``__all__`` whose signature has ``impl``."""
    out = []
    for mod in ("ops.recursion", "ops.lattice", "ops.losses", "ops.pruning", "ops.alignment",
                "models.training", "models.decoding", "models.streaming"):
        jmod = importlib.import_module("fast_rnnt_tpu." + mod)
        for name in jmod.__all__:
            obj = getattr(jmod, name)
            if inspect.isfunction(obj) and "impl" in inspect.signature(obj).parameters:
                out.append((mod, name))
    return out


IMPL_FUNCTIONS = _impl_functions()


def test_the_impl_list_is_the_known_one():
    names = {n for _, n in IMPL_FUNCTIONS}
    assert {"mutual_information_recursion", "mutual_information_rows", "get_rnnt_logprobs",
            "get_rnnt_logprobs_rows", "get_rnnt_logprobs_smoothed_rows", "get_rnnt_prune_ranges_rows",
            "rnnt_loss", "rnnt_loss_chunked", "rnnt_loss_pruned", "rnnt_loss_pruned_simple",
            "rnnt_loss_simple", "rnnt_loss_simple_pruned", "rnnt_loss_smoothed",
            "rnnt_loss_smoothed_pruned"} <= names


@pytest.mark.parametrize("mod,name", IMPL_FUNCTIONS, ids=[n for _, n in IMPL_FUNCTIONS])
def test_impl_taking_functions_take_it_in_the_port(mod, name):
    fn = getattr(importlib.import_module("fast_rnnt_tpu_torch." + mod), name)
    params = inspect.signature(fn).parameters
    assert "impl" in params, f"{mod}.{name} has no impl"
    jparams = inspect.signature(getattr(importlib.import_module("fast_rnnt_tpu." + mod), name)).parameters
    assert params["impl"].default == jparams["impl"].default


def test_loss_config_takes_impl():
    from fast_rnnt_tpu.models import LossConfig as JLossConfig
    from fast_rnnt_tpu_torch.models import LossConfig

    jfields = {f.name: f.default for f in dataclasses.fields(JLossConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(LossConfig)}
    # the port's own: stage 1's smoothing, off by default (the JAX package's loss)
    own = {"lm_only_scale": 0.0, "am_only_scale": 0.0}
    assert fields == {**jfields, **own}
