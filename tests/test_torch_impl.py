"""Per-call routes (``impl=``) and ``register_impl`` of the port against the
JAX package's.

  * ``register_impl``: wrappers that count their calls around the port's
    plain (B, S, T)-major recursion and, registered in the JAX package,
    around its XLA pair; ``rnnt_loss_simple_pruned(impl=name)`` and its
    gradient against the JAX package's at the loss and lattice tolerances
    of ``_torch_parity``;
  * ``impl="plain"`` on every loss, the rows builds, the recursion and the
    ranges: the default CPU route's bits (both are the plain versions on
    a CPU tensor);
  * ``"cuda"`` on a CPU tensor, the JAX names and unknown names raise;
  * a per-call value wins over the process switches, and a backward runs
    its forward's route;
  * ``LossConfig(impl="plain")`` through ``make_train_step`` against the JAX
    step (``impl="xla"``) on carried weights, stage 2 on the JAX ranges (as
    ``test_torch_models.py`` feeds them): metrics to rel 1e-4, weights to
    1e-4 of each leaf's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fast_rnnt_tpu as frt
import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu.models import LossConfig as JLossConfig
from fast_rnnt_tpu.models import TransducerConfig as JConfig
from fast_rnnt_tpu.models import init_model as jinit_model
from fast_rnnt_tpu.models import make_train_step as jmake_train_step
from fast_rnnt_tpu.ops import recursion as jrec
from fast_rnnt_tpu_torch.models import LossConfig, PrunedTransducer, TransducerConfig, make_train_step
from fast_rnnt_tpu_torch.models import training as ttraining
from fast_rnnt_tpu_torch.ops import lattice, recursion
from fast_rnnt_tpu_torch.ops.kernels import latbuild, ranges, wavefront
from fast_rnnt_tpu_torch.utils import params_from_flax

from ._torch_parity import (
    assert_lattice_close,
    assert_loss_close,
    jj,
    loss_inputs,
    rows_inputs,
    to_np,
    tt,
)

NAME = "counted"


@pytest.fixture(autouse=True)
def restore_routes():
    """Both packages' process defaults and registries as they were."""
    saved = (recursion._DEFAULT_IMPL, lattice._LATTICE_BUILD_IMPL, dict(recursion._IMPL),
             jrec._DEFAULT_IMPL, dict(jrec._IMPL))
    yield
    recursion._DEFAULT_IMPL, lattice._LATTICE_BUILD_IMPL = saved[:2]
    recursion._IMPL.clear()
    recursion._IMPL.update(saved[2])
    jrec._DEFAULT_IMPL = saved[3]
    jrec._IMPL.clear()
    jrec._IMPL.update(saved[4])


def _launches():
    return (dict(wavefront.LAUNCHES), dict(latbuild.LAUNCHES), dict(ranges.LAUNCHES))


def _counting(fwd, bwd, calls):
    def f(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def b(*a):
        calls["bwd"] += 1
        return bwd(*a)

    return f, b


def _register_both(default=False):
    """The counting wrappers, registered in the port and in the JAX package
    under NAME; returns (port calls, JAX calls)."""
    tcalls, jcalls = {"fwd": 0, "bwd": 0}, {"fwd": 0, "bwd": 0}
    ft.register_impl(NAME, *_counting(recursion._forward_lattice_plain,
                                      recursion._backward_lattice_plain, tcalls), default=default)
    frt.register_impl(NAME, *_counting(jrec._forward_lattice_xla, jrec._backward_lattice_xla, jcalls))
    return tcalls, jcalls


def _port_pipeline(am, lm, sym, bnd, **kw):
    tam, tlm = torch.from_numpy(am).requires_grad_(), torch.from_numpy(lm).requires_grad_()
    s, p, r = ft.rnnt_loss_simple_pruned(tlm, tam, tt(sym), 0, 3, tt(bnd), reduction="none", **kw)
    g = torch.autograd.grad(s.sum() + p.sum(), (tam, tlm))
    return s.detach(), p.detach(), r, *g


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_registered_impl_matches_jax(rnnt_type):
    am, lm, sym, bnd = loss_inputs(70, B=3, T=14, S=5, C=11)
    tcalls, jcalls = _register_both()

    def jloss(a, l):
        s, p, r = frt.rnnt_loss_simple_pruned(l, a, jj(sym), 0, 3, jj(bnd), rnnt_type=rnnt_type,
                                              reduction="none", impl=NAME)
        return s.sum() + p.sum(), (s, p, r)

    (_, (s_j, p_j, r_j)), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(*jj(am, lm))
    tam, tlm = torch.from_numpy(am).requires_grad_(), torch.from_numpy(lm).requires_grad_()
    s, p, r = ft.rnnt_loss_simple_pruned(tlm, tam, tt(sym), 0, 3, tt(bnd), rnnt_type=rnnt_type,
                                         reduction="none", impl=NAME)
    g = torch.autograd.grad(s.sum() + p.sum(), (tam, tlm))
    np.testing.assert_array_equal(to_np(r), np.asarray(r_j))
    assert_loss_close(s, s_j, "simple")
    assert_loss_close(p, p_j, "pruned")
    assert_lattice_close(g[0], g_j[0], "d am")
    assert_lattice_close(g[1], g_j[1], "d lm")
    # stage 1 (forward, backward seeded with ones) and stage 2 (forward,
    # backward under autograd) in both packages
    assert tcalls["fwd"] >= 2 and tcalls["bwd"] >= 2, tcalls
    assert jcalls["fwd"] >= 2 and jcalls["bwd"] >= 2, jcalls


def test_registered_impl_as_the_default():
    am, lm, sym, bnd = loss_inputs(71, B=2, T=12, S=4, C=9)
    want = _port_pipeline(am, lm, sym, bnd)
    tcalls, _ = _register_both(default=True)
    assert recursion._DEFAULT_IMPL == NAME
    got = _port_pipeline(am, lm, sym, bnd)  # no impl: the pinned default
    assert tcalls["fwd"] >= 2 and tcalls["bwd"] >= 2
    for a, b in zip(got, want):
        assert_lattice_close(a, b)
    # the default is reset like any other
    ft.set_default_impl(None)
    n = dict(tcalls)
    _port_pipeline(am, lm, sym, bnd)
    assert tcalls == n


def test_registered_backward_keeps_its_forward_route():
    px, py, bnd = rows_inputs(72, B=2, S=4, T=9)
    tcalls, _ = _register_both()
    tpx, tpy = torch.from_numpy(px).requires_grad_(), torch.from_numpy(py).requires_grad_()
    scores = ft.mutual_information_rows(tpx, tpy, tt(bnd), impl=NAME)
    assert tcalls == {"fwd": 1, "bwd": 0}
    ft.set_default_impl("plain")
    g = torch.autograd.grad(scores.sum(), (tpx, tpy))
    assert tcalls == {"fwd": 1, "bwd": 1}
    want = torch.autograd.grad(ft.mutual_information_rows(tpx, tpy, tt(bnd)).sum(), (tpx, tpy))
    for a, b in zip(g, want):
        assert_lattice_close(a, b)


@pytest.mark.parametrize("name", ["cuda", "plain", "auto", "xla", "pallas"])
def test_register_reserved_names_raise(name):
    with pytest.raises(ValueError, match="reserved"):
        ft.register_impl(name, recursion._forward_lattice_plain, recursion._backward_lattice_plain)
    assert name not in recursion._IMPL


def _loss_calls(am, lm, sym, bnd):
    """Each of the eight losses (and its gradient where it has one) as a
    function of ``impl``."""
    B, T, C = am.shape
    S = sym.shape[1]
    rng = np.random.default_rng(73)
    logits = rng.normal(size=(B, T, S + 1, C)).astype(np.float32)
    rg = np.clip(np.arange(T)[None, :, None] * S // T + np.arange(3)[None, None, :], 0, S)
    rg = np.broadcast_to(rg, (B, T, 3)).astype(np.int32).copy()
    plogits = rng.normal(size=(B, T, 3, C)).astype(np.float32)

    def with_grad(fn, *xs):
        def run(impl):
            ts = [torch.from_numpy(x).requires_grad_() for x in xs]
            out = fn(impl, *ts)
            loss = out if isinstance(out, torch.Tensor) else out[0] + out[1]
            return (out, *torch.autograd.grad(loss.sum(), ts))
        return run

    s, b = tt(sym), tt(bnd)
    return {
        "simple": with_grad(lambda i, l, a: ft.rnnt_loss_simple(l, a, s, 0, b, impl=i), lm, am),
        "smoothed": with_grad(lambda i, l, a: ft.rnnt_loss_smoothed(l, a, s, 0, 0.2, 0.1, b, impl=i), lm, am),
        "joint": with_grad(lambda i, x: ft.rnnt_loss(x, s, 0, b, impl=i), logits),
        "chunked": with_grad(lambda i, a, l: ft.rnnt_loss_chunked(
            lambda ac, lc: ac[:, :, None, :] + lc[:, None, :, :], a, l, s, 0, b, chunk=5, impl=i), am, lm),
        "pruned": with_grad(lambda i, x: ft.rnnt_loss_pruned(x, s, tt(rg), 0, b, impl=i), plogits),
        "pruned_simple": with_grad(lambda i, l, a: ft.rnnt_loss_pruned_simple(
            l, a, s, tt(rg), 0, b, impl=i), lm, am),
        "simple_pruned": with_grad(lambda i, l, a: ft.rnnt_loss_simple_pruned(
            l, a, s, 0, 3, b, impl=i), lm, am),
        "smoothed_pruned": with_grad(lambda i, l, a: ft.rnnt_loss_smoothed_pruned(
            l, a, s, 0, 3, 0.2, 0.1, b, impl=i), lm, am),
    }


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x.detach()]
    return [t for y in x for t in _flat(y)]


LOSSES = ["simple", "smoothed", "joint", "chunked", "pruned", "pruned_simple", "simple_pruned",
          "smoothed_pruned"]


@pytest.mark.parametrize("loss", LOSSES)
def test_plain_per_call_equals_the_default_cpu_route(loss):
    am, lm, sym, bnd = loss_inputs(74, B=2, T=11, S=4, C=8)
    run = _loss_calls(am, lm, sym, bnd)[loss]
    want = _flat(run(None))
    before = _launches()
    for impl in ("plain", "auto"):
        got = _flat(run(impl))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert _launches() == before


@pytest.mark.parametrize("loss", LOSSES)
def test_cuda_per_call_on_a_cpu_tensor_raises(loss):
    am, lm, sym, bnd = loss_inputs(75, B=2, T=11, S=4, C=8)
    with pytest.raises(ValueError, match="cuda"):
        _loss_calls(am, lm, sym, bnd)[loss]("cuda")


@pytest.mark.parametrize("name,port", [("xla", "plain"), ("pallas", "cuda")])
def test_jax_names_raise_naming_the_port_counterpart(name, port):
    am, lm, sym, bnd = tt(*loss_inputs(76, B=2, T=10, S=4, C=8))
    calls = [
        lambda: ft.rnnt_loss_simple(lm, am, sym, 0, bnd, impl=name),
        lambda: ft.get_rnnt_logprobs_rows(lm, am, sym, 0, impl=name),
        lambda: ft.get_rnnt_logprobs_smoothed_rows(lm, am, sym, 0, impl=name),
        lambda: ft.mutual_information_recursion(*ft.get_rnnt_logprobs(lm, am, sym, 0), impl=name),
        lambda: ft.set_default_impl(name),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=f'"{port}"|\'{port}\''):
            call()
    with pytest.raises(ValueError, match="unknown impl"):
        ft.rnnt_loss_simple(lm, am, sym, 0, bnd, impl="triton")


def test_rows_builds_recursion_and_ranges_take_impl():
    am, lm, sym, bnd = tt(*loss_inputs(77, B=2, T=12, S=5, C=9))
    for fn in (lambda i: ft.get_rnnt_logprobs_rows(lm, am, sym, 0, "regular", bnd, impl=i),
               lambda i: ft.get_rnnt_logprobs(lm, am, sym, 0, "modified", bnd, impl=i),
               lambda i: ft.get_rnnt_logprobs_smoothed_rows(lm, am, sym, 0, 0.2, 0.1, bnd, impl=i)):
        for a, b in zip(fn("plain"), fn(None)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="cuda"):
            fn("cuda")
    px, py = ft.get_rnnt_logprobs_rows(lm, am, sym, 0, "regular", bnd)
    _, (gx, gy) = ft.mutual_information_rows(px, py, bnd, calc_gradients=True, impl="plain")
    for impl in ("plain", None):
        assert torch.equal(ft.get_rnnt_prune_ranges_rows(gx, gy, bnd, 3, impl=impl),
                           ft.get_rnnt_prune_ranges_rows(gx, gy, bnd, 3))
    with pytest.raises(ValueError, match="cuda"):
        ft.get_rnnt_prune_ranges_rows(gx, gy, bnd, 3, impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ft.mutual_information_rows(px, py, bnd, impl="cuda")


def test_per_call_wins_over_the_process_switches():
    am, lm, sym, bnd = loss_inputs(78, B=2, T=12, S=5, C=9)
    want = _port_pipeline(am, lm, sym, bnd)
    ft.set_default_impl("cuda")
    ft.set_lattice_build_impl("kernel")
    with pytest.raises(ValueError):
        _port_pipeline(am, lm, sym, bnd)  # the switches alone: no kernel for a CPU tensor
    got = _port_pipeline(am, lm, sym, bnd, impl="plain")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert recursion._DEFAULT_IMPL == "cuda" and lattice._LATTICE_BUILD_IMPL == "kernel"


@pytest.mark.parametrize("smoothed", [False, True], ids=["simple", "smoothed"])
def test_backward_takes_the_forward_route(smoothed):
    """Forward on the process defaults (the plain versions on a CPU tensor);
    both switches turned to the kernels before the backward, which still
    runs the plain route its forward ran."""
    am, lm, sym, bnd = loss_inputs(79, B=2, T=12, S=5, C=9)
    fn = ft.rnnt_loss_smoothed if smoothed else ft.rnnt_loss_simple

    def grads(switch):
        tam = torch.from_numpy(am).requires_grad_()
        loss = fn(tt(lm), tam, tt(sym), 0, boundary=tt(bnd), reduction="sum")
        if switch:
            ft.set_default_impl("cuda")
            ft.set_lattice_build_impl("kernel")
        return torch.autograd.grad(loss, tam)[0]

    want = grads(False)
    assert torch.equal(grads(True), want)


def test_loss_config_impl_through_the_train_step(monkeypatch):
    """One step of ``make_train_step`` with ``LossConfig(impl="plain")``
    against the JAX step with ``impl="xla"`` on the same weights: both
    losses and the ranges take the impl, the metrics agree to rel 1e-4 and
    the weights after the step to 1e-4 of each leaf's max."""
    from .test_torch_models import TINY, _batch, _jax_ranges, _tb

    jm, jp = jinit_model(jax.random.PRNGKey(0), JConfig(dtype=jnp.float32, num_layers=1, **TINY))
    jp = jax.device_get(jp)
    batch = _batch(6)
    queue = [_jax_ranges(jm, jp, batch)]
    opt = optax.adamw(1e-3)
    jstep = jmake_train_step(jm, opt, mesh=None, loss_cfg=JLossConfig(s_range=3, impl="xla"))
    params, _, jmetrics = jstep(jp, opt.init(jp), tuple(jnp.asarray(x) for x in batch))

    seen = []

    def take(name, fn):
        def run(*a, **k):
            seen.append((name, k.get("impl")))
            return fn(*a, **k)
        return run

    def jax_ranges(*a, **k):
        seen.append(("ranges", k.get("impl")))
        return torch.tensor(queue.pop(0))

    monkeypatch.setattr(ttraining, "get_rnnt_prune_ranges", jax_ranges)
    monkeypatch.setattr(ttraining, "rnnt_loss_simple", take("simple", ttraining.rnnt_loss_simple))
    monkeypatch.setattr(ttraining, "rnnt_loss_pruned", take("pruned", ttraining.rnnt_loss_pruned))
    model = PrunedTransducer(TransducerConfig(dtype=torch.float32, num_layers=1, **TINY))
    model.load_state_dict(params_from_flax(jp), strict=True)
    optim = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    before = _launches()
    metrics = make_train_step(model, optim, LossConfig(s_range=3, impl="plain"))(_tb(batch))
    assert _launches() == before
    assert sorted(seen) == [("pruned", "plain"), ("ranges", "plain"), ("simple", "plain")]
    for key in ("loss", "simple_loss", "pruned_loss"):
        w = float(jmetrics[key])
        assert abs(metrics[key].item() - w) <= 1e-4 * abs(w), key
    want = params_from_flax(jax.device_get(params))
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):  # zero gradient but for round-off
            continue
        w = want[name].numpy()
        assert np.abs(to_np(p) - w).max() <= 1e-4 * np.abs(w).max(), name
