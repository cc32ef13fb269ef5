"""Batch-sharded ``DTensor`` s through the port's losses, ops and kernel
wrappers (``fast_rnnt_tpu_torch/ops/kernels/partition.py``), the
counterparts of tests/test_gspmd.py.

Two gloo ranks on the CPU run every case in one process start
(``tests._torch_mp_worker partition``) and save each case's global
results; the tests here hold them against the JAX function on the
unsharded batch at tests/test_gspmd.py's 2e-5 (the value a sharded call
must equal: the JAX sharded path's own test is red) and against the port's
own unsharded call at 1e-6, with integer results (ranges) equal.  On the
CPU the kernel wrappers run their plain versions, so the trace hook shows
the recursion and ranges entries; the build kernels' are checked on the
card (chip_smoke.py's ``dtensor`` phase).  One-rank cases run in this
process on a gloo group of one, among them a walk of ``ops.__all__``: every
public op that takes a batch is partitioned or carried by DTensor itself,
and none raises on DTensors."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

import fast_rnnt_tpu.ops as jops
import fast_rnnt_tpu_torch
import fast_rnnt_tpu_torch.ops as tops
from fast_rnnt_tpu_torch.ops.kernels import _build, partition, ranges, wavefront

from . import _torch_mp_worker as W
from ._torch_parity import to_np

JAX_TOL = 2e-5  # tests/test_gspmd.py:101
PORT_TOL = 1e-6
B_LOCAL = W.PART_B // 2
KERNELS = ("mi_fused", "mi_fwd", "mi_bwd", "prune_ranges")
# entries reduced across the batch: (number of loss outputs, Partial kind)
REDUCED = {"rnnt_loss_smoothed": (1, "avg"), "rnnt_loss": (1, "sum"), "rnnt_loss_smoothed_pruned": (2, "sum")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from .test_torch_parallel import run_ranks

    return run_ranks("partition", tmp_path_factory.mktemp("partition"), seed=0)


@pytest.fixture(scope="module")
def arrays():
    return W.partition_arrays(0)


def values(out):
    """The flat list of a saved result's global values (None kept)."""
    if isinstance(out, dict):
        return [out["value"]]
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in values(o)]
    return [out]


def placements(out):
    if isinstance(out, dict):
        return [out["placements"]]
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in placements(o)]
    return []


def flat(out):
    """A JAX or port result as a flat list of numpy arrays (None kept)."""
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in flat(o)]
    return [None if out is None else to_np(out)]


def assert_same(got, want, tol, what):
    assert len(got) == len(want), f"{what}: {len(got)} outputs, want {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, f"{what}[{i}]"
            continue
        g, w = to_np(g), np.asarray(w)
        assert g.shape == w.shape, f"{what}[{i}]: shape {g.shape} != {w.shape}"
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
            continue
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w), err_msg=f"{what}[{i}] -inf")
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=tol, atol=tol, err_msg=f"{what}[{i}]")


def check(ranks, key, jax_out, port_out):
    """Both ranks hold the same global values; they equal the JAX result
    at 2e-5 and the port's unsharded one at 1e-6."""
    got = values(ranks[0][key]["out"])
    for a, b in zip(got, values(ranks[1][key]["out"])):
        assert (a is None and b is None) or torch.equal(a, b), key
    assert_same(got, flat(jax_out), JAX_TOL, f"{key} vs JAX")
    assert_same(got, flat(port_out), PORT_TOL, f"{key} vs the unsharded port")
    return got


def hook_batches(ranks, key):
    return {name: b for name, b in ranks[0][key]["hook"]}


def entry_calls(name, arrays):
    fname, _, kw = W.ENTRIES[name]
    j = W.entry_function(jops, fname)(*W.entry_args(name, arrays, lambda a, x: jnp.asarray(x)), **kw)
    t = W.entry_function(tops, fname)(*W.entry_args(name, arrays, lambda a, x: torch.from_numpy(x)), **kw)
    return j, t


# --- every entry point, two ranks ------------------------------------------

@pytest.mark.multiprocess
@pytest.mark.parametrize("name", sorted(W.ENTRIES))
def test_entry_point_takes_batch_sharded_dtensors(ranks, arrays, name):
    """Each entry point named in the module's docstring on Shard(0) inputs
    (s-major rows Shard(1)): the unsharded batch's values, outputs sharded
    on their batch axis (reduced losses Partial), every nested entry run
    per shard."""
    check(ranks, name, *entry_calls(name, arrays))
    n_reduced, kind = REDUCED.get(name, (0, None))
    got = placements(ranks[0][name]["out"])
    assert got[:n_reduced] == [f"(Partial({kind}),)"] * n_reduced, got
    assert set(got[n_reduced:]) <= {"(Shard(dim=0),)", "(Shard(dim=1),)"}, got
    seen = hook_batches(ranks, name)
    assert name in seen and set(seen.values()) == {B_LOCAL}, seen


def placement_of(arg):
    """The placement the worker gives a named argument."""
    return "(Shard(dim=1),)" if arg.endswith("_rows") else "(Shard(dim=0),)"


@pytest.mark.multiprocess
@pytest.mark.parametrize("name", sorted(W.NATIVE))
def test_native_op_takes_batch_sharded_dtensors(ranks, arrays, name):
    """The ops left unwrapped (they make no tensor of their own) on Shard(0)
    inputs: DTensor's own sharding rules give the unsharded batch's values,
    Shard(0), with no partitioned call (the hook silent)."""
    fname, _, kw = W.NATIVE[name]
    j = getattr(jops, fname)(*W.entry_args(name, arrays, lambda a, x: jnp.asarray(x), W.NATIVE), **kw)
    t = getattr(tops, fname)(*W.entry_args(name, arrays, lambda a, x: torch.from_numpy(x), W.NATIVE), **kw)
    key = f"native_{name}"
    check(ranks, key, j, t)
    assert placements(ranks[0][key]["out"]) == ["(Shard(dim=0),)"]
    assert ranks[0][key]["hook"] == [] and ranks[1][key]["hook"] == []


def jax_glue_grad(name, arrays):
    """W.glue_grad of the JAX op: its outputs and the gradient of the sum of
    their finite entries."""
    fname, spec, kw = W.ENTRIES[name]
    args = W.entry_args(name, arrays, lambda a, x: jnp.asarray(x))
    wrt = [i for i, a in enumerate(spec) if a in W.GLUE_GRADS[name]]

    def total(*xs):
        full = list(args)
        for i, x in zip(wrt, xs):
            full[i] = x
        out = getattr(jops, fname)(*full, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.where(jnp.isfinite(o), o, 0.0).sum() for o in outs), outs

    (_, outs), grads = jax.value_and_grad(total, argnums=tuple(range(len(wrt))), has_aux=True)(
        *(args[i] for i in wrt))
    return (*outs, *grads)


@pytest.mark.multiprocess
@pytest.mark.parametrize("name", sorted(W.GLUE_GRADS))
def test_glue_gradient_on_dtensors(ranks, arrays, name):
    """The differentiable glue ops on sharded inputs that take a gradient:
    the outputs and the gradient of the sum of their finite entries equal
    ``jax.value_and_grad`` and the unsharded ``torch.autograd`` gradient;
    each gradient comes back in its input's placement."""
    key = f"grad_{name}"
    t = W.glue_grad(name, W.entry_args(name, arrays, lambda a, x: torch.from_numpy(x)))
    check(ranks, key, jax_glue_grad(name, arrays), t)
    wrt = [a for a in W.ENTRIES[name][1] if a in W.GLUE_GRADS[name]]
    got = placements(ranks[0][key]["out"])
    assert got[len(got) - len(wrt):] == [placement_of(a) for a in wrt], got
    assert hook_batches(ranks, key) == {name: B_LOCAL}


@pytest.mark.multiprocess
def test_indivisible_batch_alignment_is_replicated(ranks, arrays):
    """``viterbi_alignment`` of B = 3 over two ranks: replicated and run
    whole, the JAX alignment, the hook silent."""
    px, py, bnd = (arrays[k][:3] for k in ("px", "py", "boundary"))
    j = jops.viterbi_alignment(jnp.asarray(px), jnp.asarray(py), jnp.asarray(bnd))
    t = tops.viterbi_alignment(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(bnd))
    check(ranks, "indivisible_alignment", j, t)
    assert placements(ranks[0]["indivisible_alignment"]["out"]) == ["(Replicate(),)"] * 3
    assert ranks[0]["indivisible_alignment"]["hook"] == []


# --- the pipelines and the recursion, two ranks -----------------------------

def jax_pruned_step(lm, am, symbols, boundary):
    def loss_fn(lm_, am_):
        simple, pruned, r = jops.rnnt_loss_simple_pruned(lm_, am_, symbols, 0, W.PART_K, boundary,
                                                         reduction="sum")
        return 0.5 * simple + pruned, r

    (loss, r), grads = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(lm, am)
    return loss, grads, r


def jax_smoothed_step(lm, am, symbols, boundary):
    def loss_fn(lm_, am_):
        smoothed, pruned, r = jops.rnnt_loss_smoothed_pruned(lm_, am_, symbols, 0, W.PART_K,
                                                             boundary=boundary, reduction="sum",
                                                             **W.SMOOTH)
        return smoothed + 0.5 * pruned, r

    (loss, r), grads = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(lm, am)
    return loss, grads, r


def step_inputs(arrays, n=None):
    keys = ("lm", "am", "symbols", "boundary")
    return ([jnp.asarray(arrays[k][:n]) for k in keys], [torch.from_numpy(arrays[k][:n]) for k in keys])


@pytest.mark.multiprocess
@pytest.mark.parametrize("key", ["pruned_step", "smoothed_step"])
def test_pipeline_value_and_gradient(ranks, arrays, key):
    """tests/test_gspmd.py's pruned and smoothed pipelines: the value and
    the gradients w.r.t. (lm, am) of Shard(0) inputs; the smoothed one's
    d_lm holds the unigram's cross-shard term (a per-shard unigram mean
    misses it).  The gradients come back Shard(0); every kernel entry
    sees the per-shard batch."""
    j_in, t_in = step_inputs(arrays)
    jfn, tfn = (jax_pruned_step, W._pruned_step) if key == "pruned_step" else (
        jax_smoothed_step, W._smoothed_step)
    check(ranks, key, jfn(*j_in), tfn(*t_in))
    assert placements(ranks[0][key]["out"]) == ["(Partial(sum),)"] + ["(Shard(dim=0),)"] * 3
    seen = hook_batches(ranks, key)
    assert set(KERNELS) <= set(seen) and set(seen.values()) == {B_LOCAL}, seen


@pytest.mark.multiprocess
def test_non_batch_axis_sharded_resharded(ranks, arrays):
    """lm and am sharded on C are resharded to the batch: the unsharded
    batch's value and gradients, the gradients back on C (Shard(2)), the
    kernels per shard."""
    j_in, t_in = step_inputs(arrays)
    check(ranks, "non_batch", jax_pruned_step(*j_in), W._pruned_step(*t_in))
    assert placements(ranks[0]["non_batch"]["out"]) == [
        "(Partial(sum),)", "(Shard(dim=2),)", "(Shard(dim=2),)", "(Shard(dim=0),)"]
    assert set(hook_batches(ranks, "non_batch").values()) == {B_LOCAL}


@pytest.mark.multiprocess
def test_indivisible_batch_is_replicated(ranks, arrays):
    """B = 3 over two ranks: replicated and run whole on each rank,
    correct, with the hook silent; the gradients return to the inputs'
    uneven Shard(0)."""
    j_in, t_in = step_inputs(arrays, 3)
    check(ranks, "indivisible", jax_pruned_step(*j_in), W._pruned_step(*t_in))
    assert placements(ranks[0]["indivisible"]["out"]) == [
        "(Replicate(),)", "(Shard(dim=0),)", "(Shard(dim=0),)", "(Replicate(),)"]
    assert ranks[0]["indivisible"]["hook"] == [] and ranks[1]["indivisible"]["hook"] == []


@pytest.mark.multiprocess
def test_fused_recursion_kernel_wrapper(ranks, arrays):
    """``wavefront.fused_rows`` on rows sharded on axis 1 (banded): the
    JAX rows recursion's scores and occupancies, per shard (mi_fused)."""
    rows = [arrays[k] for k in ("px_rows", "py_rows", "boundary", "lo")]
    j = jops.mutual_information_rows(*map(jnp.asarray, rows), W.PART_K, calc_gradients=True)
    t = wavefront.fused_rows(*map(torch.from_numpy, rows), W.PART_K)
    check(ranks, "fused_rows", j, t)
    assert placements(ranks[0]["fused_rows"]["out"]) == ["(Shard(dim=0),)"] + ["(Shard(dim=1),)"] * 2
    assert hook_batches(ranks, "fused_rows") == {"mi_fused": B_LOCAL}


@pytest.mark.multiprocess
def test_split_recursion_kernel_wrappers(ranks, arrays):
    """``forward_rows`` then ``backward_rows`` seeded with ones on sharded
    rows (mi_fwd, mi_bwd): the JAX rows recursion's scores and
    occupancies."""
    rows = [arrays[k] for k in ("px_rows", "py_rows", "boundary")]
    _, (jgx, jgy) = out = jops.mutual_information_rows(*map(jnp.asarray, rows), calc_gradients=True)
    px, py, bnd = map(torch.from_numpy, rows)
    p, scores = wavefront.forward_rows(px, py, bnd)
    t = (scores, *wavefront.backward_rows(px, py, p, bnd, torch.ones_like(scores)))
    check(ranks, "split_rows", (out[0], jgx, jgy), t)
    assert hook_batches(ranks, "split_rows") == {"mi_fwd": B_LOCAL, "mi_bwd": B_LOCAL}


@pytest.mark.multiprocess
def test_split_recursion_scores_and_vjp(ranks, arrays):
    """The B-major scores op on Shard(0) px, py and its VJP: the JAX
    recursion's scores and ``jax.vjp``; the backward kernel entry runs in
    the partitioned call (mi_bwd at the per-shard batch)."""
    px, py, bnd = (arrays[k] for k in ("px", "py", "boundary"))
    scores, vjp = jax.vjp(lambda a, b: jops.mutual_information_recursion(a, b, jnp.asarray(bnd)),
                          jnp.asarray(px), jnp.asarray(py))
    j = (scores, *vjp(jnp.ones_like(scores)))
    tpx, tpy = torch.from_numpy(px).requires_grad_(), torch.from_numpy(py).requires_grad_()
    ts = tops.mutual_information_recursion(tpx, tpy, torch.from_numpy(bnd))
    check(ranks, "split_vjp", j, (ts, *torch.autograd.grad(ts.sum(), (tpx, tpy))))
    seen = hook_batches(ranks, "split_vjp")
    assert {"mi_fwd", "mi_bwd"} <= set(seen) and set(seen.values()) == {B_LOCAL}


@pytest.mark.multiprocess
def test_ranges_kernel_wrapper(ranks, arrays):
    """``ranges.window_starts`` on sharded occupancy rows (prune_ranges):
    the JAX rows ranges' window starts."""
    gx, gy, bnd = (arrays[k] for k in ("gx_rows", "gy_rows", "boundary"))
    j = jops.get_rnnt_prune_ranges_rows(jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(bnd), W.PART_K)
    t = ranges.window_starts(torch.from_numpy(gy), torch.from_numpy(gx), W.PART_K, torch.from_numpy(bnd),
                             W.PART_K)
    check(ranks, "window_starts", j[:, :, 0], t)
    assert hook_batches(ranks, "window_starts") == {"prune_ranges": B_LOCAL}


@pytest.mark.multiprocess
def test_smoothed_kernel_route_glue(ranks, arrays):
    """``latbuild.lattice_rows_smoothed`` (the kernel route's unigram,
    interpolation and parts op, its parts and VJP here the plain versions)
    partitioned on Shard(0): the JAX smoothed rows and the gradient of
    sum(exp(px)) + sum(exp(py)), d_uni summed across the shards."""
    from fast_rnnt_tpu_torch.ops.kernels import latbuild

    lm, am, sym, bnd = (arrays[k] for k in ("lm", "am", "symbols", "boundary"))

    def jtotal(lm_, am_):
        px, py = jops.get_rnnt_logprobs_smoothed_rows(lm_, am_, jnp.asarray(sym), 0, 0.15, 0.1,
                                                      jnp.asarray(bnd), "regular")
        return jnp.exp(px).sum() + jnp.exp(py).sum(), (px, py)

    (_, jrows), jg = jax.value_and_grad(jtotal, argnums=(0, 1), has_aux=True)(jnp.asarray(lm),
                                                                               jnp.asarray(am))
    tlm, tam = torch.from_numpy(lm).requires_grad_(), torch.from_numpy(am).requires_grad_()
    px, py = latbuild.lattice_rows_smoothed(tlm, tam, torch.from_numpy(sym), 0, 0.15, 0.1,
                                            torch.from_numpy(bnd), "regular", "plain")
    tg = torch.autograd.grad(px.exp().sum() + py.exp().sum(), (tlm, tam))
    check(ranks, "smoothed_glue", (*jrows, *jg), (px, py, *tg))
    assert hook_batches(ranks, "smoothed_glue") == {"lattice_rows_smoothed": B_LOCAL}


@pytest.mark.multiprocess
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_reduction_placement_and_value(ranks, arrays, reduction):
    """The reduction is taken on the Shard(0) loss: "none" stays Shard(0),
    "sum" is Partial(sum), "mean" Partial(avg) over the whole batch."""
    key = f"reduction_{reduction}"
    args = [arrays[k] for k in ("lm", "am", "symbols")]
    j = jops.rnnt_loss_simple(*map(jnp.asarray, args), 0, jnp.asarray(arrays["boundary"]),
                              reduction=reduction)
    t = tops.rnnt_loss_simple(*map(torch.from_numpy, args), 0, torch.from_numpy(arrays["boundary"]),
                              reduction=reduction)
    check(ranks, key, j, t)
    want = {"none": "(Shard(dim=0),)", "mean": "(Partial(avg),)", "sum": "(Partial(sum),)"}[reduction]
    assert placements(ranks[0][key]["out"]) == [want]


@pytest.mark.multiprocess
def test_no_collective_moves_a_lattice(ranks):
    """One step of each pipeline, the loss read back: no collective holds a
    T or T+1 dimension.  The pruned step's one collective is the loss's
    scalar all-reduce; the smoothed step adds only the [C] unigram's, in
    the forward and for its gradient."""
    for out in ranks:
        census = out["census"]
        for name, n_reduce in (("pruned", 1), ("smoothed", 3)):
            c = census[name]["census"]
            assert c["lattice_moves"] == [], (name, c)
            assert c["all-reduce"] == n_reduce, (name, c)
            assert all(c[k] == 0 for k in ("all-gather", "all-to-all", "collective-permute",
                                            "reduce-scatter", "broadcast")), (name, c)
        assert census["pruned"]["shapes"] == [[[]]]
        assert sorted(census["smoothed"]["shapes"]) == [[[]], [[W.PART_C]], [[W.PART_C]]]


# --- one rank, in this process ------------------------------------------------

@pytest.fixture
def hook_log(monkeypatch):
    log = []
    monkeypatch.setattr(partition, "_TRACE_HOOK", lambda name, b: log.append((name, int(b))))
    return log


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


def assert_bits(got, want, what):
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), f"{what}[{i}]"


@pytest.mark.parametrize("step", ["pruned", "smoothed"])
def test_plain_tensors_fall_through(arrays, hook_log, step):
    """Plain tensors take the wrapped function as it is: the same bits as
    the unwrapped loss, and the hook silent."""
    fn = W._pruned_step if step == "pruned" else W._smoothed_step
    inner = tops.rnnt_loss_simple_pruned if step == "pruned" else tops.rnnt_loss_smoothed_pruned
    _, t_in = step_inputs(arrays)
    assert_bits(fn(*t_in), fn(*t_in), step)
    assert hook_log == []
    lm, am, sym, bnd = t_in
    assert_bits(inner(lm, am, sym, 0, W.PART_K, boundary=bnd),
                inner.__wrapped__(lm, am, sym, 0, W.PART_K, boundary=bnd), f"{step} unwrapped")
    assert hook_log == []


@pytest.mark.parametrize("step", ["pruned", "smoothed"])
def test_one_rank_mesh_equals_plain_tensors(arrays, one_rank_mesh, hook_log, step):
    """Shard(0) DTensors on a one-rank mesh: the plain-tensor step's loss,
    gradients and ranges bit for bit, every entry at the whole batch."""
    fn = W._pruned_step if step == "pruned" else W._smoothed_step
    _, t_in = step_inputs(arrays)
    want = fn(*t_in)
    hook_log.clear()
    loss, grads, rng = fn(*(DTensor.from_local(x, one_rank_mesh, [Shard(0)]) for x in t_in))
    assert all(isinstance(x, DTensor) for x in (loss, *grads, rng))
    assert_bits((loss.full_tensor(), *(g.full_tensor() for g in grads), rng.full_tensor()),
                (want[0], *want[1], want[2]), step)
    seen = dict(hook_log)
    assert set(KERNELS) <= set(seen) and set(seen.values()) == {W.PART_B}


def test_ptr_rejects_a_tensor_without_storage(one_rank_mesh):
    """A DTensor (data_ptr 0) or a meta tensor handed to a kernel's pointer
    raises TypeError instead of passing a NULL pointer; a tensor with
    storage gives its address."""
    x = torch.ones(4, 3)
    with pytest.raises(TypeError, match="DTensor without storage"):
        _build.ptr(DTensor.from_local(x, one_rank_mesh, [Shard(0)]))
    with pytest.raises(TypeError, match="without storage"):
        _build.ptr(torch.empty(4, 3, device="meta"))
    assert _build.ptr(x) == x.data_ptr() and _build.ptr(None) is None


# --- every public op, one rank ------------------------------------------------

# public names that take no tensor
NO_BATCH = {"matmul_precision", "register_impl", "set_default_impl", "set_lattice_build_impl",
            "set_matmul_precision"}


def test_every_public_op_is_classified():
    """Each name of ``ops.__all__`` is partitioned (an entry of the
    worker's ENTRIES, run on two ranks above and one rank below), carried
    by DTensor (NATIVE, likewise), or takes no tensor; a new public name
    fails here until it is one of these.  The top level re-exports the
    same objects."""
    assert not set(W.ENTRIES) & set(W.NATIVE)
    assert set(tops.__all__) == set(W.ENTRIES) | set(W.NATIVE) | NO_BATCH
    for name in NO_BATCH:
        params = inspect.signature(getattr(tops, name)).parameters.values()
        assert not any("Tensor" in str(p.annotation) for p in params), name
    top = set(fast_rnnt_tpu_torch.__all__) - {"__version__"}
    assert top <= set(tops.__all__)
    assert all(getattr(fast_rnnt_tpu_torch, n) is getattr(tops, n) for n in top)


def dtensors(out):
    if isinstance(out, (tuple, list)):
        return [d for o in out for d in dtensors(o)]
    return [] if out is None else [out]


@pytest.mark.parametrize("name", sorted({**W.ENTRIES, **W.NATIVE}))
def test_public_op_takes_one_rank_dtensors(arrays, one_rank_mesh, hook_log, name):
    """Every public op that takes a batch, on Shard(0) DTensors (s-major
    rows Shard(1)) of a one-rank mesh: no error, DTensor outputs bit-equal
    to the plain-tensor call; a partitioned op runs as one partitioned call
    at the whole batch (the hook names it), a NATIVE one as DTensor ops."""
    table = W.ENTRIES if name in W.ENTRIES else W.NATIVE
    fname, _, kw = table[name]
    fn = W.entry_function(tops, fname)
    want = fn(*W.entry_args(name, arrays, lambda a, x: torch.from_numpy(x), table), **kw)
    hook_log.clear()
    place = {"(Shard(dim=1),)": Shard(1), "(Shard(dim=0),)": Shard(0)}
    got = fn(*W.entry_args(name, arrays, lambda a, x: DTensor.from_local(
        torch.from_numpy(x), one_rank_mesh, [place[placement_of(a)]]), table), **kw)
    outs = dtensors(got)
    assert outs and all(isinstance(d, DTensor) for d in outs), name
    assert_bits([d.full_tensor() for d in outs], dtensors(want), name)
    if name in W.ENTRIES:
        assert (name, W.PART_B) in hook_log and {b for _, b in hook_log} == {W.PART_B}, hook_log
    else:
        assert hook_log == []
