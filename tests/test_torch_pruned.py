"""The pruned lattice's wrapper (``ops/kernels/pruned.py``) on the CPU: its
plain version against the JAX package's ``get_rnnt_logprobs_pruned``, and
the public function's CPU route bit for bit against the plain version,
values and gradients; the route rules; the launch and frame counts, the
arguments the kernels are handed and the no-copy hand-over of the rows to
the recursion, through a library that records its calls and launches
nothing.  The kernels themselves are held against the plain version on the
card (tests/test_torch_cuda.py)."""

import pytest
import torch

import fast_rnnt_tpu as jft
import fast_rnnt_tpu_torch as ft
from fast_rnnt_tpu_torch.ops import lattice, recursion
from fast_rnnt_tpu_torch.ops.kernels import _build, pruned
from fast_rnnt_tpu_torch.utils import profiling

from ._torch_parity import assert_lattice_close, jj, pruned_inputs, tt

RNNT_TYPES = ["regular", "modified", "constrained"]
NO_LAUNCH = {"band": 0, "rows": 0, "bwd": 0}


def _inputs(seed, dtype=torch.float32, **kw):
    logits, sym, rg, bnd = pruned_inputs(seed, **kw)
    return torch.tensor(logits, dtype=dtype), *tt(sym, rg, bnd)


def _values_and_grads(fn, logits, *args, **kw):
    """(px, py, d_logits) with random cotangents on every element of px and
    py, the -inf ones included."""
    x = logits.clone().requires_grad_()
    px, py = fn(x, *args, **kw)
    g = torch.Generator().manual_seed(0)
    gx = torch.randn(px.shape, generator=g).to(px.dtype)
    gy = torch.randn(py.shape, generator=g).to(py.dtype)
    (d,) = torch.autograd.grad((px, py), x, (gx, gy))
    return px.detach(), py.detach(), d


CASES = [
    dict(seed=1),
    dict(seed=2, edges=True, B=4),
    dict(seed=3, B=2, T=1, S=4, K=2),
    dict(seed=4, B=2, T=9, S=4, K=5),  # K = S + 1
    dict(seed=5, B=3, T=7, S=0, K=1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_version_and_the_cpu_route(case, rnnt_type, dtype):
    """The plain version's float32 px and py against the JAX package's on
    the same inputs (the lattice tolerance, -inf pattern exact); the public
    function on a CPU tensor, by default and under impl="plain", equal to
    the plain version bit for bit, values and gradients."""
    kw = CASES[case]
    logits, sym, rg, bnd = _inputs(dtype=dtype, **kw)
    if rnnt_type == "constrained" and kw.get("K", 3) < 2:
        with pytest.raises(ValueError, match="s_range >= 2"):
            ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, bnd, rnnt_type)
        return
    for b in (bnd, None):
        want = _values_and_grads(pruned.pruned_lattice_plain, logits, sym, rg, 0, b, rnnt_type)
        for impl in (None, "plain"):
            got = _values_and_grads(ft.get_rnnt_logprobs_pruned, logits, sym, rg, 0, b, rnnt_type,
                                    impl=impl)
            for a, w in zip(got, want):
                assert a.dtype == w.dtype and a.shape == w.shape
                assert torch.equal(a, w)
        if dtype == torch.float32:
            args = jj(logits.numpy(), sym.numpy(), rg.numpy())
            jb = None if b is None else jj(b.numpy())
            for a, w, what in zip(want, jft.get_rnnt_logprobs_pruned(*args, 0, jb, rnnt_type),
                                  ("px", "py")):
                assert_lattice_close(a, w, what)


def test_cpu_and_plain_take_the_plain_version(monkeypatch):
    logits, sym, rg, bnd = _inputs(6)
    monkeypatch.setattr(pruned, "LAUNCHES", dict(NO_LAUNCH))
    monkeypatch.setattr(pruned, "FRAMES", 0)
    want = pruned.pruned_lattice_plain(logits, sym, rg, 0, bnd)
    for impl in (None, "auto", "plain"):
        got = ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, bnd, impl=impl)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        assert got[0].is_contiguous()  # B-major, as the plain version makes it
    monkeypatch.setattr(lattice, "_LATTICE_BUILD_IMPL", "plain")
    got = ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, bnd)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert (pruned.LAUNCHES, pruned.FRAMES) == (NO_LAUNCH, 0)
    with pytest.raises(ValueError, match="cuda"):
        ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, bnd, impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ft.rnnt_loss_pruned(logits, sym, rg, 0, bnd, impl="cuda")


def test_loss_hands_impl_to_the_lattice(monkeypatch):
    """rnnt_loss_pruned passes its impl on to the pruned lattice's route."""
    logits, sym, rg, bnd = _inputs(13)
    seen = []
    route = pruned.pruned_lattice

    def keep(*a):
        seen.append(a[-1])
        return route(*a)

    monkeypatch.setattr(pruned, "pruned_lattice", keep)
    for impl in (None, "plain", "auto"):
        ft.rnnt_loss_pruned(logits, sym, rg, 0, bnd, impl=impl)
    assert seen == [None, "plain", "auto"]


def test_kernel_route_checks_its_inputs(monkeypatch):
    """Forced onto the kernel route, a CPU tensor is refused before any
    launch, as a float64 one would be on the card."""
    logits, sym, rg, bnd = _inputs(7)
    monkeypatch.setattr(pruned, "_build_kernel_route", lambda x, impl: True)
    with pytest.raises(TypeError, match="CUDA"):
        ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, bnd)
    with pytest.raises(IndexError, match="termination_symbol"):
        ft.get_rnnt_logprobs_pruned(logits, sym, rg, logits.shape[3], bnd)


def test_no_library_raises_without_falling_back(monkeypatch):
    logits, sym, rg, bnd = _inputs(8)
    monkeypatch.setattr(pruned, "_build_kernel_route", lambda x, impl: True)
    monkeypatch.setattr(pruned, "_check", lambda *a: None)
    monkeypatch.setattr(pruned, "LAUNCHES", dict(NO_LAUNCH))
    monkeypatch.setattr(pruned, "FRAMES", 0)

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")

    monkeypatch.setattr(_build, "load_library", no_library)
    monkeypatch.setattr(pruned, "pruned_lattice_plain", None)  # a fall-back would call it
    with pytest.raises(RuntimeError, match="nvcc"):
        ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, bnd)
    assert (pruned.LAUNCHES, pruned.FRAMES) == (NO_LAUNCH, 0)


class _Recorder:
    """The C entries: record the arguments, launch nothing, return success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(pruned, "_build_kernel_route", lambda x, impl: True)
    monkeypatch.setattr(pruned, "_check", lambda *a: None)
    monkeypatch.setattr(pruned, "LAUNCHES", dict(NO_LAUNCH))
    monkeypatch.setattr(pruned, "FRAMES", 0)
    return lib


# argument positions in the C entries (see csrc/pruned_rows.cu)
_BAND = dict(B=3, T=4, K=5, S=6, C=7, term_sym=8, term_col=9, sym64=10, rg64=11, dtype=12, vec=13)
_ROWS = dict(B=4, T=5, T1=6, K=7, S=8, mode=9, rg64=10, bnd64=11, dtype=12)
_BWD = dict(B=7, T=8, T1=9, K=10, S=11, C=12, term_sym=13, term_col=14, mode=15, sym64=16,
            rg64=17, bnd64=18, dtype=19, vec=20)


def _args(call, names):
    return {k: call[1][i] for k, i in names.items()}


@pytest.mark.parametrize("rnnt_type", RNNT_TYPES)
def test_launches_frames_and_arguments(recorder, rnnt_type):
    """Two launches forward, one backward, B x T frames a forward; rows of
    the recursion's s-major shapes, handed out as (B, S, T)-major views."""
    B, T, S, K, C = 3, 13, 6, 3, 12
    logits, sym, rg, bnd = _inputs(9, B=B, T=T, S=S, K=K, C=C)
    x = logits.requires_grad_()
    px, py = ft.get_rnnt_logprobs_pruned(x, sym.long(), rg, -1, bnd, rnnt_type)
    T1 = T + 1 if rnnt_type == "regular" else T
    assert px.shape == (B, S, T1) and py.shape == (B, S + 1, T)
    assert px.movedim(1, 0).is_contiguous() and py.movedim(1, 0).is_contiguous()
    assert (pruned.LAUNCHES, pruned.FRAMES) == ({"band": 1, "rows": 1, "bwd": 0}, B * T)
    assert [c[0] for c in recorder.calls] == ["frt_pruned_band", "frt_pruned_rows"]
    mode = RNNT_TYPES.index(rnnt_type)
    assert _args(recorder.calls[0], _BAND) == dict(
        B=B, T=T, K=K, S=S, C=C, term_sym=-1, term_col=C - 1, sym64=1, rg64=0, dtype=0, vec=4)
    assert _args(recorder.calls[1], _ROWS) == dict(
        B=B, T=T, T1=T1, K=K, S=S, mode=mode, rg64=0, bnd64=0, dtype=0)
    torch.autograd.grad((px.sum(), py.sum()), x)
    assert pruned.LAUNCHES == {"band": 1, "rows": 1, "bwd": 1} and pruned.FRAMES == B * T
    assert recorder.calls[2][0] == "frt_pruned_bwd"
    assert _args(recorder.calls[2], _BWD) == dict(
        B=B, T=T, T1=T1, K=K, S=S, C=C, term_sym=-1, term_col=C - 1, mode=mode, sym64=1,
        rg64=0, bnd64=0, dtype=0, vec=4)


def test_no_boundary_and_empty_band(recorder):
    """boundary None is a NULL pointer; a frame count of 0 launches only
    the rows kernel (regular: the -inf t = T column), and no C row none."""
    logits, sym, rg, _ = _inputs(10, B=2, T=5, S=3, K=2, C=8)
    ft.get_rnnt_logprobs_pruned(logits, sym, rg, 0, None)
    assert recorder.calls[1][1][3] is None
    recorder.calls.clear()
    px, py = ft.get_rnnt_logprobs_pruned(logits[:, :0], sym, rg[:, :0], 0, None)
    assert [c[0] for c in recorder.calls] == ["frt_pruned_rows"]
    assert px.shape == (2, 3, 1) and py.shape == (2, 4, 0)


@pytest.mark.parametrize("C,dtype,offset,want", [
    (500, torch.float32, 0, 4), (500, torch.bfloat16, 0, 4), (512, torch.bfloat16, 0, 8),
    (6, torch.float32, 0, 2), (7, torch.float16, 0, 1), (512, torch.float32, 1, 1),
    (512, torch.bfloat16, 2, 2),
])
def test_widest_load(C, dtype, offset, want):
    flat = torch.zeros(2 * 3 * 2 * C + offset, dtype=dtype)
    x = flat[offset:].view(2, 3, 2, C)
    assert pruned._vec(x) == want
    assert pruned._vec(x, torch.empty_like(x)) == want


def test_recursion_gets_the_rows_storage(recorder, monkeypatch):
    """rnnt_loss_pruned hands the kernels' rows to the recursion as they
    are: no copy."""
    logits, sym, rg, bnd = _inputs(12)
    made, seen = [], []
    route = pruned.pruned_lattice

    def keep(*a):
        out = route(*a)
        made.append([t.data_ptr() for t in out])
        return out

    def rows(px_rows, py_rows, boundary, **kw):
        seen.append([px_rows.data_ptr(), py_rows.data_ptr()])
        assert px_rows.is_contiguous() and py_rows.is_contiguous()
        return torch.zeros(px_rows.shape[1])

    monkeypatch.setattr(pruned, "pruned_lattice", keep)
    monkeypatch.setattr(recursion, "mutual_information_rows", rows)
    ft.rnnt_loss_pruned(logits, sym, rg, 0, bnd)
    assert made and seen == made


def test_counters_name_the_frames(monkeypatch):
    monkeypatch.setattr(pruned, "FRAMES", 96_000)
    c = profiling.counters()
    assert c["pruned_lattice.kernel_frames"] == 96_000
    assert "recursion.strip_blocks" in c
