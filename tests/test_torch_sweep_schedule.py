"""The host side of the diagonal-sweep launches
(``fast_rnnt_tpu_torch/ops/kernels/wavefront.py``) on the CPU: how many
128-row strips a launch sweeps at once, the counters and scratch it hands
the kernel, the int32 check on the fused scratch, and the block counter
that ``utils.profiling.counters`` exposes.  The C entries are replaced by a
recorder, so the wrappers run their host code up to the launch with CPU
tensors; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from fast_rnnt_tpu_torch.ops.kernels import _build, wavefront
from fast_rnnt_tpu_torch.utils import profiling

from ._torch_parity import rows_inputs

H100_SMS = 132  # one 160.5 KB sweep block an SM


@pytest.mark.parametrize("S, strips", [(0, 1), (126, 1), (127, 1), (128, 2), (255, 2), (256, 3),
                                       (1200, 10), (2600, 21), (16895, 132), (16896, 133)])
def test_strips_of_a_lattice(S, strips):
    """S+1 lattice rows in strips of 128: the grid's strips, and the
    backward's hand-off rows."""
    assert wavefront._strips(S) == strips
    assert wavefront._strips(S) == -(-(S + 1) // 128)


@pytest.mark.parametrize("S, resident, at_once", [
    (0, H100_SMS, 1), (127, H100_SMS, 1), (128, H100_SMS, 2), (1200, H100_SMS, 10),
    (16895, H100_SMS, 132), (16896, H100_SMS, 1), (1200, 9, 1), (1200, 10, 10)])
def test_strips_at_once_only_where_an_utterance_fits(S, resident, at_once):
    """All strips at once where one utterance's blocks can all be resident
    (a block then waits only on running blocks); else, and at one strip,
    one block an utterance."""
    assert wavefront._strips_at_once(S, resident) == at_once


def test_counters_and_fused_scratch_sizes():
    """A ticket and a forward and a backward progress count per
    (utterance, strip); the fused scratch holds p and one hand-off row a
    strip."""
    assert wavefront._counters(8, 10) == 1 + 2 * 8 * 10
    assert wavefront._counters(1, 2) == 5


def test_int32_check_covers_the_hand_off_rows():
    """The fused scratch has S+1+strips rows of (B, T+1) floats: a shape
    whose S+3 rows would fit int32 indexing but whose S+1+strips do not is
    refused."""
    S, B = 1200, 1
    rows = S + 1 + wavefront._strips(S)
    T = -(-(2**31) // rows) - 1  # rows * (T+1) just reaches 2^31
    assert (S + 3) * (T + 1) < 2**31 <= rows * (T + 1)
    with pytest.raises(ValueError, match="int32"):
        wavefront._check_index(S, B, T, rows)
    wavefront._check_index(S, B, T - 100, rows)


class _Recorder:
    """The C entries of the sweep launches: record the arguments, launch
    nothing, return success."""

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
    monkeypatch.setattr(wavefront, "_kernel_route", lambda x, impl: True)
    monkeypatch.setattr(wavefront, "_resident", lambda dev: H100_SMS)

    def check_cpu(px_rows, py_rows, boundary, lo, extra=()):
        S, B, T1 = px_rows.shape
        T = py_rows.shape[2]
        return S, B, T1, T, wavefront._STORAGE[px_rows.dtype]

    monkeypatch.setattr(wavefront, "_check_cuda", check_cpu)
    index = []
    check_index = wavefront._check_index
    monkeypatch.setattr(wavefront, "_check_index",
                        lambda S, B, T, rows: index.append(rows) or check_index(S, B, T, rows))
    monkeypatch.setitem(wavefront.BLOCKS, "sweep", wavefront.BLOCKS["sweep"])
    monkeypatch.setattr(wavefront, "LAUNCHES", {k: 0 for k in wavefront.LAUNCHES})
    lib.index = index
    return lib


# (entry, position of nk in its arguments)
_NK_AT = {"frt_sweep_fwd": 13, "frt_sweep_bwd": 16, "frt_wavefront_fused": 15}


@pytest.mark.parametrize("S", [5, 128, 300])
def test_launches_hand_the_kernel_its_schedule(recorder, S):
    """Each sweep launch passes nk = strips at once and counters of 1 + 2 B
    nk ints (NULL at one strip), checks the fused scratch of S+1+strips
    rows, and counts B x nk blocks, which ``profiling.counters`` reads."""
    B, T = 3, 40
    px, py, bnd = (torch.from_numpy(a) for a in rows_inputs(S, B=B, S=S, T=T))
    nk = wavefront._strips_at_once(S, H100_SMS)
    start = profiling.counters()["recursion.strip_blocks"]
    p, scores = wavefront.forward_rows(px, py, bnd)
    wavefront.backward_rows(px, py, p, bnd, torch.ones(B))
    wavefront.fused_rows(px, py, bnd)
    assert [name for name, _ in recorder.calls] == list(_NK_AT)
    for name, args in recorder.calls:
        at = _NK_AT[name]
        assert args[at] == nk, name
        assert (args[at + 1] is None) == (nk == 1), name
    assert recorder.index == [S + 1, S + 1, S + 1 + wavefront._strips(S)]
    assert wavefront.LAUNCHES == {"fwd": 1, "bwd": 1, "fused": 1}
    assert profiling.counters()["recursion.strip_blocks"] - start == 3 * B * nk
    assert wavefront.BLOCKS["sweep"] - start == 3 * B * nk


def test_serial_schedule_past_the_resident_blocks(recorder, monkeypatch):
    """More strips than blocks the device holds: one block an utterance, no
    counters, B blocks counted."""
    monkeypatch.setattr(wavefront, "_resident", lambda dev: 2)
    px, py, bnd = (torch.from_numpy(a) for a in rows_inputs(7, B=2, S=300, T=20))
    start = wavefront.BLOCKS["sweep"]
    wavefront.fused_rows(px, py, bnd)
    (name, args), = recorder.calls
    assert args[_NK_AT[name]] == 1 and args[_NK_AT[name] + 1] is None
    assert wavefront.BLOCKS["sweep"] - start == 2


def test_cpu_tensors_count_no_blocks():
    """The plain route launches nothing and counts no block."""
    px, py, bnd = (torch.from_numpy(a) for a in rows_inputs(3, B=2, S=200, T=12))
    start = dict(wavefront.BLOCKS)
    out = wavefront.fused_rows(px, py, bnd)
    assert wavefront.BLOCKS == start
    assert np.isfinite(out[0].numpy()).all()
