"""Operations and bytes of the work each layer needs, from shapes, and the
chip's published peaks.

Each count is what the inputs need, whatever implements it: inputs read
once, outputs written once, inside each utterance's boundary (s_end,
t_end), never the most that could be needed and never a residual that one
implementation keeps.  A layer's least time is the larger of its bytes
over the memory bandwidth and its operations over the peak of the unit
they need; its roofline share is that least time over the device time of
the kernels that do the work.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12  # tensor cores, float32 operands
BF16_FLOPS = 989e12  # tensor cores, bf16 / f16 operands
FP32_FLOPS = 67e12  # CUDA cores, float32 outside the tensor cores

# operations a lattice cell needs in one direction of the recursion: the two
# arc sums, the max, the difference, exp, log1p and the add of logaddexp,
# or the two arc weights exp(p + x - p') and their accumulation
CELL_OPS = 8

Work = Tuple[float, float]  # (operations, bytes)


def least_seconds(ops: float, nbytes: float, ops_peak: float) -> float:
    return max(ops / ops_peak, nbytes / HBM_BYTES_S)


def _cells(s_end: int, t_end: int) -> int:
    """px cells S_b x (T_b + 1) plus py cells (S_b + 1) x T_b of a regular
    lattice."""
    return s_end * (t_end + 1) + (s_end + 1) * t_end


def recursion_work(sizes: Iterable[Tuple[int, int]], s_range: int, lattice_bytes: int = 4) -> Work:
    """Stage 1 (scores and occupancies over the whole lattice) plus stage 2
    (scores and their gradient over the band of s_range rows a frame)."""
    ops = nbytes = 0.0
    for s_end, t_end in sizes:
        full = _cells(s_end, t_end)
        k = min(s_range, s_end + 1)
        band = k * t_end + min(s_range, s_end) * t_end
        # stage 1 reads px, py and writes their occupancies and the score
        nbytes += 2 * full * lattice_bytes + 4
        ops += 2 * CELL_OPS * full
        # stage 2 reads the band and writes the band's gradient and the score
        nbytes += 2 * band * lattice_bytes + 4
        ops += 2 * CELL_OPS * band
    return ops, nbytes


def build_work(sizes: Iterable[Tuple[int, int]], C: int, operand_bytes: int = 4,
               lattice_bytes: int = 4) -> Work:
    """The lattice build and its backward: am [T_b, C] and lm [S_b+1, C]
    and the symbols read once, px and py written once, d_am and d_lm
    written once; the normalizer product exp(lm) exp(am)^T and the two
    gradient products, 2 (S_b+1) T_b C operations each."""
    ops = nbytes = 0.0
    for s_end, t_end in sizes:
        rows = t_end + s_end + 1
        nbytes += 2 * rows * C * operand_bytes + 4 * s_end + _cells(s_end, t_end) * lattice_bytes
        ops += 3 * 2.0 * (s_end + 1) * t_end * C
    return ops, nbytes


def ranges_work(sizes: Iterable[Tuple[int, int]], s_range: int, occ_bytes: int = 4) -> Work:
    """The window search and repair: the occupancies read once, the int32
    windows [T_b, s_range] written once; a window sum, a difference and a
    compare per cell."""
    ops = nbytes = 0.0
    for s_end, t_end in sizes:
        nbytes += _cells(s_end, t_end) * occ_bytes + 4.0 * t_end * s_range
        ops += 3.0 * _cells(s_end, t_end)
    return ops, nbytes


def loss_step_work(sizes: Iterable[Tuple[int, int]], C: int, operand_bytes: int = 4) -> Work:
    """A whole loss step, value and gradient: am, lm, symbols and boundary
    read once, d_am and d_lm written once; the lattice's three products."""
    ops = nbytes = 0.0
    for s_end, t_end in sizes:
        rows = t_end + s_end + 1
        nbytes += 2 * rows * C * operand_bytes + 4 * s_end + 16
        ops += 3 * 2.0 * (s_end + 1) * t_end * C
    return ops, nbytes

