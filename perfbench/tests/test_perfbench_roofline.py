"""Operation and byte counts of perfbench/roofline.py against numbers worked
by hand."""

import json

import pytest

from perfbench import generate, roofline
from perfbench.harness import ROOT


def test_headline_shape_counts():
    # one utterance of the headline shape: s_end = 100, t_end = 1000, C = 500
    # cells: px 100 x 1001 = 100,100, py 101 x 1000 = 101,000 -> 201,100
    # band: 5 py rows and 5 px rows a frame over 1,000 frames -> 10,000
    ops, nbytes = roofline.recursion_work([(100, 1000)], 5)
    assert nbytes == 2 * 201_100 * 4 + 4 + 2 * 10_000 * 4 + 4 == 1_688_808
    assert ops == 2 * 8 * 201_100 + 2 * 8 * 10_000 == 3_377_600
    # build: am 1,000 and lm 101 rows of 500 floats, read and their
    # gradients written: 2 x 1,101 x 500 x 4 = 4,404,000; symbols 400;
    # px and py 201,100 x 4 = 804,400; three products of 101 x 1,000 x 500
    ops, nbytes = roofline.build_work([(100, 1000)], 500)
    assert nbytes == 4_404_000 + 400 + 804_400 == 5_208_800
    assert ops == 3 * 2 * 101 * 1000 * 500 == 303_000_000
    ops, nbytes = roofline.ranges_work([(100, 1000)], 5)
    assert nbytes == 804_400 + 4 * 1000 * 5 == 824_400 and ops == 3 * 201_100
    ops, nbytes = roofline.loss_step_work([(100, 1000)], 500)
    assert nbytes == 4_404_000 + 400 + 16 and ops == 303_000_000
    # the batch of 30 such utterances: 30 times each count; the build is
    # bound by its bytes (156.3 MB at 3.35 TB/s = 46.65 us) and not by its
    # products (9.09 GFLOP at 495 TFLOP/s = 18.36 us)
    ops, nbytes = roofline.build_work([(100, 1000)] * 30, 500)
    assert nbytes == 30 * 5_208_800 and ops == 30 * 303_000_000
    assert roofline.least_seconds(ops, nbytes, roofline.TF32_FLOPS) == pytest.approx(
        156_264_000 / 3.35e12, rel=1e-12)



def test_long_shape_counts():
    # one utterance of the long traffic's largest shape: s_end = 1,200,
    # t_end = 12,000; cells px 1,200 x 12,001 = 14,401,200, py 1,201 x
    # 12,000 = 14,412,000 -> 28,813,200; band 5 + 5 rows x 12,000 = 120,000
    ops, nbytes = roofline.recursion_work([(1200, 12000)], 5)
    assert nbytes == 230_505_600 + 4 + 960_000 + 4 == 231_465_608
    assert ops == 461_011_200 + 1_920_000 == 462_931_200
    # build: 13,201 rows of 500 floats read and written, 52,804,000;
    # symbols 4,800; the lattice 115,252,800; three 1,201 x 12,000 x 500
    # products: 43.236 GFLOP, bound by its products at 495 TFLOP/s
    ops, nbytes = roofline.build_work([(1200, 12000)], 500)
    assert nbytes == 52_804_000 + 4_800 + 115_252_800 == 168_061_600
    assert ops == 43_236_000_000
    assert roofline.least_seconds(ops, nbytes, roofline.TF32_FLOPS) == ops / 495e12


def test_long_traffic_sizes():
    traffic = json.loads((ROOT / "perfbench/traffic/long-recipe.json").read_text())
    sizes = generate.lattice_sizes(traffic)
    assert len(sizes) == traffic["batches"] == 4
    for s in sizes:
        assert s.shape == (8, 2)
        assert (600 <= s[:, 0]).all() and (s[:, 0] <= 1200).all()
        assert (6000 <= s[:, 1]).all() and (s[:, 1] <= 12000).all()
    # the sizes come from the file, never from --seed
    again = generate.lattice_sizes(traffic)
    assert all((a == b).all() for a, b in zip(sizes, again))
