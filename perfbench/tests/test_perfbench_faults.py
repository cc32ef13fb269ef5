"""A run of each cell, its look for a chip skipped, at a size a CPU test
can hold: sound, it is correct; with the control (the nearest precision
below the configuration's) or any fault the cell can have planted under
the timed call, ``correct`` comes out false."""

import importlib
import time

import pytest

from perfbench import harness
from perfbench.tests._layout import copy_layout

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _faults(cell):
    traffic = {w["name"]: w["traffic"] for w in SPEC["workloads"]}[cell]
    driver = harness.load_json(harness.ROOT / "perfbench" / "traffic" / f"{traffic}.json")["driver"]
    return importlib.import_module(f"perfbench.drivers.{driver}").FAULTS


PLANTED = [(c, f) for c in CELLS for f in ("control", *_faults(c))]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return copy_layout(tmp_path_factory.mktemp("layout"))


def _run(layout, cell, **plant):
    return harness.run(layout, cell, 2**31 + 77, 0.05, False, "cpu", time.perf_counter(), **plant)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(layout, cell):
    result, checks, _ = _run(layout, cell)
    assert result["correct"], checks


@pytest.mark.parametrize("cell,plant", PLANTED)
def test_planted_fault_is_not_correct(layout, cell, plant):
    kw = {"control": True} if plant == "control" else {"fault": plant}
    result, checks, _ = _run(layout, cell, **kw)
    assert not result["correct"], checks
