"""What the benchmark may load, and what it does without a card."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench.harness import FORBIDDEN, ROOT

BENCH = ROOT / "perfbench"


def _top_level_imports(path):
    """Top-level names of the modules a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        # whole top-level names: fast_rnnt_tpu_torch begins with fast_rnnt_tpu
        assert not _top_level_imports(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert "fast_rnnt_tpu_torch" not in _top_level_imports(f), f


def test_whole_name_comparison():
    assert not {"fast_rnnt_tpu_torch"} & FORBIDDEN and "fast_rnnt_tpu" in FORBIDDEN


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_without_a_card_fails_and_prints_no_result(trace):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "c500.long-recipe", "--seed",
         "2147483700", "--seconds", "1", "--trace", trace],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "metrics" not in res.stdout and "CUDA" in res.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run perfbench/tests on the card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_run_on_the_card(card):
    """A one-second run of the cell prints a correct result line, the
    numbers compared last."""
    import json

    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "c500.long-recipe", "--seed",
         "2147483701", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["kind"] == card
    assert list(out)[-1] == "checks"
