"""A later change adds a configuration, a traffic mix, a cell and a metric
as new files only: the harness finds each by its name."""

import json
import time

from perfbench import harness
from perfbench.tests._layout import copy_layout


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    root = copy_layout(tmp_path, tiny=False)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    b = root / "perfbench"
    (b / "configs" / "tiny-loss.json").write_text(json.dumps(
        {"C": 6, "s_range": 3, "rnnt_type": "regular", "blank_id": 0,
         "simple_scale": 0.5, "pruned_scale": 1.0, "dtype": "float32", "matmul_precision": "highest"}))
    (b / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"driver": "loss_step", "pipeline": "simple_pruned", "B": 3, "T": 10, "S": 4, "batches": 2,
         "sizes_seed": 3, "t_end": [0.5, 1.0], "s_end": [0.5, 1.0], "trace_cycles": 1}))
    (b / "limits" / "tiny.cell.json").write_text(json.dumps(
        {"simple_rel": 1e-5, "pruned_rel": 1e-5, "lattice_err": 1e-4, "ranges_cover_gap": 1e-3}))
    (b / "metrics" / "tiny.cycles.py").write_text("def read(ctx):\n    return ctx['cycles']\n")
    # a BENCHMARK.json that only gains entries
    spec["configs"].append({"name": "tiny-loss", "source": "a test", "file": "perfbench/configs/tiny-loss.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.cell", "config": "tiny-loss", "traffic": "tiny-mix",
                              "chips": 1, "why": "a test"})
    # the new cell reports a step time: it joins that metric's cells
    next(m for m in spec["end_to_end"] if m["name"] == "loss_step_ms")["workloads"].append("tiny.cell")
    spec["end_to_end"].append({"name": "tiny.cycles", "unit": "cycles", "better": "higher",
                               "bound": 0.01, "source": "host_clock", "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, checks, ctx = harness.run(root, "tiny.cell", 2**31 + 9, 0.05, False, "cpu",
                                      time.perf_counter())
    assert result["correct"], checks
    assert result["metrics"]["tiny.cycles"]["value"] == ctx["cycles"] >= 1
    assert set(result["metrics"]) == {"setup_s", "loss_step_ms", "peak_mem_mib", "tiny.cycles"}
    # the simple_pruned pipeline's windows are held too
    shifted, checks, _ = harness.run(root, "tiny.cell", 2**31 + 9, 0.05, False, "cpu",
                                     time.perf_counter(), fault="ranges_shifted")
    assert not shifted["correct"] and checks["ranges_cover_gap"][0] > 1e-3, checks
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    old = json.loads(before[root / "BENCHMARK.json"])
    assert all(spec[k][: len(old[k])] == old[k] for k in ("configs", "workloads", "per_layer"))


def test_cell_metrics_follow_workloads_keys():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        e2e = harness.cell_metrics(spec, w["name"], False)
        layer = harness.cell_metrics(spec, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        moved = {m["name"]: m["moves"] for m in spec["per_layer"]}
        assert all(moved[m] in e2e for m in layer)
        for m in e2e + layer:
            assert (harness.ROOT / "perfbench" / "metrics" / f"{m}.py").exists()
