"""A copy of the benchmark's data layout in a temporary directory, with
the configurations and traffic cut to sizes that a CPU test can hold."""

import json
import shutil

from perfbench.harness import ROOT

TINY_CONFIG = {"fast-rnnt-c500": {"C": 9}}
TINY_TRAFFIC = {
    "long": {"B": 4, "T": 14, "S": 5},
    "long-recipe": {"B": 4, "T": 14, "S": 5},
}


def copy_layout(dst, tiny=True):
    """BENCHMARK.json and perfbench/'s data files under ``dst``; with
    ``tiny``, each configuration and traffic file cut as above."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "perfbench" / sub, dst / "perfbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    if tiny:
        for sub, cuts in (("configs", TINY_CONFIG), ("traffic", TINY_TRAFFIC)):
            for name, cut in cuts.items():
                path = dst / "perfbench" / sub / f"{name}.json"
                path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    return dst
