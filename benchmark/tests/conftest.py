"""Fixtures of the benchmark's tests: a small copy of the benchmark to run on
the CPU, and the card for the tests marked ``cuda``."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SMALL = {
    "mut_modern_pair": {"chromosomes": {"1": 40_000_000, "2": 35_000_000},
                        "mut_rows_per_bp": 5e-4, "num_bootstraps": 16},
    "mut_ancient_panel": {"sites": 100_000, "panel_size": 3, "num_bootstraps": 16},
}


@pytest.fixture
def small_repo(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with the configurations cut
    to a size the CPU runs in seconds, and every replicate of two jobs
    compared."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for name, change in SMALL.items():
        path = root / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(change)
        path.write_text(json.dumps(cfg))
    for name in ("auto", "rerun"):
        path = root / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(check_jobs=2, check_within=3, check_replicates=16)
        path.write_text(json.dumps(t))
    return str(root)


@pytest.fixture
def card():
    """The CUDA device; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    import torch

    torch.set_num_threads(1)
