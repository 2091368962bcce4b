"""The control, the reference's EM in float32 with TF32 contractions in the
program's place, comes out not correct by the harness's own comparison
(``check.correct``) on the card at each cell's size, on three seeds, while
the program's answers come out correct.  The program's jobs run up to the
two the check compares."""

import json
import os
import shutil
import time

import pytest

from benchmark.harness import cell
from benchmark.harness.spec import Spec

from .conftest import REPO


@pytest.fixture
def full_repo(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for name in ("auto", "rerun"):
        path = root / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(check_jobs=2, check_within=2)
        path.write_text(json.dumps(t))
    return str(root)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mut_modern_pair.auto", "mut_ancient_panel.rerun"])
def test_control_is_not_correct(card, full_repo, name):
    spec = Spec(full_repo)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = cell.run(spec, name, seed, 0.0, False, card, time.perf_counter(), control=True)
        assert r["correct"], r["checks"]
        assert r["readings"]["control_correct"] is False, r["readings"]
        assert r["readings"]["control_rate_gap"] > r["checks"]["rate_gap"]["limit"], r["readings"]
