"""chip_smoke.py off the card: it refuses to run without a CUDA device or
without the rest of the repo, and its two small helpers agree with what
they stand in for (the count generator of tests/test_em_pallas.py and
colate_tpu's ``.coal`` reader).  Exact comparisons: both sides compute
the same numbers from the same inputs."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from colate_tpu.config import age_bin_centers
from colate_tpu.formats.coal import CoalFile, write_mut_coal
from test_em_pallas import _synthetic_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_smoke_fails_without_a_card(where, tmp_path):
    cwd = REPO
    if where == "alone":
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    p = _run(cwd)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_smoke_counts_are_the_pallas_tests(smoke):
    for B, seed in ((5, 11), (6, 12)):
        ours = smoke.synthetic_counts(age_bin_centers(), B, seed)
        ref = _synthetic_counts(B, seed)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ancient", [False, True])
def test_smoke_reads_the_coal(smoke, tmp_path, ancient):
    rng = np.random.default_rng(4)
    epochs = np.concatenate([[0.0], np.geomspace(50.0, 1e6, 9)])
    rates = rng.uniform(1e-6, 1e-3, size=(7, epochs.shape[0]))
    path = str(tmp_path / "x.coal")
    write_mut_coal(path, epochs, rates, is_ancient=ancient, ep_null=2 if ancient else 0)
    np.testing.assert_array_equal(smoke.read_coal_rates(path), CoalFile.read(path).rates)
