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


@pytest.mark.parametrize("E", [1, 23, 40])
def test_smoke_em_ops_counts_each_branch(smoke, E):
    """em_ops (vectorised) against a walk over every replicate, bin and
    epoch that adds each branch's operations."""
    rng = np.random.default_rng(E)
    B, K = 3, smoke.K
    k = np.sort(rng.integers(0, E, size=185))
    sc = rng.uniform(size=(B, 185)) * (rng.uniform(size=(B, 185)) < 0.7)
    nc = rng.uniform(size=(B, 185)) * (rng.uniform(size=(B, 185)) < 0.7)
    iters = np.array([K, 125 * K, 0])
    want = 0.0
    for b in range(B):
        per_iter = smoke.EM_OPS_EPOCH * E
        for n in range(185):
            s, m = sc[b, n] != 0, nc[b, n] != 0
            per_iter += smoke.EM_OPS_BIN * (s or m)
            if s:
                per_iter += smoke.EM_OPS_BIN_S + smoke.EM_OPS_LOGL[0] / K
                per_iter += smoke.EM_OPS_S * sum(1 for e in range(E) if e <= k[n])
            if m:
                per_iter += smoke.EM_OPS_BIN_N[0 if k[n] < E - 1 else 1] + smoke.EM_OPS_LOGL[1] / K
                for e in range(E):
                    per_iter += (smoke.EM_OPS_N_BELOW if e < k[n] else
                                 smoke.EM_OPS_N_AT if e == k[n] else smoke.EM_OPS_N_ABOVE)
        want += iters[b] * per_iter
    assert smoke.em_ops(k, E, sc, nc, iters) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("ancient", [False, True])
def test_smoke_reads_the_coal(smoke, tmp_path, ancient):
    rng = np.random.default_rng(4)
    epochs = np.concatenate([[0.0], np.geomspace(50.0, 1e6, 9)])
    rates = rng.uniform(1e-6, 1e-3, size=(7, epochs.shape[0]))
    path = str(tmp_path / "x.coal")
    write_mut_coal(path, epochs, rates, is_ancient=ancient, ep_null=2 if ancient else 0)
    np.testing.assert_array_equal(smoke.read_coal_rates(path), CoalFile.read(path).rates)


def _edge_sites(age):
    """Sites whose ages sit on bin edges, beyond the table, or end before
    they begin."""
    from colate_tpu_torch.config import age_bin_edges
    from colate_tpu_torch.pipeline.join import JoinedSites

    e = age_bin_edges().astype(np.float32).astype(np.float64)
    ab = np.array([e[40], e[40], 0.0, age, age, e[3], 1e8, 0.0, e[184], age / 2, 5.0])
    ae = np.array([e[50], e[41], e[185], e[60], age / 2 + 1e-3, e[3], 2e8, 2e8, e[185], e[1], 5.0])
    n = ab.size
    return JoinedSites(age_begin=ab, age_end=ae, w_shared=np.ones(n), w_notshared=np.ones(n),
                       block_id=np.zeros(n, np.int32), num_blocks=1)


@pytest.mark.parametrize("case", ["age0", "age30", "beyond", "edges0", "edges30"])
def test_smoke_bin_ops_counts_the_non_zero_terms(smoke, case):
    """bin_ops (vectorised, over bin_ranges) against a walk over every site
    and bin of the dense formula in float32 that counts its non-zero terms,
    branch by branch."""
    from colate_tpu_torch.config import age_bin_edges
    from colate_tpu_torch.fixtures import beyond_table_sites, synthetic_sites

    age = 30.0 if case.endswith("30") else 0.0
    sites = {"age0": lambda: synthetic_sites(n=300, seed=3),
             "age30": lambda: synthetic_sites(n=300, seed=1, age=30.0),
             "beyond": lambda: beyond_table_sites(n=200),
             }.get(case, lambda: _edge_sites(age))()
    f = np.float32
    e = age_bin_edges().astype(f)
    a32 = f(age)
    want = 0.0
    for ab64, ae64 in zip(sites.age_begin, sites.age_end):
        ab, ae = f(ab64), f(ae64)
        if ab64 <= age:
            width = max(f(ae - ab), f(1e-30))
            cdf = [f(min(max(f((x - ab) / width), f(0)), f(1))) if x > a32 else f(0) for x in e]
            want += smoke.BIN_OPS_EMP_SITE
            for k in range(185):
                pe = f(cdf[k + 1] - cdf[k])
                if k == 184:
                    pe = f(pe + f(f(1) - cdf[185]))
                    want += smoke.BIN_OPS_EMP_LAST * (pe != 0)
                want += smoke.BIN_OPS_EMP * (pe != 0)
        else:
            a = max(ab, a32)
            ov = [max(f(min(ae, e[k + 1]) - max(a, e[k])), f(0)) for k in range(185)]
            if sum(ov) > 0:
                want += smoke.BIN_OPS_REG * sum(x > 0 for x in ov)
    assert smoke.bin_ops(sites, age) == want


@pytest.mark.parametrize("module, loaded", [("colate_tpu_torch", False), ("torch", True)])
def test_smoke_launcher_reports_torch_imports(smoke, module, loaded):
    """Phases 19 and 21 time a process from the wait4 launcher, which reads
    from the process's last stderr line whether it imported torch."""
    run = smoke.timed_process([sys.executable, "-c", smoke.IMPORT, module])
    assert run["torch"] is loaded and run["wall"] > 0 and run["max_rss_mb"] > 0


def test_smoke_runs_a_host_mode_without_torch(smoke, tmp_path):
    from colate_tpu_torch.fixtures import make_fixture

    fix = make_fixture(str(tmp_path), n_per_chrom=300, seed=3)
    out = str(tmp_path / "printed.txt")
    run = smoke.timed_process(smoke.mode_process([
        "--mode", "print_tmp", "--mut", fix["mut_prefix"], "--target_tmp", fix["target"],
        "--chr", fix["chrfile"], "-o", out]))
    assert not run["torch"] and os.path.getsize(out) > 0
