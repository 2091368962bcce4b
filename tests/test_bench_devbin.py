"""The benchmark's cell ``mut_modern_pair_devbin.device`` at a small size on
the CPU: its jobs (``--binning device``, the binning kernel's plain torch
version) come out correct by the harness's own check against the plain
reference (benchmark/reference/), the staged route's histograms agree with
the reference's float64 binning within float32 rounding and not when the
site stream is rounded to bfloat16, and the readers of the binning
kernel's roofline count what chip_smoke.py counts."""

from __future__ import annotations

import ast
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from benchmark.harness import check, generate, jobs, trace
from benchmark.harness.spec import Spec
from benchmark.metrics import _bin_ops
from benchmark.metrics._em_ops import bound_s
from benchmark.reference import binning as ref_binning
from benchmark.reference import join as ref_join

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "mut_modern_pair_devbin.device"
SEED = 2**31 + 29
# the cell's configuration at a size the CPU runs in seconds: two
# chromosomes of 40 and 35 Mb (four 30 Mb blocks) at 5e-4 rows a bp
SMALL = {"chromosomes": {"1": 40_000_000, "2": 35_000_000}, "mut_rows_per_bp": 5e-4,
         "num_bootstraps": 16}
# The program bins each site's terms and each 512-site chunk's partial in
# float32 (unit roundoff 6e-8; a chunk's sum of up to 512 terms can lose up
# to 512 of it) and sums the partials in float64; the reference bins in
# float64.  So each histogram may differ from the reference's by up to
# ~3e-5 of its largest entry; 2e-5 is the bound the port's binning is held
# to against the native float64 binning (tests/test_torch_binning.py).
HIST_REL = 2e-5


def hist_rel(ours, ref) -> float:
    """The largest deviation over four histograms, each relative to its own
    largest entry (an empty one counts as no deviation)."""
    worst = 0.0
    for a, b in zip(ours, ref, strict=True):
        scale = float(np.abs(b).max()) if np.size(b) else 0.0
        if scale > 0:
            worst = max(worst, float(np.abs(np.asarray(a) - b).max()) / scale)
    return worst


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cell's configuration (cut to SMALL), traffic and limits, and its
    inputs made from the seed."""
    spec = Spec(REPO)
    w = spec.workload(CELL)
    config = dict(spec.config(w), **SMALL)
    root = str(tmp_path_factory.mktemp("devbin"))
    return dict(config=config, traffic=spec.traffic(w), limits=spec.limits(w),
                inputs=generate.make_pair(root, config, SEED), root=root)


def test_the_configuration_is_the_modern_pair_binned_on_the_card():
    """Its inputs and jobs are mut_modern_pair's, key for key, so that a seed
    makes the same files and the two cells differ only in the route."""
    spec = Spec(REPO)
    ours = spec.config(spec.workload(CELL))
    auto = spec.config(spec.workload("mut_modern_pair.auto"))
    described = {"name", "source", "deployment", "em_precision", "assumed"}
    for key in auto.keys() - described:
        assert ours[key] == auto[key], key
    assert ours["binning"] == "device" and ours["reduced"] == ["chromosomes"]
    assert spec.traffic(spec.workload(CELL))["extra_args"] == ["--binning", "device"]


def test_the_cells_jobs_are_correct(cell, monkeypatch):
    """The cell's traffic through jobs.Runner on the CPU: every job written,
    each compared replicate's rates within the limit, and the sites and
    blocks exactly the reference's."""
    traffic = dict(cell["traffic"], check_jobs=2, check_within=3, check_replicates=16)
    # the Runner turns JSON progress records on for the process: undone after the test
    monkeypatch.setenv("COLATE_TPU_LOG", "json")
    runner = jobs.Runner(cell["config"], traffic, cell["inputs"], cell["root"], SEED, "cpu")
    first = traffic["warm_jobs"]
    assert runner.run(0, time.time() - time.perf_counter()).ok
    planned = check.plan(traffic, first, SEED)
    runner.keep = set(planned)
    window, _, _ = jobs.run_window(runner, first, 0.0, planned)
    checks, _ = check.check(cell["config"], traffic, cell["limits"], cell["inputs"], window,
                            planned, SEED, "cpu")
    assert check.correct(checks), checks
    assert checks["site_gap"]["value"] == 0 and checks["block_gap"]["value"] == 0
    assert cell["limits"]["site_gap"] == 0 and cell["limits"]["block_gap"] == 0
    for j in window:
        assert j.ok and j.result.counters["sites_binned"] == j.result.num_sites > 0
        assert {"decode", "join", "bin_prep", "bin_device"} <= j.timings.keys()


@pytest.fixture(scope="module")
def staged(cell):
    """The program's staged join of the cell's inputs, the reference's join,
    and the reference's float64 histograms."""
    from colate_tpu_torch import cli
    from colate_tpu_torch.models.mut_em import join_inputs

    p = cell["inputs"]
    args = cli.build_parser().parse_args(
        ["--mode", "mut", "--mut", p.mut_prefix, "--target_tmp", p.target, "--reference_tmp",
         p.reference, "--chr", p.chr_file, "--bins", cell["config"]["bins"], "--binning", "device",
         "-o", os.path.join(cell["root"], "staged")])
    sites = join_inputs(cli.mut_config(args))
    ref = ref_join.join(p.chroms, p.muts, p.target_stream, p.reference_stream)
    hists = ref_binning.bin_sites(ref.age_begin, ref.age_end, ref.w_shared, ref.w_notshared,
                                  ref.block, ref.num_blocks)
    return dict(sites=sites, ref=ref, hists=hists)


def test_staged_route_bins_as_the_reference(staged):
    from colate_tpu_torch.pipeline.binning import bin_sites_analytic

    sites, ref = staged["sites"], staged["ref"]
    assert len(sites) == len(ref) > 1000 and sites.num_blocks == ref.num_blocks == 4
    np.testing.assert_array_equal(sites.block_id, ref.block)
    ours = bin_sites_analytic(sites, 0.0, "cpu")
    assert 0 < hist_rel(ours, staged["hists"]) <= HIST_REL


def test_a_bfloat16_site_stream_is_seen(staged):
    """The same comparison fails when the stream's four float32 columns are
    first rounded to bfloat16 (8 bits of mantissa), a lower precision than
    the configuration states."""
    import dataclasses

    from colate_tpu_torch.ops.bin_kernel import bin_chunks, site_stream

    stream = site_stream(staged["sites"], 0.0)
    low = dataclasses.replace(stream, fv=stream.fv.to(torch.bfloat16).to(torch.float32))
    h = bin_chunks(low).numpy()
    assert hist_rel([h[:, j] for j in range(4)], staged["hists"]) > HIST_REL


class _Sites(types.SimpleNamespace):
    def __len__(self) -> int:
        return len(self.age_begin)


def _sites(n: int, seed: int):
    """n sites of every kind the binning meets: emp (age_begin 0) and
    regular, ages inside, across and beyond the table, zero-width and
    inverted intervals."""
    g = np.random.default_rng(seed)
    ae = np.exp(g.uniform(np.log(1e-3), np.log(1e6), n))
    ab = ae * g.uniform(0.0, 1.0, n)
    ab[g.random(n) < 0.25] = 0.0
    ab[:4], ae[:4] = [0.0, 3.0, 5.0, 2.0], [0.0, 3.0, 1.0, 5e7]
    return _Sites(age_begin=ab, age_end=ae)


@pytest.mark.parametrize("age", [0.0, 2.5])
def test_bin_ops_is_chip_smokes(age):
    import chip_smoke

    sites = _sites(400, 7)
    assert _bin_ops.bin_ops(sites, age) == chip_smoke.bin_ops(sites, age) > 0
    for a, b in zip(_bin_ops.bin_ranges(sites, age), chip_smoke.bin_ranges(sites, age)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("runs", [[5000, 3, 9000, 0], [1], [512, 513, 0, 4096 + 1]])
def test_bin_bytes_is_chip_smokes(runs):
    """chip_smoke.py's bytes of a binning: the kernel's inputs of the
    program's site stream, the edges and the histograms."""
    from colate_tpu_torch.ops.bin_kernel import site_stream

    block = np.repeat(np.arange(len(runs)), runs).astype(np.int32)
    n = block.size
    g = np.random.default_rng(3)
    sites = _Sites(age_begin=g.uniform(0, 10, n), age_end=g.uniform(10, 20, n),
                   w_shared=np.ones(n), w_notshared=np.ones(n), block_id=block,
                   num_blocks=len(runs) + 1)
    stream = site_stream(sites, 0.0)
    nb = sites.num_blocks
    in_bytes = sum(getattr(stream, name).nbytes for name in (
        "fv", "meta", "chunk_start", "chunk_n", "block_chunks", "seg_first", "block_seg"))
    assert _bin_ops.bin_bytes(block, nb) == in_bytes + 186 * 4 + nb * 4 * 185 * 8


def test_bin_ops_reader_imports_nothing_of_the_program():
    for name in ("_bin_ops.py", "bin_roofline.device.py"):
        path = os.path.join(REPO, "benchmark", "metrics", name)
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        mods = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                for a in node.names}
        mods |= {node.module for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
        assert all(m.split(".")[0] in ("__future__", "numpy", "benchmark") for m in mods), mods


def _ctx(cell_inputs, ops, n_ok=2, traced=True):
    from benchmark.harness import cell as cell_mod

    jl = []
    for i in range(n_ok + 1):
        j = jobs.Job(i, f"out{i}", None, 1)
        j.ok = i < n_ok
        jl.append(j)
    tr = trace.Trace(window_s=1.0, busy_s=0.0, ops=ops, idle={}) if traced else None
    return cell_mod.Context("first_pass", 9.5, 1.0, jl, tr, cell_inputs, {})


def test_bin_roofline_reads_the_binning_kernels(cell, staged):
    """The least time of the window's binnings (each job's the bound of the
    reference's join) over the binning kernels' device time, the EM kernel
    and copies left out; None without a trace or a binning kernel."""
    read = Spec(REPO).reader("bin_roofline.device")
    ops = [("(anonymous namespace)::seg_hist_kernel(float const*, long long)", 0.0, 3e-3),
           ("(anonymous namespace)::block_sum_kernel(double const*)", 3e-3, 3.5e-3),
           ("void (anonymous namespace)::em_kernel<true>(float const*)", 4e-3, 20e-3),
           ("Memcpy HtoD (Pinned -> Device)", 0.0, 1e-3)]
    ref = staged["ref"]
    least = bound_s(_bin_ops.bin_ops(ref, 0.0), _bin_ops.bin_bytes(ref.block, ref.num_blocks))
    value = read(_ctx(cell["inputs"], ops))
    assert value == pytest.approx(100.0 * 2 * least / 3.5e-3)
    assert read(_ctx(cell["inputs"], ops[2:])) is None
    assert read(_ctx(cell["inputs"], ops, traced=False)) is None
    assert read(_ctx(cell["inputs"], ops, n_ok=0)) is None


def test_the_cell_and_its_metrics_are_declared():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    (w,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert w["chips"] == 1 and w["config"] == "mut_modern_pair_devbin" and w["traffic"] == "device"
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["jobs_per_s"]["workloads"] == ["mut_modern_pair.auto", CELL]
    new = {"decode_ms.device": "program_span", "join_ms.device": "program_span",
           "bin_prep_ms.device": "program_span", "binning_ms.device": "program_span",
           "bin_roofline.device": "device_trace", "device_idle.device": "device_trace"}
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name, source in new.items():
        m = per_layer[name]
        assert (m["source"], m["moves"], m["workloads"]) == (source, "jobs_per_s", [CELL])
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", name + ".py"))
    s = Spec(REPO)
    assert {m["name"] for m in s.metrics(s.workload(CELL), True)} == set(new)
    assert {m["name"] for m in s.metrics(s.workload(CELL), False)} == {"jobs_per_s", "setup_s"}
