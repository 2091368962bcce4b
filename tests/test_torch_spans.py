"""The recorder of mode ``mut``'s spans and counters (utils/progress.py:
StageTimer): the native spans of the fused parse (native/io.cpp, read
through pipeline/join.py), the stages and counters of a job
(models/mut_em.py), the whole-job trace of ``COLATE_TPU_TRACE``, and the
benchmark's readers of them (benchmark/metrics/)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from colate_tpu_torch import cli
from colate_tpu_torch.fixtures import make_fixture
from colate_tpu_torch.formats.colate_mat import write_colate_mat
from colate_tpu_torch.config import NUM_AGE_BINS, age_bin_centers
from colate_tpu_torch.models.mut_em import run_mut_and_write
from colate_tpu_torch.pipeline.join import fused_tmptmp_stream, mut_prefilter_native
from colate_tpu_torch.utils.progress import StageTimer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROMS = ("1", "2", "3")
# over 2 MiB of .mut a chromosome, so that the prefilter may shard it
ROWS = 40_000

STAGES = {
    "first_pass": {"parse", "prefilter", "join_bin", "bootstrap", "epochs", "em", "coal_write"},
    "rerun": {"colate_mat_read", "epochs", "em", "coal_write"},
}
# every job's .coal write (formats/coal.py:write_mut_coal)
COAL_COUNTERS = {"coal_bytes", "coal_values"}
COUNTERS = {
    "first_pass": {"cpus_allowed", "prefilter_workers", "join_bin_workers"} | COAL_COUNTERS,
    "rerun": {"cpus_allowed", "colate_mat_workers"} | COAL_COUNTERS,
}


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("spans")), chroms=CHROMS, n_per_chrom=ROWS,
                        seed=11)


def _mut_files(fix):
    return [f"{fix['mut_prefix']}_chr{c}.mut" for c in CHROMS]


@pytest.fixture(scope="module")
def parse(fix):
    """The two native calls on a recorder, with perf_counter_ns read just
    before and just after each."""
    st = StageTimer()
    a0 = time.perf_counter_ns()
    pf = mut_prefilter_native(_mut_files(fix), None, None, 0.0, recorder=st)
    a1 = time.perf_counter_ns()
    hists, num_sites, num_blocks = fused_tmptmp_stream(
        pf, list(CHROMS), fix["target"], fix["reference"], recorder=st)
    b1 = time.perf_counter_ns()
    return dict(st=st, prefilter=(a0, a1), join_bin=(a1, b1), num_sites=num_sites,
                num_blocks=num_blocks)


def _spans(st, name):
    return [s for s in st.spans if s.name == name]


def test_native_spans_lie_inside_their_calls(parse):
    st = parse["st"]
    assert {s.name for s in st.spans} == {"prefilter.chrom", "prefilter.shard", "join_bin.scan",
                                          "join_bin.join", "join_bin.bin"}
    for s in st.spans:
        lo, hi = parse[s.name.split(".")[0]]
        assert lo <= s.start_ns <= s.end_ns <= hi, s


def test_one_prefilter_span_per_chromosome_holding_its_shards(parse):
    st = parse["st"]
    chroms = _spans(st, "prefilter.chrom")
    assert sorted(s.args["chrom"] for s in chroms) == list(range(len(CHROMS)))
    for c in chroms:
        shards = [s for s in _spans(st, "prefilter.shard") if s.args["chrom"] == c.args["chrom"]]
        assert sorted(s.args["part"] for s in shards) == list(range(len(shards)))
        for s in shards:
            assert c.start_ns <= s.start_ns <= s.end_ns <= c.end_ns
        assert sum(s.args["rows_read"] for s in shards) == c.args["rows_read"] == ROWS
        assert sum(s.args["rows_kept"] for s in shards) == c.args["rows_kept"]


def test_rows_kept_are_the_prefiltered_rows(fix, parse):
    """Each chromosome's rows kept are the rows that pass mode mut's
    pre-stream filters in the JAX package (colate_tpu/pipeline/join.py,
    coal.cpp:2150-2176), on its own reader's columns."""
    from colate_tpu.formats.mut import MutTable
    from colate_tpu.pipeline.join import allele_codes

    kept = []
    for path in _mut_files(fix):
        mt = MutTable.read(path)
        _, _, valid = allele_codes(mt)
        kept.append(int(((mt.flipped == 0) & (mt.num_branches == 1)
                         & (mt.age_begin < mt.age_end) & (mt.age_end >= 0.0) & valid).sum()))
    chroms = _spans(parse["st"], "prefilter.chrom")
    by_chrom = {s.args["chrom"]: s.args["rows_kept"] for s in chroms}
    assert [by_chrom[i] for i in range(len(CHROMS))] == kept
    assert sum(kept) < sum(s.args["rows_read"] for s in chroms) == ROWS * len(CHROMS)


def test_sites_joined_sum_to_num_sites(parse):
    st = parse["st"]
    joins, bins = _spans(st, "join_bin.join"), _spans(st, "join_bin.bin")
    assert sorted(s.args["chrom"] for s in joins) == list(range(len(CHROMS)))
    assert sum(s.args["sites"] for s in joins) == parse["num_sites"]
    assert parse["num_sites"] > 0
    assert {(s.args["chrom"], s.args["sites"]) for s in bins} == {
        (s.args["chrom"], s.args["sites"]) for s in joins}
    assert sum(s.args["blocks"] for s in bins) == parse["num_blocks"]
    by_chrom = {s.args["chrom"]: s for s in joins}
    for b in bins:
        assert by_chrom[b.args["chrom"]].end_ns <= b.start_ns
        assert by_chrom[b.args["chrom"]].worker == b.worker
    scans = _spans(st, "join_bin.scan")
    assert sorted(s.args["part"] for s in scans) == [0, 1]
    assert all(s.args["runs"] == len(CHROMS) for s in scans)


def _cpu_clock_step_ns() -> int:
    """The step of the thread CPU clock: nanoseconds on most Linux hosts, a
    scheduler tick (10 ms) on some virtualised ones."""
    clock = time.CLOCK_THREAD_CPUTIME_ID
    steps = []
    for _ in range(2):
        c = time.clock_gettime_ns(clock)
        while (d := time.clock_gettime_ns(clock)) == c:
            pass
        steps.append(d - c)
    return max(steps)


def test_workers_and_thread_cpu_time(parse):
    """Worker counts are the native code's choices; each span's CPU time is
    its own thread's, no more than its wall time and one step of the CPU
    clock."""
    st = parse["st"]
    assert 1 <= st.counters["join_bin_workers"] <= len(CHROMS)
    assert st.counters["prefilter_workers"] >= 1
    step = _cpu_clock_step_ns()
    for s in st.spans:
        assert s.worker >= 0
        assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns + step + 1_000_000, (s, step)
    # the shards a chromosome's thread parsed itself run on its worker
    for c in _spans(st, "prefilter.chrom"):
        shards = [s for s in _spans(st, "prefilter.shard") if s.args["chrom"] == c.args["chrom"]]
        if len(shards) == 1:
            assert shards[0].worker == c.worker
        else:
            assert c.worker not in {s.worker for s in shards}
            assert len({s.worker for s in shards}) == len(shards)


def _job(fix, out, *extra):
    args = cli.build_parser().parse_args(
        ["--mode", "mut", "--bins", "3,7,0.2", "--num_bootstraps", "4", "--seed", "3",
         "--torch_device", "cpu", "-o", out, *extra])
    return run_mut_and_write(cli.mut_config(args), "cpu")


@pytest.fixture(scope="module")
def jobs(fix, tmp_path_factory):
    """A first-pass job on the .colate.in fixture and a rerun from a
    .colate_mat, each on the CPU."""
    root = tmp_path_factory.mktemp("jobs")
    first = _job(fix, str(root / "first"), "--mut", fix["mut_prefix"], "--target_tmp",
                 fix["target"], "--reference_tmp", fix["reference"], "--chr", fix["chrfile"])
    rng = np.random.default_rng(5)
    counts = rng.uniform(0.0, 2.0, (2, 4, NUM_AGE_BINS))
    write_colate_mat(str(root / "rerun.colate_mat"), age_bin_centers(), *counts)
    rerun = _job(fix, str(root / "rerun"), "--target_bcf", str(root / "absent"), "--target_age",
                 "8000")
    return {"first_pass": first, "rerun": rerun}


@pytest.mark.parametrize("kind", ["first_pass", "rerun"])
def test_a_job_carries_every_stage_and_counter(jobs, kind):
    res = jobs[kind]
    assert STAGES[kind] <= {s.name for s in res.spans} and STAGES[kind] <= res.timings.keys()
    assert set(res.counters) == COUNTERS[kind]
    assert res.counters["cpus_allowed"] == len(os.sched_getaffinity(0))
    if kind == "first_pass":
        joins = [s for s in res.spans if s.name == "join_bin.join"]
        assert sum(s.args["sites"] for s in joins) == res.num_sites
    else:
        assert 1 <= res.counters["colate_mat_workers"] <= res.counters["cpus_allowed"]
    assert res.counters["coal_values"] > 0 and res.counters["coal_bytes"] > 0


def test_the_done_record_carries_the_counters(fix, tmp_path, monkeypatch, capsys):
    """``COLATE_TPU_LOG=json``: a job's ``mut_done`` record holds its
    counters, where an operator reads the CPUs allowed and the workers."""
    monkeypatch.setenv("COLATE_TPU_LOG", "json")
    capsys.readouterr()
    res = _job(fix, str(tmp_path / "logged"), "--mut", fix["mut_prefix"], "--target_tmp",
               fix["target"], "--reference_tmp", fix["reference"], "--chr", fix["chrfile"])
    recs = [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]
    (done,) = [r for r in recs if r["event"] == "mut_done"]
    assert done["counters"] == res.counters
    assert set(done["counters"]) == COUNTERS["first_pass"]
    assert done["counters"]["coal_bytes"] == os.path.getsize(tmp_path / "logged.coal")
    assert done["counters"]["coal_values"] > 0


def test_the_rerun_done_record_carries_the_reader_workers(tmp_path, monkeypatch, capsys):
    """A rerun's ``mut_done`` record holds ``colate_mat_workers``, how wide
    the ``.colate_mat`` read ran, beside ``cpus_allowed``."""
    monkeypatch.setenv("COLATE_TPU_LOG", "json")
    rng = np.random.default_rng(6)
    write_colate_mat(str(tmp_path / "again.colate_mat"), age_bin_centers(),
                     *rng.uniform(0.0, 2.0, (2, 4, NUM_AGE_BINS)))
    capsys.readouterr()
    res = _job(None, str(tmp_path / "again"), "--target_bcf", str(tmp_path / "absent"),
               "--target_age", "8000")
    recs = [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]
    (done,) = [r for r in recs if r["event"] == "mut_done"]
    assert done["counters"] == res.counters
    assert set(done["counters"]) == COUNTERS["rerun"]
    assert done["counters"]["colate_mat_workers"] >= 1
    assert done["counters"]["coal_bytes"] == os.path.getsize(tmp_path / "again.coal")
    assert done["counters"]["coal_values"] > 0


@pytest.mark.parametrize("kind", ["first_pass", "rerun"])
def test_timings_are_the_sums_of_their_spans(jobs, kind):
    res = jobs[kind]
    for name, seconds in res.timings.items():
        spans = [s for s in res.spans if s.name == name]
        assert seconds == pytest.approx(sum(s.end_ns - s.start_ns for s in spans) / 1e9,
                                        rel=1e-12, abs=0), name
    # a stage is measured in Python: no worker, no CPU time
    assert all(s.worker is None and s.cpu_ns is None for s in res.spans if s.name in res.timings)


def test_prefilter_and_join_bin_nest_in_parse(jobs):
    res = jobs["first_pass"]
    (parse,) = [s for s in res.spans if s.name == "parse"]
    (pre,) = [s for s in res.spans if s.name == "prefilter"]
    (jb,) = [s for s in res.spans if s.name == "join_bin"]
    assert parse.start_ns <= pre.start_ns <= pre.end_ns <= jb.start_ns <= jb.end_ns <= parse.end_ns
    for s in res.spans:
        if s.name.startswith("prefilter."):
            assert pre.start_ns <= s.start_ns <= s.end_ns <= pre.end_ns
        if s.name.startswith("join_bin."):
            assert jb.start_ns <= s.start_ns <= s.end_ns <= jb.end_ns
    # the stages of a job follow one another
    order = ["parse", "bootstrap", "epochs", "em", "coal_write"]
    spans = {s.name: s for s in res.spans if s.name in order}
    for a, b in zip(order, order[1:]):
        assert spans[a].end_ns <= spans[b].start_ns


def test_trace_covers_the_whole_job(fix, tmp_path, monkeypatch, capsys):
    """COLATE_TPU_TRACE=<dir>: the job's stages as record_function ranges
    and the native spans as complete events, a row per worker, placed
    inside the stage that made them."""
    monkeypatch.setenv("COLATE_TPU_TRACE", str(tmp_path / "trace"))
    res = _job(fix, str(tmp_path / "traced"), "--mut", fix["mut_prefix"], "--target_tmp",
               fix["target"], "--reference_tmp", fix["reference"], "--chr", fix["chrfile"])
    capsys.readouterr()
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    assert STAGES["first_pass"] <= ranges.keys()
    native = [e for e in events if e.get("cat") == "native"]
    assert sorted(e["name"] for e in native) == sorted(
        s.name for s in res.spans if s.worker is not None)
    rows = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name" and e["pid"] == "native spans"}
    workers = {(s.name.split(".")[0], s.worker) for s in res.spans if s.worker is not None}
    assert sorted(rows.values()) == sorted(f"{p} worker {w}" for p, w in workers)
    for e in native:
        stage = ranges[e["name"].split(".")[0]]
        assert rows[(e["pid"], e["tid"])].startswith(e["name"].split(".")[0])
        # the mark is read a few microseconds after its range opens
        assert stage["ts"] - 100 <= e["ts"] and e["ts"] + e["dur"] <= stage["ts"] + stage["dur"] + 100
        assert e["args"]["cpu_ms"] >= 0


def test_a_stage_outside_a_trace_opens_no_range(monkeypatch):
    """Stages open torch.profiler ranges only while profile_trace records."""
    from colate_tpu_torch.utils import progress

    assert progress._tracing is None
    opened = []
    monkeypatch.setattr(progress, "_tracing", progress._Tracing(lambda n: opened.append(n) or _Null()))
    st = StageTimer()
    with st.stage("a"):
        pass
    st.add_span("b.x", 1, 2, cpu_ns=1, worker=0)
    st.add_span("c", 1, 2)
    assert opened == ["a"] and [s.name for s in progress._tracing.native] == ["b.x"]
    monkeypatch.setattr(progress, "_tracing", None)
    with st.stage("d"):
        pass
    assert opened == ["a"] and st.timings.keys() == {"a", "d"}


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_progress_imports_no_torch():
    """utils/progress.py, which host modes import, imports no torch; nor
    does recording stages, spans and counters."""
    code = ("import sys\n"
            "from colate_tpu_torch.utils.progress import StageTimer\n"
            "st = StageTimer()\n"
            "with st.stage('parse'):\n"
            "    st.add_span('prefilter.chrom', 1, 2, cpu_ns=1, worker=0)\n"
            "    st.count('prefilter_workers', 3)\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "COLATE_TPU_TRACE": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ---- the benchmark's readers of the spans --------------------------------------------


NEW_METRICS = {"prefilter_ms.job": "first_pass", "join_bin_ms.job": "first_pass",
               "parse_cpu_ms.job": "first_pass", "colate_mat_read_ms.rerun": "rerun",
               "coal_write_ms.rerun": "rerun"}


def _ctx(kind, results, ok=True):
    from benchmark.harness import cell
    from benchmark.harness.jobs import Job

    jl = []
    for i, res in enumerate(results):
        j = Job(i, f"out{i}", None, 1)
        j.t0, j.t1, j.ok, j.result = i * 0.1, i * 0.1 + 0.09, ok, res
        j.timings = dict(res.timings) if res is not None else {}
        jl.append(j)
    return cell.Context(kind, 9.5, 2.0, jl, None, None, {})


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_metric_readers(jobs, metric):
    """Each new reader reads its cell's jobs, and returns None for the other
    traffic kind, for failed jobs and for a program whose results carry
    neither the stages nor the spans."""
    from benchmark.harness.spec import Spec

    read = Spec(REPO).reader(metric)
    kind = NEW_METRICS[metric]
    other = "rerun" if kind == "first_pass" else "first_pass"
    res = jobs[kind]
    value = read(_ctx(kind, [res, res]))
    if metric == "parse_cpu_ms.job":
        # a host whose thread CPU clock steps by 10 ms can read 0 for this small job
        want = sum(s.cpu_ns for s in res.spans if s.cpu_ns is not None) / 1e6
        assert value == pytest.approx(want) and value >= 0
    else:
        want = res.timings[metric.split("_ms.")[0]] * 1e3
        assert value == pytest.approx(want) and value > 0
    assert read(_ctx(other, [res, res])) is None
    assert read(_ctx(kind, [res], ok=False)) is None

    class Parent:  # a result of the program before the recorder
        timings = {"parse": 0.5, "bootstrap": 0.01, "em": 0.02}

    assert read(_ctx(kind, [Parent(), None])) is None


def test_metric_readers_are_declared():
    """Each new reader is a per-layer metric of its cell in BENCHMARK.json."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    cells = {"first_pass": "mut_modern_pair.auto", "rerun": "mut_ancient_panel.rerun"}
    for name, kind in NEW_METRICS.items():
        m = per_layer[name]
        assert m["source"] == "program_span" and m["workloads"] == [cells[kind]]
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", name + ".py"))


# ---- the staged .colate.in route and the device binning ------------------------------

DEVICE_STAGES = {"parse": ("decode", "join"), "binning": ("bin_prep", "bin_device")}
DEVICE_COUNTERS = {"cpus_allowed", "sites_binned", "bin_chunks", "bin_h2d_bytes"} | COAL_COUNTERS


@pytest.fixture(scope="module")
def device_job(fix, tmp_path_factory):
    """A ``--binning device`` job on the .colate.in fixture on the CPU (the
    kernel's plain torch version), its progress records kept, and the site
    stream of its inputs as the route lays it out."""
    import contextlib
    import io

    from colate_tpu_torch.models.mut_em import join_inputs
    from colate_tpu_torch.ops.bin_kernel import site_stream

    out = str(tmp_path_factory.mktemp("device") / "dev")
    argv = ["--mut", fix["mut_prefix"], "--target_tmp", fix["target"], "--reference_tmp",
            fix["reference"], "--chr", fix["chrfile"], "--binning", "device"]
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(log):
        mp.setenv("COLATE_TPU_LOG", "json")
        res = _job(fix, out, *argv)
    recs = {r["event"]: r for r in map(json.loads, log.getvalue().splitlines())}
    args = cli.build_parser().parse_args(["--mode", "mut", "--bins", "3,7,0.2", "-o", out, *argv])
    return dict(res=res, recs=recs, stream=site_stream(join_inputs(cli.mut_config(args))))


def test_device_route_nests_its_stages(device_job):
    """``decode`` then ``join`` inside ``parse``, ``bin_prep`` then
    ``bin_device`` inside ``binning``; no child outlasts its parent."""
    res = device_job["res"]
    spans = {}
    for s in res.spans:
        assert s.name not in spans, s.name      # one span each
        spans[s.name] = s
    for parent, (first, second) in DEVICE_STAGES.items():
        p, a, b = spans[parent], spans[first], spans[second]
        assert p.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= p.end_ns
        for child in (a, b):
            assert child.end_ns - child.start_ns <= p.end_ns - p.start_ns
            assert res.timings[child.name] <= res.timings[parent]
    assert spans["parse"].end_ns <= spans["binning"].start_ns
    assert spans["binning"].end_ns <= spans["bootstrap"].start_ns
    assert not {"prefilter", "join_bin"} & spans.keys()


def test_device_route_counts_the_stream(device_job):
    """The counters are the job's sites and its site stream's chunks and
    bytes: four float32 columns and an int32 word a site, the chunk table."""
    res, stream = device_job["res"], device_job["stream"]
    assert set(res.counters) == DEVICE_COUNTERS
    assert res.counters["sites_binned"] == res.num_sites == stream.n_sites > 0
    assert res.counters["bin_chunks"] == stream.n_chunks > 0
    table = 16 * stream.n_chunks + 4 * (stream.n_chunks + stream.n_segs + 1 + stream.num_blocks + 1)
    assert res.counters["bin_h2d_bytes"] == stream.nbytes == 20 * stream.n_sites + table


def test_device_route_records_its_route_and_counters(device_job):
    recs = device_job["recs"]
    assert recs["mut_suffstats"]["binning"] == "torch-twin:float32(cpu)"
    assert recs["mut_done"]["counters"] == device_job["res"].counters


def test_the_auto_route_keeps_its_spans(jobs):
    """The fused path records none of the staged or device stages."""
    res = jobs["first_pass"]
    names = {s.name for s in res.spans}
    assert not names & {"decode", "join", "bin_prep", "bin_device"}
    assert STAGES["first_pass"] <= names and res.timings["binning"] == 0.0


DEVICE_METRICS = {"decode_ms.device": "decode", "join_ms.device": "join",
                  "bin_prep_ms.device": "bin_prep", "binning_ms.device": "binning"}


@pytest.mark.parametrize("metric", sorted(DEVICE_METRICS))
def test_device_metric_readers(device_job, metric):
    """Each reader of the device cell's stages reads its stage's mean, and
    None for reruns, failed jobs and a program that lacks the stage."""
    from benchmark.harness.spec import Spec

    read = Spec(REPO).reader(metric)
    res = device_job["res"]
    value = read(_ctx("first_pass", [res, res]))
    assert value == pytest.approx(res.timings[DEVICE_METRICS[metric]] * 1e3) and value > 0
    assert read(_ctx("rerun", [res, res])) is None
    assert read(_ctx("first_pass", [res], ok=False)) is None

    class Parent:  # a result of the program before the staged route's stages
        timings = {"parse": 0.5, "bootstrap": 0.01, "em": 0.02}

    assert read(_ctx("first_pass", [Parent()])) is None
