"""The window's end, the rates, the 95th percentile and the device's idle
share, on synthetic timings."""

import types

import numpy as np
import pytest

from benchmark.harness import cell, jobs, trace
from benchmark.harness.spec import Spec

from .conftest import REPO


def _job(i, t0, t1, ok=True, **timings):
    j = jobs.Job(i, f"out{i}", None, 1)
    j.t0, j.t1, j.ok, j.timings = t0, t1, ok, timings
    return j


def _ctx(kind, jl, window_s, tr=None):
    return cell.Context(kind, 9.5, window_s, jl, tr, None, {})


def test_window_ends_at_the_first_completion_after_its_length(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(jobs.time, "perf_counter", lambda: float(next(clock)))
    monkeypatch.setattr(jobs.time, "time", lambda: 0.0)

    class Runner:
        def run(self, i, off):
            t0 = jobs.time.perf_counter()
            return _job(i, t0, jobs.time.perf_counter())

    done, start, length = jobs.run_window(Runner(), 1, 2.0)
    # the start reads 0.0, each job two ticks: the 4th ends at 2.0
    assert [j.index for j in done] == [1, 2, 3, 4] and length == 2.0
    clock2 = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(jobs.time, "perf_counter", lambda: float(next(clock2)))
    done, _, length = jobs.run_window(Runner(), 1, 2.0, until=[6])
    assert done[-1].index == 6 and length == 3.0


def test_rates_and_tail():
    spec = Spec(REPO)
    jl = [_job(i, i * 0.1, i * 0.1 + 0.1, em=0.02) for i in range(20)]
    jl[3].ok = False
    ctx = _ctx("rerun", jl, 2.0)
    assert spec.reader("reruns_per_s")(ctx) == pytest.approx(19 / 2.0)
    assert spec.reader("jobs_per_s")(ctx) == pytest.approx(19 / 2.0)
    walls = [j.wall for j in jl]
    assert spec.reader("rerun_p95_ms")(ctx) == pytest.approx(np.percentile(walls, 95) * 1e3)
    assert spec.reader("em_ms.rerun")(ctx) == pytest.approx(20.0)
    assert spec.reader("host_ms.rerun")(ctx) == pytest.approx(80.0)
    assert spec.reader("setup_s")(ctx) == 9.5
    # a first-pass cell has no reruns, and a rerun cell no first-pass layers
    assert spec.reader("reruns_per_s")(_ctx("first_pass", jl, 2.0)) is None
    assert spec.reader("parse_ms.job")(ctx) is None
    assert spec.reader("device_idle.rerun")(ctx) is None


def _ev(name, a, b, cuda=True):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                 device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_idle_share_is_the_union_of_device_intervals():
    # the mark starts at profiler time 1000 us = perf 10.0 s; the window 10.0 .. 10.01 s
    ev = [_ev(trace.MARK, 1000.0, 20000.0, cuda=False),
          _ev("em_kernel", 1000.0, 3000.0), _ev("Memcpy", 2500.0, 4000.0),   # 3 ms, overlapping
          _ev("em_kernel", 6000.0, 7000.0), _ev("late", 11500.0, 12000.0)]    # 1 ms; after the window
    j = _job(0, 10.0, 10.01, em=0.004, parse=0.0)
    j.events = {"mut_suffstats": 10.002, "mut_em": 10.007, "mut_done": 10.008}
    tr = trace.reduce(ev, 10.0, 10.0, 0.01, [j], "rerun")
    assert tr.busy_s == pytest.approx(0.004)
    assert tr.op_seconds()["em_kernel"] == pytest.approx(0.003)
    assert tr.idle["em"] == pytest.approx(0.003)   # 10.003 .. 10.005, 10.006 .. 10.007
    assert "colate_mat_read" not in tr.idle
    assert tr.idle["coal_write"] == pytest.approx(0.001)
    assert tr.idle["harness"] == pytest.approx(0.002)
    assert sum(tr.idle.values()) == pytest.approx(0.006)
    spec = Spec(REPO)
    ctx = _ctx("rerun", [j], 0.01, tr)
    assert spec.reader("device_idle.rerun")(ctx) == pytest.approx(60.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["em_kernel", pytest.approx(0.003)]
    assert [n for n, _ in b["idle_gaps"]][:2] == ["em", "harness"]
