"""The device trace of a run's window (``--trace 1``): ``torch.profiler``
over the whole window, reduced to the device's busy time (the union of
the intervals of the operations that ran on the card), each operation's
total, and the idle time sorted by what the host was doing.

The host's phases of a job come from the job's own records: its start
and end, and the times of the program's ``mut_suffstats``, ``mut_em`` and
``mut_done`` records, with the bootstrap's duration from its timings.
"""

from __future__ import annotations

import dataclasses
import time

MARK = "benchmark_window"
NAME_CHARS = 120          # of a device operation's name in the breakdown


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list          # (name, start, end) in perf_counter seconds, clipped to the window
    idle: dict         # host phase -> idle seconds of the device

    def op_seconds(self) -> dict:
        out: dict = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return out


class Profiler:
    """``torch.profiler`` (host and device activity) around a window, marked
    by a span whose start ties the profiler's clock to perf_counter; does
    nothing when not ``enabled``.  ``events`` holds its events after it."""

    def __init__(self, enabled: bool):
        self.enabled, self.events = enabled, None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile, record_function

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark = record_function(MARK)
            self._mark.__enter__()
            self.t_mark = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._mark.__exit__(*exc)
            self._prof.__exit__(*exc)
            self.events = self._prof.events()
        return False


def union(spans: list) -> list:
    """Disjoint sorted intervals covering ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_phases(job, kind: str) -> list:
    """(name, start, end) of a job's phases, in perf_counter seconds."""
    ev, t0, t1 = job.events, job.t0, job.t1
    if not {"mut_suffstats", "mut_em", "mut_done"} <= ev.keys():
        return [("job", t0, t1)]
    s, e, d = ev["mut_suffstats"], ev["mut_em"], ev["mut_done"]
    if kind == "first_pass":
        b = s - job.timings.get("bootstrap", 0.0)
        head = [("parse", t0, b), ("bootstrap", b, s)]
    else:
        head = [("colate_mat_read", t0, s)]
    return head + [("em", s, e), ("coal_write", e, d), ("harness", d, t1)]


def reduce(events, t_mark: float, start: float, length: float, jobs: list, kind: str) -> Trace:
    """The window's trace from the profiler's events; ``t_mark`` is the
    perf_counter time at which the mark began."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name == MARK]
    if not marks:
        raise RuntimeError("the profiler recorded no window mark")
    # profiler microseconds -> perf_counter seconds, by the mark's start
    shift = t_mark - marks[0].time_range.start / 1e6
    end = start + length
    ops = []
    for e in events:
        # the mark's range is recorded on the device too, over the whole window
        if e.device_type == DeviceType.CUDA and e.name != MARK:
            a = max(e.time_range.start / 1e6 + shift, start)
            b = min(e.time_range.end / 1e6 + shift, end)
            if b > a:
                ops.append((e.name, a, b))
    busy = union([(a, b) for _, a, b in ops])
    busy_s = sum(b - a for a, b in busy)
    gaps, t = [], start
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    phases = [p for j in jobs for p in host_phases(j, kind)]
    idle: dict = {}
    for a, b in gaps:
        covered = 0.0
        for name, p0, p1 in phases:
            o = min(b, p1) - max(a, p0)
            if o > 0:
                idle[name] = idle.get(name, 0.0) + o
                covered += o
        if b - a - covered > 0:
            idle["harness"] = idle.get("harness", 0.0) + (b - a - covered)
    return Trace(window_s=length, busy_s=busy_s, ops=ops, idle=idle)


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time and the idle time by
    the host's phase, as the result line's ``breakdown``."""
    top = sorted(tr.op_seconds().items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr.idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
