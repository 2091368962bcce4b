"""Structured progress records, the program's spans and counters, and
device traces (from colate_tpu/utils/progress.py: ``log_event`` copied;
``StageTimer`` grown from the JAX package's into the recorder of spans and
counters; ``profile_trace`` runs ``torch.profiler`` where the JAX package
runs ``jax.profiler``).

Every stage of a run reports through one hook that renders either
human-readable stderr lines (default) or JSON lines (``COLATE_TPU_LOG=json``)
for machine collection.  Spans, Python's and the native library's, are on
one clock, ``time.perf_counter_ns`` (CLOCK_MONOTONIC on Linux).  This
module imports no torch: host modes import it.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import NamedTuple


def _json_mode() -> bool:
    return os.environ.get("COLATE_TPU_LOG", "").lower() == "json"


def log_event(event: str, **fields) -> None:
    """One structured progress record."""
    if _json_mode():
        rec = {"event": event, "ts": time.time(), **fields}
        print(json.dumps(rec), file=sys.stderr, flush=True)
    else:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[colate_tpu] {event} {kv}", file=sys.stderr, flush=True)


class Span(NamedTuple):
    """One timed span of a run, in ``time.perf_counter_ns`` nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int | None = None   # its thread's CPU time, where measured
    worker: int | None = None   # its thread, for spans measured outside Python
    args: dict | None = None    # its counts


class StageTimer:
    """The recorder of a run's spans and counters.

    ``stage(name)`` times its body into ``spans`` and adds the seconds to
    ``timings[name]``, so ``timings[name]`` is the sum of the spans of that
    name; ``add_span`` records a span measured elsewhere (the native
    library's, per chromosome and worker), which ``timings`` leaves out;
    ``count`` adds to ``counters``.  A recorder may continue into the
    containers of an earlier one (a run's ``MutResult``).

    >>> st = StageTimer()
    >>> with st.stage("parse"):
    ...     ...
    >>> st.timings["parse"]  # seconds
    """

    def __init__(self, timings: dict | None = None, spans: list | None = None,
                 counters: dict | None = None):
        self.timings: dict[str, float] = {} if timings is None else timings
        self.spans: list[Span] = [] if spans is None else spans
        self.counters: dict[str, int] = {} if counters is None else counters

    def stage(self, name: str):
        return _Stage(self, name)

    def add_span(self, name: str, start_ns: int, end_ns: int, cpu_ns: int | None = None,
                 worker: int | None = None, args: dict | None = None) -> None:
        span = Span(name, start_ns, end_ns, cpu_ns, worker, args)
        self.spans.append(span)
        if _tracing is not None and worker is not None:
            _tracing.native.append(span)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def report(self, **extra) -> None:
        log_event("timings", **{**self.timings, **extra})


class _Stage:
    def __init__(self, timer: StageTimer, name: str):
        self._t = timer
        self._name = name
        self._range = None

    def __enter__(self):
        if _tracing is not None:
            self._range = _tracing.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        t = self._t
        t.spans.append(Span(self._name, self._t0, t1))
        t.timings[self._name] = t.timings.get(self._name, 0.0) + (t1 - self._t0) / 1e9
        return False


class _Tracing:
    """Set while :func:`profile_trace` records: the ``record_function`` that
    stages open, and the spans measured outside Python, for the export."""

    def __init__(self, record_function):
        self.record_function = record_function
        self.native: list[Span] = []


_tracing: _Tracing | None = None

TRACE_MARK = "colate_tpu_torch.trace"


@contextlib.contextmanager
def profile_trace():
    """Traces the body with ``torch.profiler`` (CPU activities, and CUDA
    ones where torch sees a card) when ``COLATE_TPU_TRACE`` names a
    directory, and writes a Chrome trace there
    (``<dir>/colate_tpu_torch.<pid>.<ns>.pt.trace.json``, for Perfetto or
    chrome://tracing); does nothing otherwise.  While it records, each
    :class:`StageTimer` stage is a ``record_function`` range, and the
    spans that native code measured are added to the trace as complete
    events, a row per worker, placed by the start of a mark range
    (``TRACE_MARK``) read on both clocks.  A body that raises writes no
    trace."""
    global _tracing
    path = os.environ.get("COLATE_TPU_TRACE")
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    from colate_tpu_torch._torch import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    tracing = _Tracing(record_function)
    with profile(activities=activities) as prof:
        with record_function(TRACE_MARK + ".warm"):  # the first range pays set-up
            pass
        t0 = time.perf_counter_ns()
        with record_function(TRACE_MARK):
            # the mark's start lies between the two readings around its opening
            t_mark = (t0 + time.perf_counter_ns()) // 2
            _tracing = tracing
            try:
                yield
            finally:
                _tracing = None
    out = os.path.join(path, f"colate_tpu_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(out)
    if tracing.native:
        _add_native_spans(out, tracing.native, t_mark)


def _add_native_spans(path: str, spans: list, t_mark: int) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events,
    on the trace's clock by the mark's start (``t_mark`` on perf_counter)."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    mark = next(e for e in events if e.get("name") == TRACE_MARK and e.get("ph") == "X")
    pid = "native spans"
    rows: dict = {}
    for s in spans:
        row = f"{s.name.split('.')[0]} worker {s.worker}"
        if row not in rows:
            rows[row] = len(rows)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": rows[row],
                           "args": {"name": row}})
        events.append({"ph": "X", "cat": "native", "name": s.name, "pid": pid, "tid": rows[row],
                       "ts": mark["ts"] + (s.start_ns - t_mark) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {**(s.args or {}), "cpu_ms": (s.cpu_ns or 0) / 1e6}})
    with open(path, "w") as fh:
        json.dump(trace, fh)
