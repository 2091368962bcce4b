"""Structured progress records and device traces (from
colate_tpu/utils/progress.py: ``log_event`` and ``StageTimer`` copied;
``profile_trace`` runs ``torch.profiler`` where the JAX package runs
``jax.profiler``).

Every stage of a run reports through one hook that renders either
human-readable stderr lines (default) or JSON lines (``COLATE_TPU_LOG=json``)
for machine collection.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


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


class StageTimer:
    """Accumulates wall time per pipeline stage.

    >>> st = StageTimer()
    >>> with st.stage("parse"):
    ...     ...
    >>> st.timings["parse"]  # seconds
    """

    def __init__(self):
        self.timings: dict[str, float] = {}

    def stage(self, name: str):
        return _Stage(self, name)

    def report(self, **extra) -> None:
        log_event("timings", **{**self.timings, **extra})


class _Stage:
    def __init__(self, timer: StageTimer, name: str):
        self._t = timer
        self._name = name

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self._t.timings[self._name] = (
            self._t.timings.get(self._name, 0.0) + time.time() - self._t0
        )
        return False


@contextlib.contextmanager
def profile_trace():
    """Traces the body with ``torch.profiler`` (CPU activities, and CUDA
    ones where torch sees a card) when ``COLATE_TPU_TRACE`` names a
    directory, and writes a Chrome trace there
    (``<dir>/colate_tpu_torch.<pid>.<ns>.pt.trace.json``, for Perfetto or
    chrome://tracing); does nothing otherwise.  A body that raises
    writes no trace."""
    path = os.environ.get("COLATE_TPU_TRACE")
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from colate_tpu_torch._torch import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(path, f"colate_tpu_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    )
