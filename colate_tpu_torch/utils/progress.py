"""Structured progress records and device traces (from
colate_tpu/utils/progress.py: ``log_event`` copied; ``profile_trace``
runs ``torch.profiler`` where the JAX package runs ``jax.profiler``).

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
