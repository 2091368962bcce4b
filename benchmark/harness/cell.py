"""One run of one cell: set-up, the measured window, the metrics, the check."""

from __future__ import annotations

import dataclasses
import gc
import shutil
import sys
import tempfile
import time

from benchmark.harness import check, generate, jobs, trace


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    kind: str                  # the traffic's jobs: first_pass or rerun
    setup_s: float
    window_s: float
    jobs: list                 # the window's jobs
    trace: object              # a trace.Trace of the window, or None
    inputs: object             # generate.PairInputs or PanelInputs
    config: dict


def run(spec, name: str, seed: int, seconds: float, traced: bool, device: str, t0: float,
        control: bool = False) -> dict:
    """The result of a run of the cell ``name`` (the result line's keys,
    ``checks`` last), timed from ``t0`` (perf_counter at the process's
    start)."""
    import torch

    w = spec.workload(name)
    config, traffic, limits = spec.config(w), spec.traffic(w), spec.limits(w)
    cuda = torch.device(device).type == "cuda"
    workdir = tempfile.mkdtemp(prefix="benchmark-")
    try:
        t_build = time.perf_counter()
        if cuda:
            jobs.load_program(config)
        t_build = time.perf_counter() - t_build
        t_inputs = time.perf_counter()
        if config["inputs"] == "colate_in":
            inputs = generate.make_pair(workdir, config, seed)
        else:
            inputs = generate.make_panel(workdir, config, seed, device)
        t_inputs = time.perf_counter() - t_inputs
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        runner = jobs.Runner(config, traffic, inputs, workdir, seed, device)
        n_warm = traffic["warm_jobs"]
        t_warm = time.perf_counter()
        for i in range(n_warm):
            warm = runner.run(i, time.time() - time.perf_counter())
            if not warm.ok:
                raise RuntimeError(f"the warm-up job failed: {warm.error}")
        t_warm = time.perf_counter() - t_warm
        planned = check.plan(traffic, n_warm, seed)
        runner.keep = set(planned)
        setup_s = time.perf_counter() - t0
        parts = {"build_s": t_build, "inputs_s": t_inputs, "warm_s": t_warm}
        print(f"setup: {setup_s:.3f} s, of which builds {t_build:.3f} s, inputs {t_inputs:.3f} s "
              f"({inputs.bytes_written} bytes written), warm-up {t_warm:.3f} s", file=sys.stderr)
        gc.collect()
        gc.freeze()              # the set-up's objects are not scanned again in the window
        with trace.Profiler(traced) as prof:
            window, start, length = jobs.run_window(runner, n_warm, seconds, planned)
        gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        tr = (trace.reduce(prof.events, prof.t_mark, start, length, window, runner.kind)
              if traced else None)
        ctx = Context(runner.kind, setup_s, length, window, tr, inputs, config)
        metrics = {}
        for m in spec.metrics(w, traced):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = None              # the trace's events are not needed past here
        checks, readings = check.check(config, traffic, limits, inputs, window, planned, seed,
                                       device, control)
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": w["chips"] if cuda else 1, "memory_peak_bytes": int(peak)}
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out = {"correct": check.correct(checks),
               "attempted": len(window), "failed": sum(not j.ok for j in window),
               "metrics": metrics, "device": dev}
        if tr is not None:
            out["breakdown"] = trace.breakdown(tr)
        out["setup_parts"] = parts
        if control:
            out["readings"] = readings
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
