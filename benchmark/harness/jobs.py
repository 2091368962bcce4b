"""The jobs of a cell and the measured window.

A job is one mode ``mut`` run of the program, as its command line makes
it: ``cli.mut_config`` of the job's arguments, then
``models/mut_em.py:run_mut_and_write``; it ends when its ``.coal`` is
written.  Jobs run one after another (a closed loop of one client).  The
traffic mix says which jobs:

- ``first_pass``: a job over the configuration's ``.colate.in`` pair, a new
  bootstrap seed and output each;
- ``rerun``: a rerun of the panel's pairs in turn, each from its
  ``<out>.colate_mat``, writing its ``<out>.coal``.

The program's progress records (``COLATE_TPU_LOG=json``) go to a buffer
while a job runs and give the times at which it finished reading its
inputs (``mut_suffstats``), its EM (``mut_em``) and its ``.coal``
(``mut_done``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np


def load_program(config: dict) -> None:
    """Load the program's compiled libraries that the configuration's jobs
    call, building those the checkout lacks (the EM kernel; for
    ``colate_in`` inputs also the native parse, join and binning), so that
    a run reports its build time apart from its inputs and warm-up."""
    from colate_tpu_torch.ops import em_kernel

    em_kernel.kernel_library()
    if config["inputs"] == "colate_in":
        from colate_tpu_torch import native

        native.load()


@dataclasses.dataclass
class Job:
    index: int
    out: str                  # the output prefix
    pair: int | None          # the panel's pair of a rerun
    seed: int                 # its --seed
    t0: float = 0.0           # perf_counter at its start and end
    t1: float = 0.0
    ok: bool = False
    error: str = ""
    timings: dict = dataclasses.field(default_factory=dict)
    events: dict = dataclasses.field(default_factory=dict)   # name -> perf_counter time
    result: object = None     # the program's MutResult
    kept_coal: str = ""       # where its .coal was kept for the check

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


class Runner:
    """Makes and runs the jobs of one cell."""

    def __init__(self, config: dict, traffic: dict, inputs, workdir: str, seed: int, device: str):
        from colate_tpu_torch import cli

        self.cli, self.config, self.traffic = cli, config, traffic
        self.inputs, self.workdir, self.device = inputs, workdir, device
        self.kind = traffic["jobs"]
        if (self.kind, config["inputs"]) not in (("first_pass", "colate_in"), ("rerun", "colate_mat")):
            raise ValueError(f"jobs {self.kind!r} on inputs {config['inputs']!r}")
        self.parser = cli.build_parser()
        self.seeds = np.random.default_rng([seed, 1])
        self.keep = set()              # job indices whose .coal is kept
        os.environ["COLATE_TPU_LOG"] = "json"

    def argv(self, i: int) -> tuple[list, str, int | None, int]:
        c, t = self.config, self.traffic
        seed = int(self.seeds.integers(1, 2**31 - 1))
        common = ["--mode", "mut", "--bins", c["bins"], "--num_bootstraps", str(c["num_bootstraps"]),
                  "--target_age", str(c["target_age"]), "--years_per_gen", str(c["years_per_gen"]),
                  "--seed", str(seed), *t.get("extra_args", [])]
        if self.kind == "first_pass":
            p = self.inputs
            out = os.path.join(self.workdir, f"job{i:05d}")
            return (common + ["--mut", p.mut_prefix, "--target_tmp", p.target, "--reference_tmp",
                              p.reference, "--chr", p.chr_file, "-o", out], out, None, seed)
        pair = i % len(self.inputs.prefixes)
        out = self.inputs.prefixes[pair]
        # the pair's first-pass inputs; a rerun reads only <out>.colate_mat
        return (common + ["--target_bcf", out + "_target", "--reference_bcf", out + "_reference",
                          "-o", out], out, pair, seed)

    def run(self, i: int, wall_offset: float) -> Job:
        from colate_tpu_torch.models.mut_em import run_mut_and_write

        argv, out, pair, seed = self.argv(i)
        job = Job(i, out, pair, seed)
        coal = out + ".coal"
        if os.path.exists(coal):
            os.remove(coal)
        log = io.StringIO()
        job.t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(log):
                res = run_mut_and_write(self.cli.mut_config(self.parser.parse_args(argv)),
                                        self.device)
            job.ok = os.path.exists(coal)
            job.error = "" if job.ok else "no .coal written"
        except Exception as exc:  # a job that raises is a failed job; the run goes on
            res, job.error = None, f"{type(exc).__name__}: {exc}"
        job.t1 = time.perf_counter()
        job.result = res
        job.timings = dict(res.timings) if res is not None else {}
        for line in log.getvalue().splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                job.events[rec["event"]] = rec["ts"] - wall_offset
        if job.ok and i in self.keep:
            job.kept_coal = f"{coal}.job{i:05d}"
            os.replace(coal, job.kept_coal)
        return job


def run_window(runner: Runner, first: int, seconds: float, until=()) -> tuple[list, float, float]:
    """Jobs from index ``first`` until the first completion after ``seconds``
    (and after every index in ``until``).  Returns (jobs, start, length)."""
    jobs = []
    start = time.perf_counter()
    wall_offset = time.time() - start
    i = first
    while True:
        job = runner.run(i, wall_offset)
        jobs.append(job)
        i += 1
        if job.t1 - start >= seconds and i > max(until, default=-1):
            return jobs, start, job.t1 - start
