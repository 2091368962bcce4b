"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


class Spec:
    """The benchmark's definition, read from ``<repo>/BENCHMARK.json``;
    per-cell files are found under ``<repo>/<paths[0]>``."""

    def __init__(self, repo: str = REPO):
        self.repo = repo
        with open(os.path.join(repo, "BENCHMARK.json")) as fh:
            self.data = json.load(fh)
        self.bench_dir = os.path.join(repo, self.data["paths"][0])

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, workload: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == workload["config"]:
                return self._json(os.path.join(self.repo, c["file"]))
        raise KeyError(f"no config {workload['config']!r} in BENCHMARK.json")

    def traffic(self, workload: dict) -> dict:
        return self._json(os.path.join(self.bench_dir, "traffic", workload["traffic"] + ".json"))

    def limits(self, workload: dict) -> dict:
        return self._json(os.path.join(self.bench_dir, "limits", workload["name"] + ".json"))

    def metrics(self, workload: dict, trace: bool) -> list:
        """The metrics a run of ``workload`` reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        cell = workload["name"]
        e2e = [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def reader(self, name: str):
        """``read(ctx)`` of ``metrics/<name>.py``."""
        path = os.path.join(self.bench_dir, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    @staticmethod
    def _json(path: str) -> dict:
        with open(path) as fh:
            return json.load(fh)
