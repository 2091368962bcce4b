"""BENCHMARK.json keeps to its contract's characters and shapes, and the
harness finds a configuration, a traffic mix and a metric by name."""

import json
import os
import re
import types

from benchmark.harness import jobs
from benchmark.harness.spec import Spec

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_names_and_units_use_allowed_characters():
    s = _spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    metrics = s["end_to_end"] + s["per_layer"]
    for entry in s["configs"] + s["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for w in s["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in s["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    names = [e["name"] for e in metrics]
    assert len(names) == len(set(names))
    assert 1 <= s["run_seconds"] <= 51 and "setup_s" in names


def test_every_named_file_exists():
    spec = Spec(REPO)
    for w in spec.data["workloads"]:
        spec.config(w)
        spec.traffic(w)
        spec.limits(w)
        for trace in (False, True):
            for m in spec.metrics(w, trace):
                assert callable(spec.reader(m["name"]))


def test_cells_report_their_metrics():
    spec = Spec(REPO)
    for w in spec.data["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w, True)


def test_added_files_are_found_by_name(small_repo, monkeypatch):
    root = small_repo
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "mut_modern_pair.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(bench, "configs", "mut_other.json"), "w") as fh:
        json.dump(dict(cfg, name="mut_other"), fh)
    with open(os.path.join(bench, "traffic", "device.json"), "w") as fh:
        json.dump({"jobs": "first_pass", "extra_args": ["--binning", "device"], "warm_jobs": 1,
                   "check_jobs": 1, "check_within": 2, "check_replicates": 4}, fh)
    with open(os.path.join(bench, "limits", "mut_other.device.json"), "w") as fh:
        json.dump({"rate_gap": 1.0, "site_gap": 0, "block_gap": 0}, fh)
    with open(os.path.join(bench, "metrics", "binning_ms.job.py"), "w") as fh:
        fh.write("def read(ctx):\n    return 42.0\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        s = json.load(fh)
    s["configs"].append({"name": "mut_other", "source": "x", "file": "benchmark/configs/mut_other.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "mut_other.device", "config": "mut_other", "traffic": "device",
                           "chips": 1, "why": "x"})
    s["end_to_end"][0]["workloads"].append("mut_other.device")
    s["per_layer"].append({"name": "binning_ms.job", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "binning", "moves": "jobs_per_s",
                           "workloads": ["mut_other.device"]})
    with open(path, "w") as fh:
        json.dump(s, fh)
    spec = Spec(root)
    w = spec.workload("mut_other.device")
    assert spec.config(w)["name"] == "mut_other"
    assert spec.limits(w)["rate_gap"] == 1.0
    monkeypatch.setenv("COLATE_TPU_LOG", "json")
    pair = types.SimpleNamespace(mut_prefix="m", target="t", reference="r", chr_file="c")
    runner = jobs.Runner(spec.config(w), spec.traffic(w), pair, root, 1, "cpu")
    assert runner.parser.parse_args(runner.argv(0)[0]).binning == "device"
    assert [m["name"] for m in spec.metrics(w, True)] == ["binning_ms.job"]
    assert spec.reader("binning_ms.job")(None) == 42.0
    assert {m["name"] for m in spec.metrics(w, False)} == {"jobs_per_s", "setup_s"}
