"""Whether the window's answers are right: a sample of its jobs, drawn from
the seed before the window, held against the plain reference once the
window has closed.

Each sampled job's ``.coal`` is kept when the job ends.  The reference
works out the counts of a sample of its bootstrap replicates from the
inputs the benchmark made (``first_pass``: the join of the ``.mut`` rows
and the two streams, the analytic binning and the job's block bootstrap;
``rerun``: the pair's ``.colate_mat``, which both read), runs its float64
EM on them on the device, and compares (benchmark/reference/compare.py).
With ``control`` the reference's EM in float32 with TF32 contractions is
read too, in the program's place, and judged by the same comparison: its
checks are the program's with its ``rate_gap`` in place of the program's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import binning, bootstrap, compare, em, join


def plan(traffic: dict, first: int, seed: int) -> list:
    """The indices of the jobs whose answers are compared."""
    g = np.random.default_rng([seed, 2])
    n = traffic["check_jobs"]
    return sorted(first + g.choice(traffic["check_within"], n, replace=False))


def _rows(B: int, n: int, seed: int, index: int) -> np.ndarray:
    if n >= B:
        return np.arange(B)
    return np.sort(np.random.default_rng([seed, 3, index]).choice(B, n, replace=False))


def check(config: dict, traffic: dict, limits: dict, inputs, jobs: list, planned: list, seed: int,
          device, control: bool = False) -> tuple[dict, dict]:
    """({name: {"value", "limit"}}, readings) of the window ``jobs``, of which
    those with the indices ``planned`` are compared.  The readings are the
    most iterations by which a compared answer stopped before the
    reference (``stop_short``) and, with ``control``, the control's
    ``rate_gap``, ``stop_short`` and whether :func:`correct` passes its
    checks (``control_correct``)."""
    picked = [j for j in jobs if j.index in set(planned)]
    out = {"failed_jobs": {"value": sum(not j.ok for j in jobs), "limit": 0}}
    readings = {}
    age = bootstrap.age_generations(config["target_age"], config["years_per_gen"])
    epochs, _ = bootstrap.epochs_from_bins(config["bins"], config["years_per_gen"], age)
    B = config["num_bootstraps"]
    sites = hists = None
    if config["inputs"] == "colate_in":
        p = inputs
        sites = join.join(p.chroms, p.muts, p.target_stream, p.reference_stream)
        hists = binning.bin_sites(sites.age_begin, sites.age_end, sites.w_shared, sites.w_notshared,
                                  sites.block, sites.num_blocks, device=device)
        done = [j for j in picked if j.ok]
        out["site_gap"] = {"value": max((abs(j.result.num_sites - len(sites)) for j in done),
                                        default=0), "limit": limits["site_gap"]}
        out["block_gap"] = {"value": max((abs(j.result.num_blocks - sites.num_blocks) for j in done),
                                         default=0), "limit": limits["block_gap"]}
    sc, nc, rates, iters = [], [], [], []
    for j in picked:
        if not j.ok:
            continue
        rows = _rows(B, traffic["check_replicates"], seed, j.index)
        if hists is not None:
            w = bootstrap.block_weights(B, sites.num_blocks, j.seed)[rows]
            s, n = bootstrap.counts(hists, w, age)
        else:
            vals = np.loadtxt(j.out + ".colate_mat", ndmin=2)
            s, n = vals[1::2][rows], vals[2::2][rows]
        sc.append(s)
        nc.append(n)
        res = j.result
        coal = compare.read_coal(j.kept_coal)
        rates.append(compare.program_rates(coal, res.rates, res.ep_null, res.is_ancient)[rows])
        iters.append(np.asarray(res.iterations)[rows])
    out["missing_answers"] = {"value": sum(not j.ok for j in picked), "limit": 0}
    if sc:
        sc, nc = np.concatenate(sc), np.concatenate(nc)
        gap, short = compare.rate_gap(epochs, sc, nc, np.concatenate(rates), np.concatenate(iters),
                                      device)
        out["rate_gap"] = {"value": gap, "limit": limits["rate_gap"]}
        readings["stop_short"] = short
        if control:
            init = np.full(epochs.shape, em.INITIAL_RATE)
            low, n_low = em.run_em(epochs, init, sc, nc, device=device, dtype=torch.float32,
                                   tf32=True)
            gap, short = compare.rate_gap(epochs, sc, nc, low, n_low, device)
            ctl = dict(out, rate_gap={"value": gap, "limit": limits["rate_gap"]})
            readings.update(control_rate_gap=gap, control_stop_short=short,
                            control_correct=correct(ctl))
    return out, readings


def correct(checks: dict) -> bool:
    return "rate_gap" in checks and all(c["value"] <= c["limit"] for c in checks.values())
