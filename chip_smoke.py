#!/usr/bin/env python3
"""Smoke run of colate_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from colate_tpu_torch/csrc/ (one nvcc per
source, started together) and:

1-6. holds the EM kernel against its plain torch versions on the card (one
     chunk, and the whole run with the stopping rule on the card), checks
     the EM against the host float64 EM, drives mode ``mut`` through the
     port's CLI at 1024 bootstrap replicates on a synthetic 4 x 300k-row
     fixture (the north-star fixture of bench.py), binning on the host,
     checks the ``.coal`` it writes and that the EM was one launch, and
     times the EM: a chunk, and the whole EM in one launch against the
     chunked route (a launch and a host check per 8 iterations), beside
     the bound;
7.   holds the binning kernel against its plain torch version and the host
     float64 binning on the card, and checks that two launches on one
     input, and a stream split at a block boundary, bin bitwise
     identically;
8.   bins 22.2M sites in 125 blocks (the whole-genome site count, with
     bench.py's generator) and times the host preparation of the site
     stream, its copy, the kernel, its plain version, the port's binning
     end to end and the host binning;
9.   drives mode ``mut --binning device`` (and once ``sharded``) through
     the CLI on the north-star fixture at 1024 replicates;
10.  runs the tree populate programs (ops/tree_kernel.py, torch on the
     card) on 60,000 Kingman trees of 200 haplotypes (tools/bench_tree.py's
     scale, made in memory, with the node ages the parse of phase 12's
     written .anc gives): the leaf-zero form, which mode tree takes on
     them, against the native walk, the general form on the same trees
     with ancient leaves against the same program on the CPU, at rtol
     1e-12, two runs bitwise equal; times the programs, the copy, the
     native walk, counts the launches (CUDA runtime calls) and bytes;
11.  runs the local-ancestry program (ops/la_kernel.py) on the same trees
     with 2 groups and 1,000 ancestry segments (tools/bench_aux.py's
     layout) against the native twin at rtol 1e-12, two runs bitwise
     equal, with the same measurements;
12.  drives mode ``tree`` through the CLI on the card on a written
     ``.anc``/``.mut`` fixture of two such chromosomes, against a
     ``--torch_device cpu`` run of the same input (rates within 1e-5, the
     same NaN pattern), and checks the device route in the log;
13.  the same for mode ``local_ancestry`` with segment poplabels;
14.  (run after 9, as are 15-17) ``--checkpoint`` at 1024 replicates: an
     uninterrupted run, a process killed after its first 128-iteration
     EM chunk (exit 17), the run resumed from its state (an EM launch a
     chunk), a rerun from the cached histograms; all byte-identical to
     phase 5's run;
15.  shards on the one card: ``parallel/mesh.py:dryrun_multichip`` over 4
     shards of cuda:0, the binning at 22.2M sites (phase 8's) and the EM
     at 1024 replicates bitwise equal to one shard, and its mode mut
     ``.coal``; the CLI with ``--devices 1 --binning sharded`` (and 2
     where the machine has two cards) against phase 9's ``sharded`` run;
16.  two ranks of the CLI on the card (``--coordinator``, gloo merge)
     under ``--binning auto`` and ``device``, rank 0's ``.coal`` against
     phases 5 and 9;
17.  ``--sampling mc_parity`` and ``--em_dtype float64`` at 8 replicates:
     the ``.coal`` on the card byte-identical to ``--torch_device cpu``;
18.  (after 17, as are 19-20) mode ``mut`` on BCF2 inputs written from the
     north-star fixture's rows (a target of one sample and a reference of
     ten a chromosome): ``--target_bcf/--reference_bcf`` under ``--binning
     auto`` and ``device``, ``--target_bcf`` alone under ``auto``, each
     with one EM launch (and one binning launch under ``device``), its
     histograms within 2e-5 of native float64, its ``.coal`` within 1e-3
     of the host f64 EM and, under ``auto``, its ``.colate_mat`` equal to
     the CPU's; a rerun that reads the ``.colate_mat`` cache;
19.  the same at tools/bench_bam_stream.py's scale (2M reads a BAM on an
     18 Mb contig, 200k ``.mut`` rows): ``--target_bam/--reference_bcf``
     under ``auto`` and ``device``, ``--target_bam/--reference_bam`` under
     ``auto``; ``make_tmp --target_bam`` as a process (1 and 4 inflate
     threads, the same bytes, no torch imported) and processes that only
     import the port (no torch) and torch, each with its wall and max RSS
     from wait4;
20.  ``mc_parity``/f64 bytes on the card equal to the CPU's on a small
     fixture, ``--target_bcf`` alone and ``--target_bam/--reference_bcf``;
21.  (after 13) the last host modes, each a process timed with wait4 that
     must not import torch: ``CondCoalRates`` on phase 12's two
     chromosomes (100 samples in three groups, ``--groups FOC,CON``, four
     bootstraps) under the analytic walk; the analytic walk and the
     ``--sampling mc_parity`` replay within rtol 1e-3 of each other, with
     the same NaN pattern, at tools/bench_aux.py's 50,000 trees x 20
     haplotypes, and their distance at 2,000 trees x 200 haplotypes;
     ``print_tmp`` (every printed site a ``.mut`` row), ``compare_tmp``
     and ``count_topo`` (a third stream) on the north-star streams;
22.  (after 21) the JAX package's library surface on phase 12's
     chromosome 1 cut to 3,000 trees of 200 haplotypes: the trees written
     as plain Newick, RENT+ (Ne 2e4) and ARGweaver SMC (permuted leaf and
     internal labels) and imported (each internal node's leaf set the
     source's, node ages within 1e-5), each written as ``.anc``; the
     ``.trees`` round trip (``anc_to_tables``, ``write_trees_file``,
     ``read_trees_file``, ``tables_to_anc``); mode ``tree`` through the
     CLI on the SMC- and Newick-imported ``.anc`` on the card against
     ``--torch_device cpu`` (as phase 12); ``e_step_sampled`` in float64
     on the card, 185 age bins x 1,024 draws x 23 epochs, within 1e-12 of
     the CPU's point E-step at its ages, bitwise equal for two generators
     of one seed; branch association on 200 trees, the tree E-step,
     ``e_step_interval`` and ``annotate_ages`` timed.

Prints the measured times, one JSON line about the host modes of phase
21, one about the library surface of phase 22, one about the tree
estimators' device programs (plain torch, not kernels), one about the
kernels, and as its last line ``{"ok": true, "device": {...}}``.  Any failed check raises; the script exits non-zero
without a result when torch sees no CUDA device, and it imports nothing
of JAX or of the JAX package (the fixtures come from
colate_tpu_torch/fixtures.py).

    python3 chip_smoke.py --profile

adds a torch.profiler trace of the EM at 1024 replicates (device busy
time and idle share, the host ops before the first device event, the
call's wall without the profiler), the EM kernel built for other launch
bounds timed against its own, and the times of one-shot CLI processes
of mode ``mut`` at 1, 64, 800 and 1024 replicates (``--em_dtype auto``:
the kernel on the card; at 800 also on the CPU, the host EM).
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BINS = "3,7,0.2"
B_E2E = 1024
K = 8
N_WHOLE_GENOME = 22_200_000  # sites of the reference's whole-genome fixture
# tools/bench_tree.py's Relate-realistic scale, and tools/bench_aux.py's
# ancestry segments
N_TREES = 60_000
N_HAP = 200
TREE_BINS = "2,6,0.25"
N_SEGMENTS = 1000
N_BAM_READS = 2_000_000  # tools/bench_bam_stream.py's scale, bench.py:700-702
# CondCoalRates' analytic walk against the reference's f32 replay: at
# tools/bench_aux.py's 50,000 trees x 20 haplotypes, where the JAX package
# gates them at rtol 1e-3 (BENCH_DETAILS.json cond_coal); at 200 haplotypes
# the replay's f32 sums drift far from the f64 walk, and it takes seconds a
# thousand trees, so there it runs on a cut input and is only read
CC_GATE = (50_000, 20)
CC_WIDTH_TREES = 2_000
# the library surface (phase 22): the importers and tables_to_anc grow
# faster than the tree count (tables_to_anc scans every edge a tree), so
# phase 12's trees are cut to 3,000 at their full 200 haplotypes; RENT+
# branch lengths in coalescent units of an Ne of 2e4; the sampled E-step
# draws 1,024 ages in each of the 185 age bins; branch association runs on
# 200 trees (199 adjacent pairs)
N_IMPORT_TREES = 3000
RENT_NE = 2e4
N_DRAWS = 1024
N_ASSOC_TREES = 200

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# float32 operations of one EM iteration, counted from the function as
# csrc/em_step.cu computes it: an FMA is two, an add, multiply, division,
# expf, expm1f or logf one.  A bin whose shared (notshared) count is 0
# needs none of the shared (notshared) terms.  Per bin, whatever the epoch:
EM_OPS_BIN = 2          # H_t = H_k + lam_k (t - epochs[k]), for either side
EM_OPS_BIN_S = 8        # em1_lo, P_k^-, T1_k^-, Z_s and 1/Z_s
EM_OPS_BIN_N = (8, 3)   # k < E-1, k = E-1: dH_hi, em1_hi, T1_k^+; 1/zrel, integ_lo
# per bin and epoch e, by branch: posterior, exposure, weighting by the
# count and the sums over bins into num and den
EM_OPS_S = 13           # shared, e <= k
EM_OPS_N_BELOW = 3      # notshared, e < k: the full-width exposure
EM_OPS_N_AT = 13        # notshared, e = k
EM_OPS_N_ABOVE = 18     # notshared, e > k: exp(-(H_e - H_t)) and its mass, the rest
EM_OPS_LOGL = (3, 4)    # per bin and K-iteration chunk: the shared, notshared logl term
EM_OPS_EPOCH = 11       # per replicate and epoch: its tables and its M-step
# float32 operations of the binning, counted the same way from the function
# as csrc/bin_hist.cu computes it, over the bins whose terms a site needs
# (bin_ranges).  A regular site, per bin: the overlap's subtraction and its
# add into the normaliser s, then the overlap again, the division by s and
# two FMAs into the shared and notshared histograms:
BIN_OPS_REG = 8
# an emp site, per bin: the CDF at the bin's upper edge (a subtraction and a
# division), ch - cl and an FMA; per site: the width, the CDF at the first
# edge, the two one-hot adds; in the last bin, 1 - ch and its add
BIN_OPS_EMP = 5
BIN_OPS_EMP_SITE = 5
BIN_OPS_EMP_LAST = 2


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def em_ops(k, E: int, sc, nc, iters) -> float:
    """Float32 operations of an EM at E epochs: replicate b runs iters[b]
    iterations (in chunks of K) over the bins, of epoch k[n] each, whose
    counts sc[b, n], nc[b, n] are not 0."""
    import numpy as np

    k = np.asarray(k, np.int64)
    ops_s = EM_OPS_BIN_S + EM_OPS_S * (k + 1) + EM_OPS_LOGL[0] / K
    ops_n = (np.where(k < E - 1, *EM_OPS_BIN_N) + EM_OPS_N_BELOW * k + EM_OPS_N_AT
             + EM_OPS_N_ABOVE * (E - 1 - k) + EM_OPS_LOGL[1] / K)
    has_s = (np.asarray(sc) != 0).astype(np.float64)
    has_n = (np.asarray(nc) != 0).astype(np.float64)
    either = np.maximum(has_s, has_n)
    per_iter = EM_OPS_BIN * either.sum(1) + has_s @ ops_s + has_n @ ops_n + EM_OPS_EPOCH * E
    return float(np.asarray(iters, np.float64) @ per_iter)


def em_bound(k, E: int, sc, nc, iters) -> tuple[float, str]:
    """Bound of an EM (arguments as em_ops): its operations, and the
    counts read and the rates and run state read and written once."""
    B = len(iters)
    return bound_ms(em_ops(k, E, sc, nc, iters), B * (2 * 185 + 2 * E) * 4 + B * 16)


def bin_ranges(sites, age: float):
    """Per site, the emp flag and the first and last bin whose term the
    dense formula makes non-zero, found as csrc/bin_hist.cu finds them:
    float32 comparisons against the float32 edges, an empty range as
    last < first.  A regular site's range is exactly the bins whose
    overlap with [max(age_begin, age), age_end] is positive; an emp
    site's runs from the bin below the first edge above max(age,
    age_begin) to the bin below the first edge above age where the CDF
    reaches 1 (through the last bin when it never does)."""
    import numpy as np

    from colate_tpu_torch.config import NUM_AGE_BINS, age_bin_edges

    e = age_bin_edges().astype(np.float32)
    age32 = np.float32(age)
    ab = np.asarray(sites.age_begin, np.float32)
    ae = np.asarray(sites.age_end, np.float32)
    emp = np.asarray(sites.age_begin, np.float64) <= age
    top = NUM_AGE_BINS - 1
    lo = np.maximum(np.searchsorted(e, np.maximum(ab, age32), "right") - 1, 0)
    hi = np.minimum(np.searchsorted(e, ae, "left") - 1, top)
    hi = np.where(ae > np.maximum(ab, age32), hi, lo - 1)
    i = np.flatnonzero(emp)
    if i.size:
        a, w = ab[i], np.maximum(ae[i] - ab[i], np.float32(1e-30))
        e_inf = np.append(e, np.float32(np.inf))

        def done(j):  # the kernel's test: CDF 1 from edge j on
            x = e_inf[np.minimum(j, e.size)]
            return (j >= 0) & (x > age32) & (x - a >= w)

        c = np.searchsorted(e, ae[i], "left")  # a guess, moved to the first j done
        while (m := (c > 0) & done(c - 1)).any():
            c = c - m
        while (m := ~done(c)).any():
            c = c + m
        lo[i] = np.minimum(lo[i], top)
        hi[i] = np.minimum(c, NUM_AGE_BINS) - 1
    return emp, lo, hi


def bin_ops(sites, age: float) -> float:
    """Float32 operations of the binning of ``sites`` at ``age``, over the
    bins each site's terms need (bin_ranges), branch by branch.  The
    float64 sums of the chunk partials (740 a chunk) are left out."""
    import numpy as np

    from colate_tpu_torch.config import NUM_AGE_BINS

    emp, lo, hi = bin_ranges(sites, age)
    n = np.maximum(hi - lo + 1, 0).astype(np.float64)
    last = (hi == NUM_AGE_BINS - 1) & (n > 0)
    return float(BIN_OPS_REG * n[~emp].sum() + BIN_OPS_EMP * n[emp].sum()
                 + BIN_OPS_EMP_SITE * emp.sum() + BIN_OPS_EMP_LAST * (last & emp).sum())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card, from CUDA events, after one warm call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tiers(rates, ref):
    """Largest relative deviation on identified (>= 1e-4) and weakly
    identified (>= 1e-6) rates of ref (tests/test_em_f32.py:34-35)."""
    import numpy as np

    rel = np.abs(rates - ref) / np.maximum(np.abs(ref), 1e-300)
    return float(rel[ref >= 1e-4].max()), float(rel[ref >= 1e-6].max())


def synthetic_counts(t, B: int, seed: int):
    """Count matrices [B, 185] shaped like a real run at age-bin centres t:
    mass in the mid age bins, bootstrap-jittered, empty tails (the
    generator of tests/test_em_pallas.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N = t.shape[0]
    base_s = 1e4 * np.exp(-0.5 * ((np.log(t + 1e-9) - 7.0) / 2.0) ** 2)
    base_n = 3e4 * np.exp(-0.5 * ((np.log(t + 1e-9) - 8.5) / 2.5) ** 2)
    sc = np.round(base_s[None, :] * rng.gamma(20.0, 1 / 20.0, size=(B, N)), 3)
    nc = np.round(base_n[None, :] * rng.gamma(20.0, 1 / 20.0, size=(B, N)), 3)
    sc[:, :40] = 0.0
    sc[:, 150:] = 0.0
    nc[:, :35] = 0.0
    nc[:, 155:] = 0.0
    return sc, nc


def read_coal_rates(path: str):
    """Rates [rows, E] of a mode-mut ``.coal``: a group line, an epoch line,
    then one ``group replicate rate...`` row per replicate."""
    import numpy as np

    return np.loadtxt(path, skiprows=2, ndmin=2)[:, 2:]


def profile_em(run, smi: str) -> None:
    """Device busy time and idle share of one warm call of run(): the
    union of the intervals of the device events that torch.profiler
    records, against the call's host wall and its device span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(len(dev) > 0, "the profiler recorded device events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    print(f"profiled EM: wall {wall_us / 1e3:.3f} ms (profiler on), device span "
          f"{span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms; idle share {1 - busy / wall_us:.4f} "
          f"of the wall, {1 - busy / span:.4f} of the span [{smi}]", flush=True)
    rows: dict = {}
    for e in dev:
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:6]:
        print(f"  {ms:10.3f} ms x {n:4d}  {name[:80]}")
    # the wall outside the device span: the host ops recorded before the
    # first device event and after the last
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    lo, hi = spans[0][0], spans[-1][1]
    h0 = min(e.time_range.start for e in host)
    h1 = max(e.time_range.end for e in host)
    print(f"  host: the first recorded op starts {(lo - h0) / 1e3:.3f} ms before the first "
          f"device event, the last ends {(h1 - hi) / 1e3:.3f} ms after the last; "
          f"{(wall_us - (max(h1, hi) - min(h0, lo))) / 1e3:.3f} ms of the wall lie outside both")
    for e in sorted((e for e in host if e.cpu_parent is None and e.time_range.start < lo),
                    key=lambda e: e.time_range.start - e.time_range.end)[:6]:
        print(f"    from {(e.time_range.start - h0) / 1e3:7.3f} ms: {(e.time_range.end - e.time_range.start) / 1e3:7.3f} "
              f"ms  {e.name[:70]}")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"  without the profiler: wall {', '.join(f'{w:.3f}' for w in walls)} ms; idle share "
          f"{1 - busy / 1e3 / (sum(walls) / len(walls)):.4f} of the mean wall, taking the "
          f"profiled busy time [{smi}]", flush=True)


def sweep_ctas(epochs, init, sc, nc, smi: str) -> None:
    """The EM kernel built for its own resident CTAs an SM and for others
    (__launch_bounds__(192, n)): ptxas's registers and spills, an
    8-iteration chunk and the whole EM on the counts sc, nc, timed in
    turns.  On an H100 ptxas gives (192, 7) the 40 registers of (192, 8),
    and (192, 4) the 59 of (192, 5), so neither is built."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from colate_tpu_torch.ops import em_kernel

    choices = (None, 8, 6)  # None: the source's own
    with ThreadPoolExecutor(len(choices)) as ex:
        built = dict(zip(choices, ex.map(em_kernel.kernel_library, choices)))
    E = len(epochs)
    B = sc.shape[0]
    r0 = torch.as_tensor(init, dtype=torch.float32, device=sc.device).expand(B, E).contiguous()
    state = (torch.full((B,), -torch.inf, dtype=torch.float64, device=sc.device),
             torch.zeros(B, dtype=torch.bool, device=sc.device),
             torch.zeros(B, dtype=torch.int32, device=sc.device))
    chunk = {m: [] for m in choices}
    whole = {m: [] for m in choices}
    for m in choices + choices[::-1]:
        chunk[m].append(cuda_ms(lambda: em_kernel.em_chunk(epochs, r0, sc, nc, K, min_ctas=m), 50))
        whole[m].append(cuda_ms(lambda: em_kernel.em_run(epochs, r0, sc, nc, *state, K=K, min_ctas=m), 3))
    ref = em_kernel.em_run(epochs, r0, sc, nc, *state, K=K)
    for m in choices:
        info = em_kernel.kernel_info(E, True, m)
        spills = [x.split(":")[-1].strip() for x in built[m].log.splitlines() if "spill" in x]
        same = all(torch.equal(a, b) for a, b in zip(
            ref, em_kernel.em_run(epochs, r0, sc, nc, *state, K=K, min_ctas=m)))
        print(f"__launch_bounds__(192, {info['min_ctas']}){' (the source)' if m is None else ''}: "
              f"{info['registers']} registers, {info['ctas_per_sm']} CTAs an SM; ptxas (run / chunk) "
              f"{' / '.join(spills) or 'not logged (an earlier build was reused)'}; B={B} chunk {', '.join(f'{t:.4f}' for t in chunk[m])} ms, "
              f"whole EM {', '.join(f'{t:.4f}' for t in whole[m])} ms; results bitwise equal to "
              f"the source's build: {same} [{smi}]", flush=True)


def time_processes(argv: list[str], tmp: str, smi: str) -> None:
    """Wall and em stage of one-shot ``python -m colate_tpu_torch``
    processes, the native host EM against the kernel."""
    env = dict(os.environ, COLATE_TPU_LOG="json")
    for B, device in ((1, "cuda"), (64, "cuda"), (800, "cuda"), (800, "cpu"), (1024, "cuda")):
        cmd = [sys.executable, "-m", "colate_tpu_torch", *argv, "--num_bootstraps", str(B),
               "--em_dtype", "auto", "--torch_device", device,
               "-o", os.path.join(tmp, f"proc_{B}_{device}")]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"one-shot process B={B} exits 0: {p.stderr[-2000:]}")
        em = [json.loads(x) for x in p.stderr.splitlines() if x.startswith('{"event": "mut_em"')]
        check(len(em) == 1, f"one-shot process B={B} logged its EM")
        done = [json.loads(x) for x in p.stderr.splitlines() if x.startswith('{"event": "mut_done"')]
        st = done[0]["timings"]
        print(f"one-shot process B={B} --em_dtype auto --torch_device {device}: wall "
              f"{wall:.4f} s, em {em[0]['sec']:.4f} s, provider {em[0]['provider']}; parse "
              f"{st['parse']:.4f} s, bootstrap {st['bootstrap']:.4f} s; outside the stages "
              f"{wall - sum(st.values()):.4f} s [{smi}]", flush=True)
        check(em[0]["provider"] == ("native" if device == "cpu" else "cuda-kernel:float32"),
              f"one-shot process B={B} on {device} took the expected EM")


def rel_err(ours, ref) -> float:
    """Largest elementwise |ours - ref| / |ref| over the entries of ref that
    are not 0, where ours must be 0 too (else inf)."""
    import numpy as np

    ours, ref = np.asarray(ours), np.asarray(ref)
    nz = ref != 0
    if (ours[~nz] != 0).any():
        return float("inf")
    return float((np.abs(ours[nz] - ref[nz]) / np.abs(ref[nz])).max(initial=0.0))


def device_launches(fn) -> dict:
    """Kernel launches and copies or sets during one fn(), counted from the
    CUDA runtime calls the host makes, one a launch (``cudaLaunchKernel*``,
    ``cuLaunchKernel*``; ``cudaMemcpy*``, ``cudaMemset*``), in two
    torch.profiler traces that must agree; beside them, the kernels each
    trace recorded on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.events()
        on_card = [e for e in ev if e.device_type == DeviceType.CUDA]
        counts.append(dict(
            launches=sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for e in ev),
            copies_and_sets=sum(e.name.startswith(("cudaMemcpy", "cudaMemset")) for e in ev),
            kernels_traced=sum(not e.name.startswith(("Memcpy", "Memset")) for e in on_card),
        ))
    check(counts[0]["launches"] > 0, "the profiler recorded the runtime's launch calls: "
          + ", ".join(sorted({e.name for e in ev})[:40]))
    check(all(counts[0][k] == counts[1][k] for k in ("launches", "copies_and_sets")),
          f"two traces count the same launches and copies ({counts})")
    return dict(counts[0], kernels_traced=[c["kernels_traced"] for c in counts])


def peak_bytes(fn) -> int:
    """Device memory fn() allocates at its peak beyond what was allocated
    before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def program_row(name, source, replaces, fn, ref, nbytes, runs, smi, **times) -> dict:
    """Measures the device program fn() (inputs resident on the card):
    checks it against ref at rtol 1e-12 and two runs bitwise, times it
    with CUDA events, counts its launches and bytes; one JSON row."""
    import numpy as np

    first, again = fn(), fn()
    check(all(np.array_equal(a, b) for a, b in zip(first, again)),
          f"{name}: two runs on the card bitwise equal")
    rel = max(rel_err(a, b) for a, b in zip(first, ref))
    check(all(np.isfinite(a).all() for a in first), f"{name}: finite sums")
    check(rel <= 1e-12, f"{name}: within 1e-12 of its reference ({rel:.3e})")
    ms = cuda_ms(fn, 5)
    counts = device_launches(fn)
    row = dict(name=name, route="torch", source=source, replaces=replaces, **counts,
               program_runs=runs,
               max_abs_err=max(float(np.abs(a - b).max()) for a, b in zip(first, ref)),
               max_rel_err=rel, ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               peak_bytes=peak_bytes(fn), **times)
    print(f"{name}: {ms:.4f} ms on the card (CUDA events, inputs resident), {counts['launches']} "
          f"kernel launches and {counts['copies_and_sets']} copies or sets a run (runtime calls; "
          f"kernels traced on the card {counts['kernels_traced']}), {row['peak_bytes']} bytes at "
          f"the peak; "
          f"bound {row['bound_ms']:.4f} ms ({nbytes} bytes), {row['bound_ms'] / ms:.4f} of it; "
          + "; ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"; vs its reference max rel {rel:.3e} (<= 1e-12), two runs bitwise equal [{smi}]",
          flush=True)
    return row


def tree_layers(dev, smi: str):
    """Phases 10-11: the populate programs and the local-ancestry program
    at 60,000 trees x 200 haplotypes, in memory.  Returns the JSON rows
    and the chromosome (anc, mut) for the CLI phases."""
    import numpy as np
    import torch

    from colate_tpu_torch.fixtures import tree_chromosome
    from colate_tpu_torch.formats.anc import AncFile, node_ages
    from colate_tpu_torch.models.local_ancestry import CoalLA
    from colate_tpu_torch.models.tree_coal import BLOCK_SIZE_TREES, epochs_from_bins_tree, tree_spans
    from colate_tpu_torch.ops import la_kernel, tree_kernel

    t0 = time.perf_counter()
    anc, mut, ages = tree_chromosome(N_TREES, N_HAP, seed=4242)
    t_gen = time.perf_counter() - t0
    T, M, N = N_TREES, 2 * N_HAP - 1, N_HAP
    epochs = epochs_from_bins_tree(TREE_BINS, 28.0)
    E = epochs.shape[0]
    spans = np.float32(tree_spans(anc, mut)).astype(np.float64)
    blocks = (np.arange(T) // BLOCK_SIZE_TREES).astype(np.int32)
    nb = T // BLOCK_SIZE_TREES + 1
    # the node ages mode tree reads from the written .anc: branch lengths
    # at 5 decimals (fixtures.write_anc), ages recomputed from them
    parsed = AncFile(**{**anc.__dict__, "branch_length": np.rint(anc.branch_length * 1e5) / 1e5})
    coords = node_ages(parsed)
    inverted = int((np.diff(coords[:, N:], axis=1) < 0).any(axis=1).sum())
    check(tree_kernel.leaf_zero_applicable(coords, N), "the parsed trees take the leaf-zero form")
    # ancient leaves: 20 haplotypes dated 0-500 generations, every
    # coalescence 500 generations older
    g = np.random.default_rng(7)
    old = coords.copy()
    old[:, N:] += np.float32(500.0)
    old[:, g.choice(N, 20, replace=False)] = g.uniform(0.0, 500.0, 20).astype(np.float32)
    check(not tree_kernel.leaf_zero_applicable(old, N), "the ancient trees take the general form")
    print(f"trees: {T} x {N} haplotypes (M={M}), E={E} ({TREE_BINS}), {nb} blocks, generated in "
          f"{t_gen:.3f} s; {inverted} trees carry internal ages out of order", flush=True)

    sp_d = torch.as_tensor(spans, device=dev)
    bl_d = torch.as_tensor(blocks, device=dev)
    rows = []
    ia = np.ascontiguousarray(coords[:, N:])
    for name, form, host, line in (
        ("populate_sorted", tree_kernel.populate_device_sorted, coords, 104),
        ("populate_general", tree_kernel.populate_device, old, 47),
    ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c_d = torch.as_tensor(host if form is tree_kernel.populate_device else ia, device=dev)
        torch.cuda.synchronize()
        h2d = (time.perf_counter() - t0) * 1e3
        if form is tree_kernel.populate_device_sorted:
            c_d = torch.cat([torch.zeros((T, N), dtype=torch.float32, device=dev), c_d], dim=1)
            t0 = time.perf_counter()
            ref = tree_kernel.populate_sorted_native(coords, spans, blocks, epochs, N, nb)
            ref_name, ref_ms = "native_ms", (time.perf_counter() - t0) * 1e3
            nbytes = T * (N - 1) * 4
        else:
            t0 = time.perf_counter()
            ref = tree_kernel.populate_device(old, spans, blocks, epochs, N, nb, "cpu")
            ref_name, ref_ms = "cpu_ms", (time.perf_counter() - t0) * 1e3
            nbytes = T * M * 4
        nbytes += T * (8 + 4) + E * 8 + 2 * nb * E * 8
        tree_kernel.program_runs = 0
        fn = lambda: form(c_d, sp_d, bl_d, epochs, N, nb, dev)
        fn()
        runs = tree_kernel.program_runs
        times = {"h2d_ms": h2d, ref_name: ref_ms}
        if form is tree_kernel.populate_device_sorted:
            # as accumulate_tree_stats calls it: numpy in, the copy included
            t0 = time.perf_counter()
            e2e = form(coords, spans, blocks, epochs, N, nb, dev)
            times["end_to_end_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            tree_kernel.populate_sorted_native(coords, spans, blocks, epochs, N, nb)
            times["native_ms_again"] = (time.perf_counter() - t0) * 1e3
            rel = max(rel_err(a, b) for a, b in zip(e2e, ref))
            check(rel <= 1e-12, f"the leaf-zero form from numpy agrees with the native walk ({rel:.3e})")
        rows.append(program_row(name, "colate_tpu_torch/ops/tree_kernel.py",
                                f"colate_tpu/ops/tree_kernel.py:{line}", fn, ref, nbytes, runs, smi,
                                **times))
        del c_d

    # ---- 11. local ancestry: 2 groups, 1,000 segments ----
    cuts = np.unique(np.concatenate([[0], g.integers(1, int(mut.pos[-1]), N_SEGMENTS - 1)]))
    segs = [(int(bp), lab) for bp, lab in zip(cuts, g.integers(0, 2, (cuts.size, N)).astype(np.int32))]
    t0 = time.perf_counter()
    args = CoalLA(epochs, 2, device="cpu").modern_inputs(anc, mut, segs)
    t_items = time.perf_counter() - t0
    S = args[0].shape[0]
    t0 = time.perf_counter()
    ref = la_kernel.la_accumulate_native(*args)
    t_native = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = [torch.as_tensor(a, device=dev) for a in args[:7]]
    torch.cuda.synchronize()
    h2d = (time.perf_counter() - t0) * 1e3
    la_kernel.program_runs = 0
    fn = lambda: la_kernel.la_accumulate_device(*on_card, *args[7:], device=dev)
    fn()
    runs = la_kernel.program_runs
    P = 3
    nbytes = sum(a.nbytes for a in args[:7]) + E * 8 + 2 * args[-1] * E * P * 8
    print(f"local ancestry: {S} (tree, segment) items of {T} trees, {cuts.size} segments, "
          f"2 groups; items built in {t_items:.3f} s", flush=True)
    rows.append(program_row("la_accumulate", "colate_tpu_torch/ops/la_kernel.py",
                            "colate_tpu/ops/la_kernel.py:53", fn, ref, nbytes, runs, smi,
                            h2d_ms=h2d, native_ms=t_native))
    return rows, anc, mut, coords


def tree_cli_phases(tmp: str, anc, mut, coords, smi: str) -> dict:
    """Phases 12-13: modes tree and local_ancestry through the CLI on the
    card, against --torch_device cpu runs of the same written input."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from colate_tpu_torch.fixtures import tree_chromosome, write_anc, write_segment_poplabels
    from colate_tpu_torch.formats.anc import AncFile, node_ages

    prefix = os.path.join(tmp, "trees")
    t0 = time.perf_counter()
    second = tree_chromosome(N_TREES, N_HAP, seed=4243)[:2]
    with ThreadPoolExecutor(2) as ex:
        done = [ex.submit(write_anc, f"{prefix}_chr{c}.anc", a) for c, (a, _) in
                (("1", (anc, mut)), ("2", second))]
        for c, m in (("1", mut), ("2", second[1])):
            m.write(f"{prefix}_chr{c}.mut")
        for f in done:
            f.result()
    chrfile = os.path.join(tmp, "trees_chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("1\n2\n")
    seg = os.path.join(tmp, "trees_seg.poplabels")
    write_segment_poplabels(seg, ["1", "2"], [int(mut.pos[-1]), int(second[1].pos[-1])], N_HAP,
                            N_SEGMENTS, seed=5)
    print(f"tree fixture: 2 x {N_TREES} trees x {N_HAP} haplotypes written in "
          f"{time.perf_counter() - t0:.3f} s ({os.path.getsize(prefix + '_chr1.anc')} bytes a .anc)",
          flush=True)
    back = node_ages(AncFile.read(f"{prefix}_chr1.anc", columns="tree"))
    check(np.array_equal(back, coords), "phase 10 ran on the node ages of the parsed .anc")
    out = {}
    for mode, flags in (("tree", []), ("local_ancestry", ["--poplabels", seg])):
        out.update(tree_mode_runs(mode, flags + ["-i", prefix, "--chr", chrfile], mode, tmp, smi))
    out["input"] = dict(prefix=prefix, chrfile=chrfile)
    return out


def tree_mode_runs(mode: str, argv: list[str], name: str, tmp: str, smi: str) -> dict:
    """Mode tree or local_ancestry through the CLI (--bins TREE_BINS, four
    bootstraps) on argv's input: on the CPU, then twice on the card (cold,
    warm), each run's device program on the card, its rates within 1e-5 of
    the CPU's with the same NaN pattern.  Returns each run's wall, route,
    program runs and stage timings, keyed ``<name>_<cpu|cold|warm>``."""
    import numpy as np

    from colate_tpu_torch import cli
    from colate_tpu_torch.ops import la_kernel, tree_kernel

    done_event, module, card_route = {
        "tree": ("tree_done", tree_kernel, "device-sorted:cuda"),
        "local_ancestry": ("la_done", la_kernel, "device:cuda"),
    }[mode]
    argv = ["--mode", mode, *argv, "--bins", TREE_BINS, "--num_bootstraps", "4"]
    out, rates = {}, {}
    os.environ["COLATE_TPU_LOG"] = "json"
    try:
        for phase in ("cpu", "cold", "warm"):
            out_prefix = os.path.join(tmp, f"{name}_{phase}")
            log = io.StringIO()
            module.program_runs = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(log):
                rc = cli.main(argv + ["-o", out_prefix, "--torch_device",
                                      "cpu" if phase == "cpu" else "cuda"])
            wall = time.perf_counter() - t0
            runs = module.program_runs
            check(rc == 0, f"{name} {phase} exits 0 (got {rc}): {log.getvalue()[-2000:]}")
            ev = [json.loads(x) for x in log.getvalue().splitlines() if x.startswith('{"event": "' + done_event)]
            check(len(ev) == 1, f"{name} {phase} logged {done_event}")
            route = ev[0]["route"]
            if phase == "cpu":
                check("cuda" not in route and runs == 0, f"{name} on the CPU took a host route ({route})")
            else:
                check(route == card_route and runs > 0,
                      f"{name} {phase} ran its device program on the card ({route}, {runs} runs)")
            rates[phase] = read_coal_rates(out_prefix + ".coal")
            st = ev[0]["timings"]
            out[f"{name}_{phase}"] = dict(wall=wall, route=route, program_runs=runs, timings=st)
            print(f"{name} --torch_device {'cpu' if phase == 'cpu' else 'cuda'} ({phase}): wall "
                  f"{wall:.4f} s; " + ", ".join(f"{k} {v:.4f} s" for k, v in st.items())
                  + f"; route {route}, {runs} program runs [{smi}]", flush=True)
    finally:
        del os.environ["COLATE_TPU_LOG"]
    ref = rates["cpu"]
    for phase in ("cold", "warm"):
        r = rates[phase]
        check(r.shape == ref.shape and np.array_equal(np.isnan(r), np.isnan(ref)),
              f"{name} {phase}: shape and NaN pattern of the CPU run")
        ok = np.isfinite(ref)
        rel = rel_err(r[ok], ref[ok])
        check(ok.sum() > 10 and rel <= 1e-5, f"{name} {phase}: rates within 1e-5 ({rel:.3e})")
        out[f"{name}_{phase}"]["max_rel_vs_cpu"] = rel
        print(f"{name} {phase}: .coal {r.shape}, {int(ok.sum())} finite rates, max rel vs "
              f"--torch_device cpu {rel:.3e} (<= 1e-5), NaN pattern equal", flush=True)
    return out


def cli_run(argv: list[str], out_prefix: str) -> dict:
    """One in-process CLI run with JSON logs: its wall, its events by name
    and the launches of each kernel in it (counts set to 0 just before)."""
    import torch

    from colate_tpu_torch import cli
    from colate_tpu_torch.ops import bin_kernel, em_kernel

    os.environ["COLATE_TPU_LOG"] = "json"
    log = io.StringIO()
    em_kernel.launches = bin_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            rc = cli.main(argv + ["-o", out_prefix])
        torch.cuda.synchronize()
    finally:
        del os.environ["COLATE_TPU_LOG"]
    wall = time.perf_counter() - t0
    check(rc == 0, f"CLI run {os.path.basename(out_prefix)} exits 0 (got {rc}): {log.getvalue()[-2000:]}")
    events = {}
    for line in log.getvalue().splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            events[rec["event"]] = rec
    return dict(wall=wall, events=events, em=em_kernel.launches, bin=bin_kernel.launches,
                timings=events["mut_done"]["timings"], provider=events["mut_em"]["provider"])


def same_bytes(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


def checkpoint_phase(argv: list[str], tmp: str, smi: str) -> dict:
    """Phase 14: --checkpoint at B=1024 on the north-star fixture.  An
    uninterrupted run (the EM kernel, one launch at the default chunk of
    4,096 iterations); a process killed after its first 128-iteration
    chunk, which must exit 17 and leave the EM state; the run resumed
    from it (a launch per chunk); a rerun that takes the cached
    histograms.  The three .coal are byte-identical, and equal to phase
    5's run without --checkpoint."""
    from colate_tpu_torch.models import mut_em

    plain = os.path.join(tmp, "out_warm.coal")
    ck = argv + ["--checkpoint"]
    parsed = []
    real = mut_em.compute_suffstats

    def counting(*a, **k):
        parsed.append(1)
        return real(*a, **k)

    mut_em.compute_suffstats = counting
    try:
        whole = os.path.join(tmp, "ck_whole")
        runs = {"uninterrupted": cli_run(ck, whole)}
        check(same_bytes(whole + ".coal", plain), "the --checkpoint run writes the plain run's bytes")
        check(runs["uninterrupted"]["provider"] == "cuda-kernel:float32(checkpointed)",
              f"checkpointed EM on the card ({runs['uninterrupted']['provider']})")
        check(runs["uninterrupted"]["em"] == 1, "one EM launch at the default chunk")

        killed = os.path.join(tmp, "ck_killed")
        env = dict(os.environ, COLATE_TPU_LOG="json", COLATE_EM_CKPT_CHUNK="128",
                   COLATE_EM_DIE_AFTER_CHUNKS="1")
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "colate_tpu_torch", *ck, "-o", killed], cwd=REPO,
                           env=env, capture_output=True, text=True, timeout=300)
        kill_wall = time.perf_counter() - t0
        check(p.returncode == 17, f"the killed run exits 17 (got {p.returncode}): {p.stderr[-2000:]}")
        check(os.path.exists(killed + ".emstate.npz") and not os.path.exists(killed + ".coal"),
              "the killed run leaves its EM state and no .coal")
        os.environ["COLATE_EM_CKPT_CHUNK"] = "128"
        try:
            runs["resumed"] = cli_run(ck, killed)
        finally:
            del os.environ["COLATE_EM_CKPT_CHUNK"]
        check(not os.path.exists(killed + ".emstate.npz"), "the resumed run removes its EM state")
        check(same_bytes(killed + ".coal", whole + ".coal"), "the resumed run writes the uninterrupted bytes")
        it_max = max(runs["resumed"]["events"]["mut_done"]["iters"])
        chunks = -(-it_max // 128)
        check(runs["resumed"]["em"] == chunks - 1,
              f"one EM launch a chunk: {chunks} chunks of 128 to {it_max} iterations, the first in "
              f"the killed process, {runs['resumed']['em']} resumed")

        n_parsed = len(parsed)
        runs["cache hit"] = cli_run(ck, whole)
        check(len(parsed) == n_parsed, "the rerun took the cached histograms (no parse, no binning)")
        check(runs["cache hit"]["timings"]["binning"] == 0.0, "the rerun's binning stage is 0")
        check(same_bytes(whole + ".coal", plain), "the rerun writes the same bytes")
    finally:
        mut_em.compute_suffstats = real
    print(f"--checkpoint killed after its first chunk of 128: exit 17 after {kill_wall:.4f} s "
          f"(one-shot process), .emstate.npz left [{smi}]", flush=True)
    for name, r in runs.items():
        st = r["timings"]
        print(f"mode mut --checkpoint B={B_E2E} {name}: wall {r['wall']:.4f} s; parse {st['parse']:.4f} s, "
              f"binning {st['binning']:.4f} s, bootstrap {st['bootstrap']:.4f} s, em {st['em']:.4f} s; "
              f"{r['em']} EM kernel launches [{smi}]", flush=True)
    print(f"--checkpoint: uninterrupted, killed and resumed, and cached runs byte-identical to the "
          f"plain run; {chunks} EM launches at chunk 128 (1 killed + {runs['resumed']['em']} resumed), "
          f"1 at the default chunk", flush=True)
    return dict(runs, chunk128_launches=chunks)


def shard_phase(sites, argv: list[str], tmp: str, dev, smi: str) -> dict:
    """Phase 15: shards on one card.  dryrun_multichip over [cuda:0] * 4
    with the binning at the whole-genome site count and the EM at B=1024,
    both bitwise equal to one shard, and its mode mut .coal; the CLI with
    --devices 1 --binning sharded against phase 9's --binning sharded; and
    --devices 2 where the machine has two cards."""
    import torch

    from colate_tpu_torch.ops import bin_kernel, em_kernel
    from colate_tpu_torch.parallel.mesh import dryrun_multichip

    card = torch.device(dev.type, torch.cuda.current_device())
    em_kernel.launches = bin_kernel.launches = 0
    t0 = time.perf_counter()
    info = dryrun_multichip(4, devices=[card] * 4, sites=sites, B=B_E2E)
    wall = time.perf_counter() - t0
    info.update(wall=wall, em_launches=em_kernel.launches, bin_launches=bin_kernel.launches)
    print(f"dryrun_multichip(4) on 4 shards of {card} ({len(sites)} sites, {sites.num_blocks} blocks, "
          f"B={B_E2E}): binning 4 shards {info['bin_sharded']:.4f} s, 1 shard {info['bin_one']:.4f} s; "
          f"EM 4 shards {info['em_sharded']:.4f} s, 1 shard {info['em_one']:.4f} s (host clock, "
          f"copies back included); wall {wall:.4f} s with the mode mut leg, {info['bin_launches']} bin "
          f"and {info['em_launches']} EM launches in all; bitwise equal to one shard [{smi}]", flush=True)
    runs = {}
    counts = [1] + ([2] if torch.cuda.device_count() >= 2 else [])
    for n in counts:
        out = os.path.join(tmp, f"devices{n}")
        r = runs[n] = cli_run(argv + ["--binning", "sharded", "--devices", str(n)], out)
        check(r["provider"] == f"mesh[{n}]:cuda-kernel:float32", f"--devices {n} provider {r['provider']}")
        check(r["events"]["mut_suffstats"]["binning"] == "cuda-kernel:float32", f"--devices {n} bins on the card")
        check(r["bin"] == n and r["em"] == n, f"--devices {n}: a bin and an EM launch a card "
              f"({r['bin']}, {r['em']})")
        check(same_bytes(out + ".coal", os.path.join(tmp, "bin_sharded.coal")),
              f"--devices {n} --binning sharded writes --binning sharded's bytes")
        st = r["timings"]
        print(f"mode mut --devices {n} --binning sharded B={B_E2E}: wall {r['wall']:.4f} s; parse "
              f"{st['parse']:.4f} s, binning {st['binning']:.4f} s, bootstrap {st['bootstrap']:.4f} s, "
              f"em {st['em']:.4f} s; provider {r['provider']}, {r['bin']} bin and {r['em']} EM launches; "
              f".coal bytes equal to --binning sharded without --devices [{smi}]", flush=True)
    if len(counts) == 1:
        print(f"--devices 2: not run, the machine has {torch.cuda.device_count()} card", flush=True)
    return dict(dryrun=info, devices=runs)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ranks_phase(argv: list[str], tmp: str, smi: str) -> dict:
    """Phase 16: two ranks of the CLI on the one card (gloo merge), under
    --binning auto and device; rank 0's .coal against the single-process
    card runs of phases 5 and 9."""
    out = {}
    for binning, single in (("auto", "out_warm.coal"), ("device", "bin_warm.coal")):
        prefix = os.path.join(tmp, f"ranks_{binning}")
        port = free_port()
        env = dict(os.environ, COLATE_TPU_LOG="json")
        cmd = [sys.executable, "-m", "colate_tpu_torch", *argv, "--binning", binning, "-o", prefix,
               "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for i in range(2)]
        ranks = []
        try:
            for i, p in enumerate(procs):
                _, err = p.communicate(timeout=300)
                check(p.returncode == 0, f"rank {i} --binning {binning} exits 0: {err[-2000:]}")
                ev = {}
                for line in err.splitlines():
                    if line.startswith("{"):
                        rec = json.loads(line)
                        ev[rec["event"]] = rec
                ranks.append(dict(wall=time.perf_counter() - t0, merge=ev["multihost_merge"],
                                  em=ev["mut_em"], suffstats=ev["mut_suffstats"]))
        finally:
            for p in procs:
                p.kill()
                p.wait(timeout=30)
        check(same_bytes(prefix + ".coal", os.path.join(tmp, single)),
              f"2 ranks --binning {binning}: rank 0 writes the single-process bytes")
        for i, r in enumerate(ranks):
            check(r["merge"]["device"] == "cuda:0" and r["em"]["provider"] == "cuda-kernel:float32",
                  f"rank {i} ran on cuda:0 with the EM kernel")
            print(f"2 ranks on one card, --binning {binning}, B={B_E2E}: rank {i} wall {r['wall']:.4f} s "
                  f"(one-shot process), {r['merge']['chroms_local']} chromosomes, merge "
                  f"(dcn_merge) {r['merge']['sec']:.4f} s, binning {r['suffstats']['binning']}, em "
                  f"{r['em']['sec']:.4f} s [{smi}]", flush=True)
        print(f"2 ranks --binning {binning}: rank 0's .coal byte-identical to the single-process card "
              f"run", flush=True)
        out[binning] = ranks
    return out


def parity_phase(tmp: str, smi: str) -> None:
    """Phase 17: the byte-identity routes (--sampling mc_parity, --em_dtype
    float64) write the same .coal on the card as on the CPU, at B=8 on
    tests/test_torch_cuda.py's fixture."""
    from colate_tpu_torch.fixtures import make_fixture

    fix = make_fixture(os.path.join(tmp, "small"), n_per_chrom=3000, seed=5)
    base = ["--mode", "mut", "--mut", fix["mut_prefix"], "--target_tmp", fix["target"],
            "--reference_tmp", fix["reference"], "--chr", fix["chrfile"], "--bins", BINS,
            "--seed", "3", "--num_bootstraps", "8"]
    for extra in (["--sampling", "mc_parity"], ["--em_dtype", "float64"]):
        runs = {}
        for device in ("cuda", "cpu"):
            prefix = os.path.join(tmp, f"parity_{extra[1]}_{device}")
            runs[device] = cli_run(base + extra + ["--torch_device", device], prefix)
        check(runs["cuda"]["provider"] == "torch:float64(cuda)", f"{extra}: the f64 EM on the card")
        check(same_bytes(*(os.path.join(tmp, f"parity_{extra[1]}_{d}.coal") for d in ("cuda", "cpu"))),
              f"{' '.join(extra)}: the .coal on the card is the CPU's bytes")
        print(f"{' '.join(extra)} B=8: .coal bytes on the card equal --torch_device cpu; em "
              f"{runs['cuda']['timings']['em']:.4f} s on the card, {runs['cpu']['timings']['em']:.4f} s "
              f"on the CPU [{smi}]", flush=True)


def host_reference(argv: list[str], dev):
    """The host side of a BCF or BAM leg: its sites joined in-process, the
    native float64 histograms, and the kernel's histograms of the same
    sites (compare-only launches, outside any counted run)."""
    from colate_tpu_torch import cli
    from colate_tpu_torch.models.mut_em import join_inputs
    from colate_tpu_torch.pipeline.binning import bin_sites_analytic, bin_sites_analytic_native

    cfg = cli.mut_config(cli.build_parser().parse_args(argv + ["-o", os.devnull]))
    with contextlib.redirect_stderr(io.StringIO()):
        sites = join_inputs(cfg)
    return cfg, sites, dict(native=bin_sites_analytic_native(sites),
                            device=bin_sites_analytic(sites, 0.0, dev))


def bcf_bam_leg(name: str, argv: list[str], binning: str, ref, tmp: str, smi: str) -> dict:
    """One mode mut run of a BCF or BAM leg through the CLI on the card at
    B=1024 (the kernels' counts set to 0 just before it, read just after),
    checked against the host: one EM launch (and one binning launch under
    --binning device), the histograms within 2e-5 of native float64, the
    .coal within 1e-3 of the host f64 EM on the run's counts where the
    rate is above 1e-4, and under auto the .colate_mat byte-identical to
    what --torch_device cpu writes (its binning and bootstrap are host
    code)."""
    import numpy as np

    from colate_tpu_torch.config import COLATE_MAT_NORM, age_bin_centers
    from colate_tpu_torch.fixtures import hist_rel
    from colate_tpu_torch.formats.colate_mat import write_colate_mat
    from colate_tpu_torch.models.mut_em import bootstrap_counts, mut_epochs
    from colate_tpu_torch.ops.em import run_em_native

    cfg, sites, hists = ref
    out = os.path.join(tmp, f"{name}_{binning}")
    r = cli_run(argv + ["--binning", binning], out)
    ev = r["events"]
    check(r["provider"] == "cuda-kernel:float32" and r["em"] == 1,
          f"{name} {binning}: one EM kernel launch ({r['provider']}, {r['em']})")
    route = ev["mut_suffstats"]["binning"]
    if binning == "device":
        check(route == "cuda-kernel:float32" and r["bin"] == 1,
              f"{name} device: one binning kernel launch ({route}, {r['bin']})")
    else:
        check(route == "native" and r["bin"] == 0, f"{name} auto: the native binning ({route})")
    used = hists[binning if binning == "device" else "native"]
    rel_hist = hist_rel(list(hists["device"]), list(hists["native"]))
    check(rel_hist <= 2e-5, f"{name}: the kernel's histograms within 2e-5 of native ({rel_hist:.3e})")
    stats = (*used, len(sites), sites.num_blocks)
    check(ev["mut_suffstats"]["sites"] == len(sites) and ev["mut_suffstats"]["blocks"] == sites.num_blocks,
          f"{name} {binning}: the run's sites and blocks are the host join's")
    sc, nc = (c / COLATE_MAT_NORM for c in bootstrap_counts(cfg, stats, cfg.seed))
    epochs, init, _ = mut_epochs(cfg)
    rates, _, _ = run_em_native(epochs, init, sc, nc)
    coal = read_coal_rates(out + ".coal")
    check(coal.shape == rates.shape and bool(np.isfinite(coal).all()), f"{name} {binning}: .coal shape, finite")
    real = rates > 1e-4
    rel = float(np.max(np.abs(coal[real] - rates[real]) / rates[real]))
    check(real.sum() > 100 and rel <= 1e-3, f"{name} {binning}: .coal within 1e-3 of the host f64 EM ({rel:.3e})")
    same_mat = None
    if binning == "auto":
        cpu = os.path.join(tmp, f"{name}_cpu.colate_mat")
        write_colate_mat(cpu, age_bin_centers(), sc, nc)
        same_mat = same_bytes(cpu, out + ".colate_mat")
        check(same_mat, f"{name} auto: .colate_mat byte-identical to the CPU's")
    st = r["timings"]
    print(f"mode mut {name} --binning {binning} B={B_E2E}: wall {r['wall']:.4f} s; parse {st['parse']:.4f} s, "
          f"binning {st['binning']:.4f} s, bootstrap {st['bootstrap']:.4f} s, em {st['em']:.4f} s; "
          f"{len(sites)} sites in {sites.num_blocks} blocks; binning {route}, EM {r['provider']}; "
          f"{r['bin']} bin and {r['em']} EM kernel launches; hists vs native {rel_hist:.3e} (<= 2e-5); "
          f".coal vs host f64 EM {rel:.3e} (<= 1e-3)"
          + ("; .colate_mat = the CPU's" if same_mat else "") + f" [{smi}]", flush=True)
    return dict(r, rel=rel, sites=len(sites), blocks=sites.num_blocks, coal=coal)


def bcf_phase(fix: dict, base: list[str], dev, tmp: str, smi: str) -> dict:
    """Phase 18: the BCF legs on the north-star fixture.  A target BCF2 of
    one sample and a reference of ten (the fixture's 2 and 20 haplotypes)
    a chromosome; --target_bcf/--reference_bcf under --binning auto and
    device, --target_bcf alone (the haplotype half-split) under auto, and a
    rerun that reads the .colate_mat cache."""
    import numpy as np

    from colate_tpu_torch.fixtures import write_fixture_bcfs

    t0 = time.perf_counter()
    bcf = write_fixture_bcfs(fix)
    print(f"BCF2 inputs (4 chromosomes, 1 and 10 samples) written in {time.perf_counter() - t0:.3f} s",
          flush=True)
    legs = {}
    for name, inputs, binnings in (
        ("bcf_bcf", ["--target_bcf", bcf["target_bcf"], "--reference_bcf", bcf["reference_bcf"]],
         ("auto", "device")),
        ("bcf_split", ["--target_bcf", bcf["reference_bcf"]], ("auto",)),
    ):
        argv = base + inputs
        ref = host_reference(argv, dev)
        for binning in binnings:
            legs[f"{name}_{binning}"] = bcf_bam_leg(name, argv, binning, ref, tmp, smi)
    # the .colate_mat cache: a rerun with the cold run's -o skips the parse
    argv = base + ["--target_bcf", bcf["target_bcf"], "--reference_bcf", bcf["reference_bcf"]]
    cold = os.path.join(tmp, "bcf_bcf_auto")
    warm = cli_run(argv + ["--binning", "auto"], cold)
    check(warm["events"]["mut_suffstats"]["binning"] == "colate_mat", "the rerun read the .colate_mat")
    check(warm["em"] == 1 and warm["timings"]["parse"] == 0.0, "the rerun: no parse, one EM launch")
    a, b = read_coal_rates(cold + ".coal"), legs["bcf_bcf_auto"]["coal"]
    real = b > 1e-4
    rel = float(np.max(np.abs(a[real] - b[real]) / b[real]))
    check(rel <= 1e-4, f"the cached rerun's rates within 1e-4 of the cold run's ({rel:.3e})")
    print(f"mode mut bcf_bcf rerun from .colate_mat: wall {warm['wall']:.4f} s, em {warm['timings']['em']:.4f} s, "
          f"binning=colate_mat; identified rates within {rel:.3e} of the cold run's, "
          f"{int((a != b).sum())} of {a.size} printed rates differ (the cache holds 6-digit counts) [{smi}]",
          flush=True)
    legs["bcf_bcf_cached"] = warm
    return legs


def bam_phase(base: list[str], dev, tmp: str, smi: str) -> dict:
    """Phase 19: the BAM legs at tools/bench_bam_stream.py's scale (one
    18 Mb contig, 200k .mut rows, 2M reads a BAM): --target_bam with
    --reference_bcf under --binning auto and device, with --reference_bam
    under auto, and make_tmp --target_bam as a process timed with wait4."""
    import numpy as np

    from colate_tpu_torch.fixtures import make_bam_fixture
    from colate_tpu_torch.formats.colate_in import read_colate_in

    t0 = time.perf_counter()
    bam = make_bam_fixture(os.path.join(tmp, "bam"), N_BAM_READS)
    print(f"BAM inputs: {bam['length']} bp contig, 2 x {bam['n_reads']} reads "
          f"({os.path.getsize(bam['target_bam'])} bytes a BAM), written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    genome = ["--mut", bam["mut_prefix"], "--chr", bam["chrfile"], "--ref_genome", bam["ref_genome"]]
    base = base + genome
    legs = {}
    for name, inputs, binnings in (
        ("bam_bcf", ["--target_bam", bam["target_prefix"], "--reference_bcf", bam["reference_bcf"]],
         ("auto", "device")),
        ("bam_bam", ["--target_bam", bam["target_bam"], "--reference_bam", bam["reference_bam"]],
         ("auto",)),
    ):
        argv = base + inputs
        ref = host_reference(argv, dev)
        for binning in binnings:
            legs[f"{name}_{binning}"] = bcf_bam_leg(name, argv, binning, ref, tmp, smi)
    dec_mb = bam["n_reads"] * (4 + 32 + 2 + 4 + 30 + 60) / 1e6
    floors = {}
    for what in ("colate_tpu_torch", "torch"):
        floors[what] = run = timed_process([sys.executable, "-c", IMPORT, what])
        print(f"a process that imports {what} and exits: wall {run['wall']:.4f} s, max RSS "
              f"{run['max_rss_mb']:.1f} MB (wait4) [{smi}]", flush=True)
    check(not floors["colate_tpu_torch"]["torch"], "importing colate_tpu_torch imports no torch")
    # the native inflate's default of one worker thread (native/hts.cpp),
    # then four on this host's cores
    made_runs = {}
    for threads in (None, 4):
        out = os.path.join(tmp, f"bam_made_{threads or 1}")
        run = timed_process(mode_process(["--mode", "make_tmp", "--target_bam", bam["target_bam"],
                                          *genome, "-o", out]), threads)
        wall, max_rss_mb = run["wall"], run["max_rss_mb"]
        check(not run["torch"], "make_tmp --target_bam imported no torch")
        made_runs[threads or 1] = dict(wall=wall, max_rss_mb=max_rss_mb)
        made = read_colate_in(out + ".colate.in")
        check(len(made) > 1000 and bool(np.all(np.diff(made.bp) > 0))
              and bool(np.all(made.aaf + made.daf > 0)), "make_tmp wrote sorted sites with reads")
        print(f"make_tmp --target_bam, {bam['n_reads']} reads ({dec_mb:.0f} MB decompressed): wall "
              f"{wall:.4f} s ({dec_mb / wall:.1f} MB/s), max RSS {max_rss_mb:.1f} MB (wait4), "
              f"{len(made)} sites; COLATE_BGZF_THREADS {threads or 'unset (1)'}, {os.cpu_count()} "
              f"host cores [{smi}]", flush=True)
    check(same_bytes(os.path.join(tmp, "bam_made_1.colate.in"),
                     os.path.join(tmp, "bam_made_4.colate.in")),
          "make_tmp writes the same bytes with 1 and 4 inflate threads")
    legs["make_tmp"] = dict(made_runs, import_only=floors)
    return legs


# runs the command in its arguments and prints its wall and its own maximum
# resident set (os.wait4, as tools/bench_bam_stream.py measures), and
# whether the command's process imported torch (its last stderr line)
WAIT4 = """
import json, os, subprocess, sys, time
t0 = time.perf_counter()
p = subprocess.Popen(sys.argv[1:], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
err = p.stderr.read().decode()
_, status, ru = os.wait4(p.pid, 0)
print(json.dumps(dict(wall=time.perf_counter() - t0, max_rss_mb=ru.ru_maxrss / 1000.0,
                      rc=os.waitstatus_to_exitcode(status), err=err[-2000:],
                      torch=err.rstrip().endswith("torch imported: True"))))
"""

# a mode of the port's CLI in this process (python -m colate_tpu_torch's
# main), then, as its last stderr line, whether torch was imported in it
RUN_MODE = """
import sys
from colate_tpu_torch import cli
rc = cli.main(sys.argv[1:])
print(f"torch imported: {'torch' in sys.modules}", file=sys.stderr)
sys.exit(rc)
"""
# the same for a process that only imports the module named in its argument
IMPORT = """
import importlib, sys
importlib.import_module(sys.argv[1])
print(f"torch imported: {'torch' in sys.modules}", file=sys.stderr)
"""


def mode_process(argv: list[str]) -> list[str]:
    """The command of a process that runs one mode of the port's CLI."""
    return [sys.executable, "-c", RUN_MODE, *argv]


def timed_process(cmd: list[str], threads: int | None = None) -> dict:
    """Wall and maximum resident set of one process, timed from a small
    launcher (a child forked from this process would report this process's
    resident set as its own maximum), and whether it imported torch."""
    env = dict(os.environ)
    if threads:
        env["COLATE_BGZF_THREADS"] = str(threads)
    p = subprocess.run([sys.executable, "-c", WAIT4, *cmd], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    check(p.returncode == 0, f"the launcher exits 0: {p.stderr[-2000:]}")
    run = json.loads(p.stdout)
    check(run["rc"] == 0, f"{' '.join(cmd[3:5])} exits 0: {run['err']}")
    check(run["err"].rstrip().splitlines()[-1].startswith("torch imported: "),
          f"{' '.join(cmd[3:5])} reported its imports")
    return run


def host_modes_phase(fix: dict, trees: dict, tmp: str, smi: str) -> dict:
    """Phase 21: the last four host modes at full width, each a process
    timed with wait4, none importing torch.  CondCoalRates on the two
    chromosomes of phases 12-13 under the analytic walk; the analytic walk
    against the --sampling mc_parity replay at tools/bench_aux.py's scale
    (CC_GATE), where they must agree within rtol 1e-3 with the same NaN
    pattern, and at the full width on a cut input (CC_WIDTH_TREES trees),
    where only their distance is read; print_tmp, compare_tmp and
    count_topo on the north-star streams."""
    import numpy as np

    from colate_tpu_torch.fixtures import make_stream, tree_chromosome, write_anc

    runs = {}

    def run(name, argv, out):
        r = timed_process(mode_process(argv + ["-o", out]))
        check(not r["torch"], f"{name} imported no torch")
        check(os.path.getsize(out) > 0, f"{name} wrote {out}")
        runs[name] = dict(wall=r["wall"], max_rss_mb=r["max_rss_mb"])
        print(f"{name}: wall {r['wall']:.4f} s, max RSS {r['max_rss_mb']:.1f} MB (wait4), torch "
              f"not imported [{smi}]", flush=True)
        with open(out) as fh:
            return fh.read().splitlines()

    def poplabels(n_samples, foc, con):
        """FOC, CON and OTH samples in turn."""
        path = os.path.join(tmp, f"cond{n_samples}.poplabels")
        with open(path, "w") as fh:
            fh.write("sample population group sex\n")
            fh.writelines(f"S{i} {'FOC' if i < foc else 'CON' if i < con else 'OTH'} G1 NA\n"
                          for i in range(n_samples))
        return path

    def rates(lines):
        check(lines[0] == "boot lineage_epoch epoch.start group rate",
              "CondCoalRates wrote the JAX package's header")
        return np.array([float(ln.split()[4]) for ln in lines[1:]])

    one = os.path.join(tmp, "cond_one.txt")
    with open(one, "w") as fh:
        fh.write("1\n")
    base = ["--mode", "CondCoalRates", "--groups", "FOC,CON", "--num_bootstraps", "4"]
    wide = base + ["--poplabels", poplabels(N_HAP // 2, 33, 66), "--bins", TREE_BINS]
    full = rates(run(f"CondCoalRates analytic, 2 x {N_TREES} trees x {N_HAP} haplotypes",
                     wide + ["-i", trees["prefix"], "--chr", trees["chrfile"]],
                     os.path.join(tmp, "cond_full.txt")))
    check(np.isfinite(full).sum() > 50, f"CondCoalRates: {int(np.isfinite(full).sum())} finite rates")
    gate_trees, gate_hap = CC_GATE
    for name, T, N, argv, gated in (
        ("gate", gate_trees, gate_hap,
         base + ["--poplabels", poplabels(gate_hap // 2, 3, 6), "--bins", "2,6,0.5"], True),
        ("width", CC_WIDTH_TREES, N_HAP, wide, False),
    ):
        t0 = time.perf_counter()
        prefix = os.path.join(tmp, f"cond_{name}")
        anc, mut, _ = tree_chromosome(T, N, seed=17)
        write_anc(prefix + "_chr1.anc", anc)
        mut.write(prefix + "_chr1.mut")
        del anc, mut
        print(f"CondCoalRates input of {T} trees x {N} haplotypes written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        got = {sampling: rates(run(f"CondCoalRates {sampling}, {T} trees x {N} haplotypes",
                                   argv + ["-i", prefix, "--chr", one, "--sampling", sampling],
                                   os.path.join(tmp, f"cond_{name}_{sampling}.txt")))
               for sampling in ("analytic", "mc_parity")}
        a, r = got["analytic"], got["mc_parity"]
        same_nan = bool(np.array_equal(np.isnan(a), np.isnan(r)))
        ok = np.isfinite(r)
        rel = rel_err(a[ok], r[ok])
        runs[f"analytic vs replay, {T} trees x {N} haplotypes"] = dict(
            finite=int(ok.sum()), max_rel=rel, nan_pattern_equal=same_nan)
        print(f"CondCoalRates analytic vs replay, {T} trees x {N} haplotypes: {int(ok.sum())} "
              f"finite rates, max rel {rel:.3e}{' (<= 1e-3)' if gated else ''}, NaN pattern "
              f"equal {same_nan}", flush=True)
        check(same_nan and ok.sum() > 50, f"CondCoalRates at {T} x {N}: same NaN pattern")
        if gated:
            check(rel <= 1e-3, f"CondCoalRates at {T} x {N}: the analytic walk within 1e-3 of "
                               "the replay")

    # print_tmp, compare_tmp, count_topo on the north-star streams
    tmp_in = ["--mut", fix["mut_prefix"], "--target_tmp", fix["target"], "--chr", fix["chrfile"]]
    cond_in = os.path.join(tmp, "third.colate.in")
    make_stream(cond_in, fix["chroms"], fix["mut_tables"], seed=4321, n_hap=20)
    printed = run("print_tmp, 4 x 300k .mut rows", ["--mode", "print_tmp", *tmp_in],
                  os.path.join(tmp, "printed.txt"))
    fields = [ln.split() for ln in printed]
    check(all(len(f) == 8 for f in fields), "print_tmp rows of 8 fields")
    chrom = np.array([f[0] for f in fields])
    bp = np.array([int(f[1]) for f in fields], np.int64)
    known = np.zeros(len(fields), bool)
    for c, mt in zip(fix["chroms"], fix["mut_tables"]):
        known |= (chrom == c) & np.isin(bp, mt.pos)
    check(bool(known.all()), "every (chrom, bp) print_tmp printed is a row of the .mut")
    compared = run("compare_tmp, 4 x 300k .mut rows",
                   ["--mode", "compare_tmp", *tmp_in, "--reference_tmp", fix["reference"],
                    "--seed", "11"], os.path.join(tmp, "compared.txt"))
    check(all(len(ln.split()) == 4 for ln in compared), "compare_tmp rows of 4 fields")
    topo = run("count_topo, 4 x 300k .mut rows",
               ["--mode", "count_topo", *tmp_in, "--reference_tmp", fix["reference"], "-i",
                cond_in, "--seed", "13"], os.path.join(tmp, "topo.txt"))
    check(all(len(ln.split()) == 6 for ln in topo), "count_topo rows of 6 fields")
    print(f"print_tmp {len(printed)} rows, compare_tmp {len(compared)} bins, count_topo "
          f"{len(topo)} sites", flush=True)
    return runs


def clades(anc):
    """Each internal node's leaf set (N-bit masks in uint64 words) and its
    age summed from the branch lengths in float64, ordered by leaf set in
    each tree: ([T, N-1, W] words, [T, N-1] ages).  Two files of the same
    trees under other internal labels give equal arrays."""
    import numpy as np

    T, M = anc.parent.shape
    N = anc.n_hap
    W = (N + 63) // 64
    rows = np.arange(T)[:, None]
    par = np.asarray(anc.parent, np.int64)
    # the two children of internal node N + i sit at 2i, 2i+1 once sorted by parent
    kids = np.argsort(np.where(par < 0, M, par), axis=1, kind="stable")[:, : M - 1]
    c0, c1 = kids[:, 0::2], kids[:, 1::2]
    check(bool((par[rows, c0] == np.arange(N, M)).all() and (par[rows, c1] == np.arange(N, M)).all()),
          "binary trees, internal labels N..2N-2")
    bits = np.zeros((T, M, W), np.uint64)
    leaf = np.arange(N)
    bits[:, leaf, leaf // 64] = np.left_shift(np.uint64(1), (leaf % 64).astype(np.uint64))
    age = np.zeros((T, M))
    bl = np.asarray(anc.branch_length, np.float64)
    for _ in range(M):
        nb = bits[rows, c0] | bits[rows, c1]
        na = np.maximum(age[rows, c0] + bl[rows, c0], age[rows, c1] + bl[rows, c1])
        if np.array_equal(nb, bits[:, N:]) and np.array_equal(na, age[:, N:]):
            break
        bits[:, N:], age[:, N:] = nb, na
    order = np.lexsort([bits[:, N:, w] for w in range(W)], axis=-1)
    return (np.take_along_axis(bits[:, N:], order[..., None], 1),
            np.take_along_axis(age[:, N:], order, 1))


def head_trees(anc, mut, T: int):
    """The first T trees of anc and the .mut rows on them (a row's branch
    list and strings as Python lists)."""
    import dataclasses

    import numpy as np

    n = int(np.searchsorted(mut.tree, T))
    cut = lambda v, k: v[:k] if isinstance(v, np.ndarray) else [v[i] for i in range(k)]
    a = dataclasses.replace(anc, **{f: cut(getattr(anc, f), T) for f in (
        "start_pos", "parent", "branch_length", "num_events", "snp_begin", "snp_end")})
    m = dataclasses.replace(mut, **{f.name: cut(getattr(mut, f.name), n)
                                    for f in dataclasses.fields(mut)
                                    if f.name != "header" and getattr(mut, f.name) is not None})
    return a, m


def library_phase(trees: dict, tmp: str, dev, smi: str) -> dict:
    """Phase 22: the JAX package's library surface in the port, on phase
    12's chromosome 1 cut to N_IMPORT_TREES trees of 200 haplotypes.
    (a) the trees written as Newick, RENT+ and ARGweaver SMC (permuted
    labels) and imported: every internal node's leaf set the source's, its
    age and the sorted node ages per tree within 1e-5 (f32 branch lengths);
    (b) anc_to_tables, write_trees_file, read_trees_file, tables_to_anc:
    the same trees back; (c) mode tree through the CLI on the SMC- and
    Newick-imported .anc (tree_mode_runs); (d) e_step_sampled on the card
    in float64 against the point E-step on the CPU at its ages, two
    generators of one seed bitwise equal; (e) branch association, the tree
    E-step, e_step_interval and annotate_ages timed.  Returns the times."""
    import numpy as np
    import torch

    from colate_tpu_torch.config import INITIAL_COAL_RATE, age_bin_edges
    from colate_tpu_torch.fixtures import write_genealogy
    from colate_tpu_torch.formats import anc as anc_mod
    from colate_tpu_torch.formats.branch_assoc import associate_equivalent_branches
    from colate_tpu_torch.formats.mut import MutTable, annotate_ages
    from colate_tpu_torch.formats.trees import (
        anc_to_tables, read_trees_file, tables_to_anc, write_trees_file,
    )
    from colate_tpu_torch.ops.em import e_step_all_bins, e_step_interval, e_step_sampled
    from colate_tpu_torch.ops.em_tree import em_tree_notshared, em_tree_shared, grid_and_epoch_index
    from colate_tpu_torch.ops.epochs import epochs_from_bins

    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        out[name] = time.perf_counter() - t0
        return r

    full_anc = timed("read_anc_60000", lambda: anc_mod.AncFile.read(trees["prefix"] + "_chr1.anc"))
    full_mut = MutTable.read(trees["prefix"] + "_chr1.mut")
    src, mut = head_trees(full_anc, full_mut, N_IMPORT_TREES)
    T, N = src.num_trees, src.n_hap
    ref_keys, ref_ages = clades(src)
    ref_sorted = np.sort(anc_mod.node_ages(src)[:, N:], 1).astype(np.float64)
    print(f"library surface: {T} trees x {N} haplotypes of phase 12's chromosome 1, "
          f"{len(mut)} .mut rows", flush=True)

    # ---- 22a. the importers ----
    chrfile = os.path.join(tmp, "imp_chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("1\n")
    readers = {"newick": (anc_mod.read_newick_trees, (1.0,)),
               "rent": (anc_mod.read_rent, (RENT_NE,)),
               "smc": (anc_mod.read_argweaver_smc, ())}
    for fmt, (reader, args) in readers.items():
        path = os.path.join(tmp, f"imp.{fmt}")
        timed(f"{fmt}_write", lambda: write_genealogy(path, src, fmt, ne=RENT_NE, seed=22))
        got = timed(f"{fmt}_import", lambda: reader(path, *args))
        check(got.num_trees == T and np.array_equal(got.start_pos, src.start_pos),
              f"{fmt}: {got.num_trees} trees imported at the source's start SNPs")
        ordered = bool(np.all((got.parent > np.arange(2 * N - 1)) | (got.parent < 0)))
        check(ordered == (fmt != "smc"), f"{fmt}: parents numbered after children: {ordered}")
        keys, ages = clades(got)
        check(np.array_equal(keys, ref_keys), f"{fmt}: every internal node's leaf set is the source's")
        rel_clade = rel_err(ages, ref_ages)
        coords = timed(f"{fmt}_node_ages", lambda: anc_mod.node_ages(got))
        rel_sorted = rel_err(np.sort(coords[:, N:], 1).astype(np.float64), ref_sorted)
        check(rel_clade <= 1e-5 and rel_sorted <= 1e-5,
              f"{fmt}: node ages within 1e-5 of the source's ({rel_clade:.3e}, {rel_sorted:.3e})")
        prefix = os.path.join(tmp, f"imp_{fmt}")
        timed(f"{fmt}_anc_write", lambda: got.write(prefix + "_chr1.anc"))
        mut.write(prefix + "_chr1.mut")
        out[f"{fmt}_max_rel_age"] = max(rel_clade, rel_sorted)
        print(f"import {fmt}: {os.path.getsize(path)} bytes written in {out[fmt + '_write']:.4f} s, "
              f"imported in {out[fmt + '_import']:.4f} s; node_ages "
              f"({'native pass' if ordered else 'walk per tree'}) {out[fmt + '_node_ages']:.4f} s; "
              f"AncFile.write {out[fmt + '_anc_write']:.4f} s; leaf sets equal, ages max rel "
              f"{rel_clade:.3e} by leaf set, {rel_sorted:.3e} sorted (<= 1e-5) [{smi}]", flush=True)

    # ---- 22b. the .trees round trip ----
    tb = timed("anc_to_tables", lambda: anc_to_tables(src, mut))
    path = os.path.join(tmp, "imp.trees")
    timed("write_trees_file", lambda: write_trees_file(tb, path))
    back = timed("read_trees_file", lambda: read_trees_file(path))
    check(np.array_equal(back.node_time, tb.node_time) and back.edge_left.size == tb.edge_left.size
          and np.array_equal(back.mut_node, tb.mut_node), ".trees: nodes, edges, mutations read back")
    rt = timed("tables_to_anc", lambda: tables_to_anc(back, N))
    keys, ages = clades(rt)
    rel = rel_err(ages, ref_ages)
    check(rt.num_trees == T and np.array_equal(keys, ref_keys) and rel <= 1e-5,
          f".trees round trip: the source's trees and ages ({rel:.3e})")
    out["trees_max_rel_age"] = rel
    print(f".trees round trip: anc_to_tables {out['anc_to_tables']:.4f} s ({tb.edge_left.size} edges, "
          f"{tb.site_pos.size} sites), write_trees_file {out['write_trees_file']:.4f} s "
          f"({os.path.getsize(path)} bytes), read_trees_file {out['read_trees_file']:.4f} s, "
          f"tables_to_anc {out['tables_to_anc']:.4f} s; parents (by leaf set) equal, ages max rel "
          f"{rel:.3e} [{smi}]", flush=True)

    # ---- 22c. mode tree on the imported genealogies ----
    for fmt in ("smc", "newick"):
        argv = ["-i", os.path.join(tmp, f"imp_{fmt}"), "--chr", chrfile]
        out.update(tree_mode_runs("tree", argv, f"tree_on_{fmt}", tmp, smi))

    # ---- 22d. the sampled E-step on the card ----
    epochs_np = epochs_from_bins(BINS, 28.0, 0.0)[0]
    E = epochs_np.shape[0]
    rates_np = INITIAL_COAL_RATE * np.exp(np.random.default_rng(31).uniform(-2.0, 2.0, E))
    edges = age_bin_edges()
    a_np, b_np = np.tile(edges[:-1], N_DRAWS), np.tile(edges[1:], N_DRAWS)
    epochs, rates, a, b = (torch.as_tensor(x, device=dev) for x in (epochs_np, rates_np, a_np, b_np))
    draw = lambda seed: e_step_sampled(epochs, rates, torch.Generator(device=dev).manual_seed(seed),
                                       a, b)
    first, again = draw(5), draw(5)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(first, again)),
          "e_step_sampled: two generators of one seed, bitwise equal outputs")
    t = first[-1]
    check(bool(((t >= a) & (t <= b)).all()), "e_step_sampled: every age in its interval")
    t_cpu = t.cpu()
    ep_cpu = torch.from_numpy(epochs_np)
    k = torch.clamp(torch.searchsorted(ep_cpu, t_cpu, right=True) - 1, 0, E - 1)
    t0 = time.perf_counter()
    ref = e_step_all_bins(ep_cpu, torch.from_numpy(rates_np)[None], t_cpu, k)
    out["e_step_sampled_cpu_ms"] = (time.perf_counter() - t0) * 1e3
    pairs = [(x.cpu().numpy(), y[0].numpy()) for x, y in zip(first[:-1], ref)]
    norm_err = max(float(np.abs(x - y).max() / np.abs(y).max()) for x, y in pairs)
    check(all(np.isfinite(x).all() for x, _ in pairs) and norm_err <= 1e-12,
          f"e_step_sampled on the card within 1e-12 of the CPU's point E-step ({norm_err:.3e})")
    # elementwise, where both sides are nonzero; an exposure that cancels to
    # about 0 is clamped at 0 on one side and not the other
    elem_err = max(float((np.abs(x - y)[m] / np.abs(y[m])).max(initial=0.0))
                   for x, y in pairs for m in [(x != 0) & (y != 0)])
    one_zero = [((x == 0) != (y == 0), x - y) for x, y in pairs]
    n_one_zero = sum(int(m.sum()) for m, _ in one_zero)
    one_zero_max = max(float(np.abs(d[m]).max(initial=0.0)) for m, d in one_zero)
    out["e_step_sampled_ms"] = cuda_ms(lambda: draw(5), 5)
    out.update(e_step_sampled_norm_err=norm_err, e_step_sampled_elem_rel_err=elem_err,
               e_step_sampled_zero_on_one_side=n_one_zero)
    print(f"e_step_sampled, float64, {t.numel()} ages (185 bins x {N_DRAWS}) x {E} epochs: "
          f"{out['e_step_sampled_ms']:.4f} ms on the card (CUDA events), the point E-step on the "
          f"CPU {out['e_step_sampled_cpu_ms']:.4f} ms; max |diff| / max |CPU| {norm_err:.3e} "
          f"(<= 1e-12), elementwise max rel {elem_err:.3e} where both are nonzero, "
          f"{n_one_zero} entries 0 on one side only (largest {one_zero_max:.3e}); ages in their "
          f"intervals, two generators of one seed bitwise equal [{smi}]", flush=True)
    del first, again, ref

    # ---- 22e. host functions ----
    chain, _ = head_trees(full_anc, full_mut, N_ASSOC_TREES)
    chain.num_events = chain.num_events.copy()
    chain.snp_begin, chain.snp_end = chain.snp_begin.copy(), chain.snp_end.copy()
    maps = timed("associate_equivalent_branches", lambda: associate_equivalent_branches(chain))
    paired = float(np.mean([(m != -1).mean() for m in maps]))
    check(len(maps) == N_ASSOC_TREES - 1, "branch association: a map a pair of adjacent trees")
    tepochs = np.asarray(epochs_from_bins(TREE_BINS, 28.0, 0.0)[0])
    grid, _ = grid_and_epoch_index(tepochs)
    coords = anc_mod.node_ages(chain)
    up = np.take_along_axis(coords, np.maximum(chain.parent, 0), 1)
    # lineages of each tree at each grid edge, and a DAF that falls with age
    lins = [((coords[i] <= grid[:, None]) & ((chain.parent[i] < 0) | (up[i] > grid[:, None])))
            .sum(1).astype(np.float32) for i in range(N_ASSOC_TREES)]
    daf = np.clip(1.0 - np.arange(grid.size) / 120.0, 0.0, 1.0).astype(np.float32)
    tr = np.full(tepochs.size, INITIAL_COAL_RATE)
    a_age, b_age = grid[60], grid[90]

    def tree_steps():
        res = [(em_tree_shared(tepochs, tr, k, daf, a_age, b_age),
                em_tree_notshared(tepochs, tr, k, daf, a_age, b_age)) for k in lins]
        check(all(np.isfinite(s[0]).all() and np.isfinite(n[1]).all() for s, n in res),
              "the tree E-step: finite sums")

    timed("em_tree_200_trees", tree_steps)
    interval = timed("e_step_interval", lambda: e_step_interval(epochs_np, rates_np, edges[:-1],
                                                                edges[1:]))
    check(all(np.isfinite(x).all() for x in interval), "e_step_interval: finite")
    full_coords = anc_mod.node_ages(full_anc)
    timed("annotate_ages", lambda: annotate_ages(full_mut, full_anc))
    br = np.array([b[0] for b in full_mut.branch])
    c = full_coords[full_mut.tree, br].astype(np.float64)
    check(bool(np.all(np.abs(full_mut.age_begin - c) <= 1e-5 * c + 1e-3)),
          "annotate_ages: each row's age_begin its node's age")
    print(f"branch association, {N_ASSOC_TREES} trees x {N} haplotypes: "
          f"{out['associate_equivalent_branches']:.4f} s, {paired:.4f} of branches paired; the tree "
          f"E-step (shared and notshared, {len(lins)} trees' lineage counts) "
          f"{out['em_tree_200_trees']:.4f} s; e_step_interval, 185 intervals x {E} epochs "
          f"{out['e_step_interval']:.4f} s; annotate_ages on {len(full_mut)} rows of "
          f"{full_anc.num_trees} trees {out['annotate_ages']:.4f} s [{smi}]", flush=True)
    return out


def bcf_bam_parity_phase(tmp: str, smi: str) -> None:
    """Phase 20: --sampling mc_parity --em_dtype float64 at 8 replicates on
    a small fixture (tests/test_mut_bam.py's scale), --target_bcf alone
    and --target_bam/--reference_bcf: the .coal on the card byte-identical
    to --torch_device cpu."""
    from colate_tpu_torch.fixtures import make_bcf_bam_fixture

    bb = make_bcf_bam_fixture(os.path.join(tmp, "bb"))
    for kind in ("bcf_split", "bam_bcf"):
        runs = {}
        for device in ("cuda", "cpu"):
            runs[device] = cli_run(
                ["--mode", "mut", "--mut", bb["mut_prefix"], "--chr", bb["chrfile"], "--bins", BINS,
                 "--seed", "43", "--num_bootstraps", "8", "--sampling", "mc_parity", "--em_dtype",
                 "float64", *bb["inputs"][kind], "--torch_device", device],
                os.path.join(tmp, f"bbpar_{kind}_{device}"))
        check(runs["cuda"]["provider"] == "torch:float64(cuda)", f"{kind} parity: the f64 EM on the card")
        check(same_bytes(*(os.path.join(tmp, f"bbpar_{kind}_{d}.coal") for d in ("cuda", "cpu"))),
              f"{kind} mc_parity/float64: the .coal on the card is the CPU's bytes")
        print(f"{kind} --sampling mc_parity --em_dtype float64 B=8: .coal bytes on the card equal "
              f"--torch_device cpu; em {runs['cuda']['timings']['em']:.4f} s on the card, "
              f"{runs['cpu']['timings']['em']:.4f} s on the CPU [{smi}]", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the device during the EM and time "
                         "one-shot CLI processes")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from colate_tpu_torch import cli, native
    from colate_tpu_torch.fixtures import (
        bench_sites, beyond_table_sites, hist_rel, make_fixture, synthetic_sites,
    )
    from colate_tpu_torch.models.mut_em import (
        bootstrap_counts, join_inputs, mut_epochs, suffstats,
    )
    from colate_tpu_torch.ops import bin_kernel, em_kernel
    from colate_tpu_torch.ops.em import run_em, run_em_native
    from colate_tpu_torch.pipeline.binning import bin_sites_analytic, bin_sites_analytic_native

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"card: {card}", flush=True)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:  # the kernels and the native host library together
        host = ex.submit(timed, native.load)
        builds = [ex.submit(m.kernel_library) for m in (em_kernel, bin_kernel)]
        builds = [f.result() for f in builds]
        host_s = host.result()
    print(f"kernels and the native host library built in {time.perf_counter() - t0:.3f} s; "
          f"the native library ({', '.join(native.SOURCES)}) loaded in {host_s:.3f} s, its g++ "
          f"build included when {os.path.basename(native.library_path())} was not built yet",
          flush=True)
    for built in builds:
        print(f"{os.path.basename(built.path)}: nvcc {built.seconds:.3f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="colate_smoke_") as tmp:
        # the north-star fixture and the main path's configuration
        t0 = time.perf_counter()
        fix = make_fixture(tmp, chroms=("1", "2", "3", "4"), n_per_chrom=300_000, seed=1234)
        print(f"fixture 4 x 300k rows made in {time.perf_counter() - t0:.3f} s", flush=True)
        argv = [
            "--mode", "mut", "--mut", fix["mut_prefix"],
            "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
            "--chr", fix["chrfile"], "--bins", BINS, "--seed", "1",
            "--num_bootstraps", str(B_E2E), "--torch_device", "cuda",
        ]
        cfg = cli.mut_config(cli.build_parser().parse_args(argv + ["-o", os.path.join(tmp, "cfg")]))
        epochs, init, _ = mut_epochs(cfg)
        E = epochs.shape[0]
        consts = em_kernel.bin_constants(epochs)
        t_bins, k_bins = consts["t"].astype(np.float64), consts["k"]
        init32 = torch.tensor(init, dtype=torch.float32, device=dev)
        rates0 = lambda B: init32.expand(B, E).contiguous()

        # ---- 1. kernel against its twin, one K-iteration chunk ----
        max_abs = 0.0
        for B in (5, 128, 1024):
            sc, nc = synthetic_counts(t_bins, B, seed=11)
            r0 = rates0(B)
            s = torch.as_tensor(sc, dtype=torch.float32, device=dev)
            n = torch.as_tensor(nc, dtype=torch.float32, device=dev)
            rk, wk = em_kernel.em_chunk(epochs, r0, s, n, K)
            torch.cuda.synchronize()
            rt, wt = em_kernel.em_chunk_reference(epochs, r0, s, n, K)
            rk, rt = rk.cpu().numpy(), rt.cpu().numpy()
            llk = wk.double().sum(1).cpu().numpy()
            llt = wt.double().sum(1).cpu().numpy()
            nz = rt != 0
            rel = float(np.max(np.abs(rk[nz] - rt[nz]) / np.abs(rt[nz])))
            ll_rel = float(np.max(np.abs(llk - llt) / np.abs(llt)))
            max_abs = max(max_abs, float(np.max(np.abs(rk - rt))))
            print(f"kernel vs twin B={B}: rates rel {rel:.3e} (<= 1e-4), "
                  f"ll rel {ll_rel:.3e} (<= 3e-6)", flush=True)
            check(bool(np.isfinite(rk).all()), f"finite kernel rates at B={B}")
            check(rel <= 1e-4, f"kernel rates within 1e-4 of the twin at B={B}")
            check(np.array_equal(rk == 0, rt == 0), f"same zero pattern at B={B}")
            check(ll_rel <= 3e-6, f"kernel ll within 3e-6 of the twin at B={B}")

        # ---- 2. a replicate's result does not depend on B ----
        sc, nc = synthetic_counts(t_bins, 6, seed=12)
        s = torch.as_tensor(sc, dtype=torch.float32, device=dev)
        n = torch.as_tensor(nc, dtype=torch.float32, device=dev)
        r0 = rates0(6)
        r6, w6 = em_kernel.em_chunk(epochs, r0, s, n, K)
        r5, w5 = em_kernel.em_chunk(
            epochs, r0[:5].contiguous(), s[:5].contiguous(), n[:5].contiguous(), K,
        )
        check(torch.equal(r6[:5], r5) and torch.equal(w6[:5], w5), "bitwise B-invariance")
        print("kernel B=6 vs B=5: first 5 replicates bitwise equal", flush=True)

        # ---- 3. the fixture's bootstrap counts and the host f64 EM ----
        t0 = time.perf_counter()
        stats = suffstats(cfg, cfg.seed)
        num_sites, nb = stats[4:6]
        print(f"suffstats in {time.perf_counter() - t0:.3f} s: {num_sites} sites in {nb} "
              f"blocks", flush=True)
        sc, nc = bootstrap_counts(cfg, stats, cfg.seed)
        t0 = time.perf_counter()
        r_native, _, it_native = run_em_native(epochs, init, sc, nc)
        t_native = time.perf_counter() - t0
        print(f"host f64 EM at B={B_E2E}: {t_native:.3f} s, {int(it_native.max())} "
              f"iterations", flush=True)

        # ---- 4. the whole EM in one launch: against the host f64 EM, its
        # plain version and the chunked route, at the main path's counts ----
        s_all = torch.as_tensor(sc, dtype=torch.float32, device=dev)
        n_all = torch.as_tensor(nc, dtype=torch.float32, device=dev)
        before = em_kernel.launches
        one = em_kernel.run_em_kernel(epochs, init, s_all, n_all)
        torch.cuda.synchronize()
        check(em_kernel.launches == before + 1, "the whole EM is one launch")
        r_one, it_one = one[0].cpu().numpy(), one[2].cpu().numpy()
        strong, weak = tiers(r_one[:128], r_native[:128])
        print(f"run_em_kernel vs host f64 EM, B=128: identified rel {strong:.3e} "
              f"(<= 1e-4), weak rel {weak:.3e} (<= 2e-2)", flush=True)
        check(strong <= 1e-4 and weak <= 2e-2, "f32 tiers at B=128")
        sub = em_kernel.run_em_kernel(epochs, init, s_all[:64].contiguous(), n_all[:64].contiguous())
        check(all(torch.equal(a[:64], b) for a, b in zip(one, sub)),
              "replicates 0..63 alone equal themselves in a run of 1024")
        print(f"run_em_kernel: replicates 0..63 alone bitwise equal to B={B_E2E}", flush=True)
        state0 = (rates0(B_E2E), torch.full((B_E2E,), -torch.inf, dtype=torch.float64, device=dev),
                  torch.zeros(B_E2E, dtype=torch.bool, device=dev),
                  torch.zeros(B_E2E, dtype=torch.int32, device=dev))
        run_args = (0, 100_000, 1000, K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = em_kernel.em_run_reference(epochs, state0[0], s_all, n_all, *state0[1:], *run_args)
        torch.cuda.synchronize()
        plain_run_ms = (time.perf_counter() - t0) * 1e3
        r_ref, it_ref = ref[0].double().cpu().numpy(), ref[3].cpu().numpy()
        strong, weak = tiers(r_one, r_ref)
        run_abs = float(np.abs(r_one - r_ref).max())
        print(f"whole EM, kernel vs em_run_reference on the card, B={B_E2E}: identified rel "
              f"{strong:.3e} (<= 1e-4), weak rel {weak:.3e}, max abs {run_abs:.3e}; iterations "
              f"equal for {float(np.mean(it_one == it_ref)):.4f} of replicates, |diff| mean "
              f"{float(np.abs(it_one - it_ref).mean()):.2f} max {int(np.abs(it_one - it_ref).max())}",
              flush=True)
        check(strong <= 1e-4, "whole EM within 1e-4 of its plain version on identified rates")
        check(np.array_equal(r_one == 0, r_ref == 0), "whole EM: same zero pattern as its plain version")

        def chunked_route():
            def step(rates, k):
                new, wsum = em_kernel.em_chunk(epochs, rates.contiguous(), s_all, n_all, k)
                return new, wsum.to(torch.float64).sum(1)
            return run_em(epochs, init, s_all, n_all, dtype="float32", check_every=K,
                          device=dev, step=step)

        before = em_kernel.launches
        chunked = chunked_route()
        torch.cuda.synchronize()
        chunk_launches = em_kernel.launches - before
        it_ch = chunked[2].cpu().numpy()
        same = it_ch == it_one
        bitwise = torch.equal(chunked[0][torch.as_tensor(same, device=dev)],
                              one[0][torch.as_tensor(same, device=dev)])
        print(f"whole EM, one launch vs the chunked route ({chunk_launches} launches): iterations "
              f"equal for {int(same.sum())} of {B_E2E} replicates, their rates bitwise equal "
              f"{bitwise}", flush=True)
        check(same.mean() >= 0.99 and bitwise,
              "the one launch stops where the chunked route does (f64 sums aside)")
        out = run_em(epochs, init, sc[:8], nc[:8], dtype="float64", device=dev)
        r64 = out[0].cpu().numpy()
        rel64 = float(np.max(np.abs(r64 - r_native[:8]) / np.maximum(np.abs(r_native[:8]), 1e-300)))
        print(f"torch f64 EM on the card vs host f64 EM, B=8: rates rel {rel64:.3e} "
              f"(<= 1e-9), iterations equal {np.array_equal(out[2].cpu().numpy(), it_native[:8])}",
              flush=True)
        check(rel64 <= 1e-9, "torch f64 EM on the card within 1e-9 of the host EM")

        # ---- 5. the main path: mode mut through the CLI, B=1024 ----
        runs = {}
        for phase in ("cold", "warm"):
            out_prefix = os.path.join(tmp, f"out_{phase}")
            r = cli_run(argv, out_prefix)
            wall, n_launch, events = r["wall"], r["em"], r["events"]
            check(r["provider"] == "cuda-kernel:float32",
                  f"{phase} run took the CUDA kernel (provider {r['provider']})")
            check(n_launch == 1, f"{phase} run launched the EM kernel once (got {n_launch})")
            coal = read_coal_rates(out_prefix + ".coal")
            check(coal.shape == (B_E2E, E), f"{phase} .coal shape {coal.shape}")
            check(bool(np.isfinite(coal).all()), f"{phase} .coal rates finite")
            real = r_native > 1e-4
            rel = float(np.max(np.abs(coal[real] - r_native[real]) / r_native[real]))
            check(rel <= 1e-3, f"{phase} .coal within 1e-3 of the host f64 EM ({rel:.3e})")
            runs[phase] = dict(wall=wall, launches=n_launch, rel=rel,
                               timings=events["mut_done"]["timings"],
                               iters=int(events["mut_em"]["iters"]))
            st = runs[phase]["timings"]
            print(f"mode mut B={B_E2E} {phase}: wall {wall:.4f} s; parse {st['parse']:.4f} s, "
                  f"binning {st.get('binning', 0.0):.4f} s, bootstrap {st['bootstrap']:.4f} s, "
                  f"em {st['em']:.4f} s; {n_launch} kernel launches, {runs[phase]['iters']} "
                  f"iterations; .coal vs host f64 EM rel {rel:.3e} (<= 1e-3) [{smi}]", flush=True)

        # ---- 6. times: a chunk, and the whole EM against the chunked route ----
        info = em_kernel.kernel_info(E)
        print(f"EM kernel at E={E}: {info['registers']} registers, {info['spill_bytes']} spill "
              f"bytes a thread, {info['smem_bytes']} B shared memory and {info['ctas_per_sm']} "
              f"CTAs an SM [{smi}]", flush=True)
        for B in (8, 128, 528, 1024):  # 1, 4 and 8 replicates an SM
            r0 = rates0(B)
            s = torch.as_tensor(sc[:B], dtype=torch.float32, device=dev)
            n = torch.as_tensor(nc[:B], dtype=torch.float32, device=dev)
            ms_k = cuda_ms(lambda: em_kernel.em_chunk(epochs, r0, s, n, K), 50)
            ms_t = cuda_ms(lambda: em_kernel.em_chunk_reference(epochs, r0, s, n, K), 10)
            b_ms, _ = em_bound(k_bins, E, sc[:B], nc[:B], np.full(B, K))
            t0 = time.perf_counter()
            rn = run_em_native(epochs, init, sc[:B], nc[:B])
            s_native = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rk = em_kernel.run_em_kernel(epochs, init, s, n)
            torch.cuda.synchronize()
            s_kernel = time.perf_counter() - t0
            print(f"B={B}: per {K}-iteration chunk kernel {ms_k:.4f} ms (bound {b_ms:.4f} ms, "
                  f"{b_ms / ms_k:.4f} of it), plain {ms_t:.4f} ms; EM to convergence host native "
                  f"{s_native:.4f} s ({int(rn[2].max())} it), run_em_kernel {s_kernel:.4f} s "
                  f"({int(rk[2].max())} it) [{smi}]", flush=True)
        whole = {"one launch": [], "chunked route": []}
        for name in ("one launch", "chunked route", "chunked route", "one launch"):
            fn = (lambda: em_kernel.run_em_kernel(epochs, init, s_all, n_all)) \
                if name == "one launch" else chunked_route
            whole[name].append(cuda_ms(fn, 3))
        em_ms = min(whole["one launch"])
        em_bound_ms, em_bound_by = em_bound(k_bins, E, sc, nc, it_one)
        print(f"whole EM at B={B_E2E} ({int(it_one.max())} iterations at most, {int(it_one.sum())} "
              f"summed over replicates, {em_ops(k_bins, E, sc, nc, it_one) / 1e9:.4f} GFLOP), "
              f"CUDA events, in turns: one launch "
              f"{', '.join(f'{t:.4f}' for t in whole['one launch'])} ms; chunked route "
              f"({chunk_launches} launches and host checks) "
              f"{', '.join(f'{t:.4f}' for t in whole['chunked route'])} ms; plain version "
              f"{plain_run_ms:.4f} ms; bound {em_bound_ms:.4f} ms ({em_bound_by}), "
              f"{em_bound_ms / em_ms:.4f} of it [{smi}]", flush=True)

        if opts.profile:
            profile_em(lambda: em_kernel.run_em_kernel(epochs, init, s_all, n_all), smi)
            sweep_ctas(epochs, init, s_all, n_all, smi)
            time_processes(argv, tmp, smi)

        # ---- 7. the binning kernel against its plain version and native f64 ----
        bin_abs = 0.0
        cases = {
            "bench generator 1M sites, 125 blocks": (bench_sites(1_000_000), 0.0),
            "age 30": (synthetic_sites(age=30.0, seed=1), 30.0),
            "unsorted ids, 4000 sites": (synthetic_sites(n=4000, sorted_blocks=False), 0.0),
            "3000 blocks": (synthetic_sites(n=20000, nb=3000, seed=4), 0.0),
            "empty": (synthetic_sites(n=0, nb=0), 0.0),
            "3 sites": (synthetic_sites(n=3, nb=1, seed=5), 0.0),
            "ages beyond the table": (beyond_table_sites(), 0.0),
            "north-star fixture (the main path's sites)": (join_inputs(cfg), 0.0),
        }
        for name, (sites, age) in cases.items():
            stream = bin_kernel.site_stream(sites, age).to(dev)
            hk = bin_kernel.bin_chunks(stream)
            torch.cuda.synchronize()
            hp = bin_kernel.bin_chunks_reference(stream)
            hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
            nb = sites.num_blocks
            check(hk.shape == (nb, 4, 185), f"{name}: kernel histograms {hk.shape}")
            check(bool(np.isfinite(hk).all()), f"{name}: finite kernel histograms")
            ours = [hk[:, j] for j in range(4)]
            rel_plain = hist_rel(ours, [hp[:, j] for j in range(4)])
            rel_native = hist_rel(ours, bin_sites_analytic_native(sites, age))
            if hk.size:
                bin_abs = max(bin_abs, float(np.abs(hk - hp).max()))
            e2e = bin_sites_analytic(sites, age, dev)
            same = all(np.array_equal(a, b) for a, b in zip(e2e, ours))
            print(f"bin kernel, {name} ({len(sites)} sites, {nb} blocks, {stream.n_chunks} "
                  f"chunks, {stream.n_segs} segments): vs plain {rel_plain:.3e} (<= 2e-5), vs native f64 "
                  f"{rel_native:.3e} (<= 5e-5)", flush=True)
            check(rel_plain <= 2e-5, f"{name}: bin kernel within 2e-5 of its plain version")
            check(rel_native <= 5e-5, f"{name}: bin kernel within 5e-5 of native f64")
            check(same, f"{name}: bin_sites_analytic on the card gives the kernel's sums")
        sites = cases["bench generator 1M sites, 125 blocks"][0]
        stream = bin_kernel.site_stream(sites).to(dev)
        again = [bin_kernel.bin_chunks(stream) for _ in range(2)]
        check(torch.equal(*again), "two launches on one input bin bitwise identically")
        print("bin kernel: two launches on the 1M sites bitwise equal", flush=True)
        whole = bin_sites_analytic(sites, 0.0, dev)
        cut = int(np.searchsorted(sites.block_id, 60))
        halves = [bin_sites_analytic(type(sites)(
            age_begin=sites.age_begin[lo:hi], age_end=sites.age_end[lo:hi],
            w_shared=sites.w_shared[lo:hi], w_notshared=sites.w_notshared[lo:hi],
            block_id=sites.block_id[lo:hi], num_blocks=sites.num_blocks,
        ), 0.0, dev) for lo, hi in ((0, cut), (cut, len(sites)))]
        check(all(np.array_equal(w, a + b) for w, a, b in zip(whole, *halves)),
              "a split at a block boundary bins bitwise identically")
        print(f"bin kernel: 1M sites split at site {cut} (block 60) bitwise equal", flush=True)
        del cases, sites, stream, again, whole, halves

        # ---- 8. the whole-genome site count: 22.2M sites in 125 blocks ----
        t0 = time.perf_counter()
        sites = bench_sites(N_WHOLE_GENOME)
        t_gen = time.perf_counter() - t0
        t_prep, stream_host = [], None
        for _ in range(3):  # the first page-locks its buffers, the others reuse them
            stream_host = None
            t0 = time.perf_counter()
            stream_host = bin_kernel.site_stream(sites, pin=True)
            t_prep.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream = stream_host.to(dev)
        torch.cuda.synchronize()
        t_h2d = time.perf_counter() - t0
        bin_ms = cuda_ms(lambda: bin_kernel.bin_chunks(stream), 20)
        bin_plain_ms = cuda_ms(lambda: bin_kernel.bin_chunks_reference(stream), 1)
        hk = bin_kernel.bin_chunks(stream).cpu().numpy()
        hp = bin_kernel.bin_chunks_reference(stream).cpu().numpy()
        bin_abs = max(bin_abs, float(np.abs(hk - hp).max()))
        ours = [hk[:, j] for j in range(4)]
        rel_plain = hist_rel(ours, [hp[:, j] for j in range(4)])
        t_native, native = [], None
        for _ in range(2):
            t0 = time.perf_counter()
            native = bin_sites_analytic_native(sites)
            t_native.append(time.perf_counter() - t0)
        rel_native = hist_rel(ours, native)
        t_e2e = []
        for _ in range(3):
            t0 = time.perf_counter()
            e2e = bin_sites_analytic(sites, 0.0, dev)
            t_e2e.append(time.perf_counter() - t0)
        same = all(np.array_equal(a, b) for a, b in zip(e2e, ours))
        n_wg = len(sites)
        rate = lambda sec: n_wg / sec / 1e6
        # each site read once (four f32 columns and its meta), the chunk
        # table and the edges read once, each block's four f64 histograms
        # written once
        in_bytes = sum(getattr(stream, name).nbytes for name in (
            "fv", "meta", "chunk_start", "chunk_n", "block_chunks", "seg_first", "block_seg"))
        bin_bytes = in_bytes + 186 * 4 + sites.num_blocks * 4 * 185 * 8
        ops = bin_ops(sites, 0.0)
        bin_bound_ms, bin_bound_by = bound_ms(ops, bin_bytes)
        emp, lo, hi = bin_ranges(sites, 0.0)
        nbins = np.maximum(hi - lo + 1, 0)
        print(f"whole genome: {n_wg} sites, {sites.num_blocks} blocks, {stream.n_chunks} chunks, "
              f"{stream.n_segs} segments (generated in {t_gen:.3f} s); bins a site needs: "
              f"{nbins.mean():.3f} ({nbins[~emp].mean():.3f} regular, {nbins[emp].mean():.3f} emp); "
              f"{ops / 1e9:.4f} GFLOP, {bin_bytes} bytes [{smi}]", flush=True)
        del emp, lo, hi, nbins
        print(f"  kernel, stream resident on the card: {bin_ms:.4f} ms ({rate(bin_ms / 1e3):.1f}M "
              f"sites/s); bound {bin_bound_ms:.4f} ms ({bin_bound_by}), {bin_bound_ms / bin_ms:.4f} "
              f"of it")
        print(f"  plain torch version on the card:     {bin_plain_ms:.4f} ms "
              f"({rate(bin_plain_ms / 1e3):.1f}M sites/s)")
        print(f"  host preparation of the site stream {', '.join(f'{t:.4f}' for t in t_prep)} s "
              f"(the first page-locks its buffers; {rate(min(t_prep)):.1f}M sites/s), host-to-device copy from page-locked memory "
              f"{t_h2d:.4f} s of {in_bytes} bytes")
        print(f"  bin_sites_analytic end to end (preparation + copy + kernel + copy back): "
              f"{', '.join(f'{t:.4f}' for t in t_e2e)} s ({rate(min(t_e2e)):.1f}M sites/s)")
        print(f"  native cn_bin_analytic on the host: {', '.join(f'{t:.4f}' for t in t_native)} s "
              f"({rate(min(t_native)):.1f}M sites/s)")
        print(f"  kernel vs plain {rel_plain:.3e} (<= 2e-5), vs native f64 {rel_native:.3e} "
              f"(<= 5e-5), max abs vs plain {bin_abs:.3e}", flush=True)
        check(rel_plain <= 2e-5, "whole genome: bin kernel within 2e-5 of its plain version")
        check(rel_native <= 5e-5, "whole genome: bin kernel within 5e-5 of native f64")
        check(same, "whole genome: bin_sites_analytic gives the kernel's sums")
        del stream_host, stream, native, e2e, hk, hp, ours

        # ---- 9. the main path of this slice: mode mut --binning device ----
        native_coal = read_coal_rates(os.path.join(tmp, "out_warm.coal"))
        runs9 = {}
        for phase in ("cold", "warm", "sharded"):
            out_prefix = os.path.join(tmp, f"bin_{phase}")
            binning = "sharded" if phase == "sharded" else "device"
            r = cli_run(argv + ["--binning", binning], out_prefix)
            wall, n_bin, n_em, events = r["wall"], r["bin"], r["em"], r["events"]
            check(events["mut_suffstats"]["binning"] == "cuda-kernel:float32",
                  f"{phase} run binned with the CUDA kernel "
                  f"({events['mut_suffstats']['binning']})")
            check(events["mut_em"]["provider"] == "cuda-kernel:float32", f"{phase} run's EM kernel")
            check(n_bin > 0 and n_em > 0, f"{phase} run launched both kernels ({n_bin}, {n_em})")
            coal = read_coal_rates(out_prefix + ".coal")
            check(coal.shape == (B_E2E, E) and bool(np.isfinite(coal).all()),
                  f"{phase} .coal shape {coal.shape}, finite")
            real = native_coal > 1e-4
            rel = float(np.max(np.abs(coal[real] - native_coal[real]) / native_coal[real]))
            check(rel <= 1e-3, f"{phase} .coal within 1e-3 of the natively binned run ({rel:.3e})")
            st = events["mut_done"]["timings"]
            runs9[phase] = dict(wall=wall, bin_launches=n_bin, em_launches=n_em, timings=st)
            print(f"mode mut --binning {binning} B={B_E2E} {phase}: wall {wall:.4f} s; parse "
                  f"{st['parse']:.4f} s, binning {st['binning']:.4f} s, bootstrap "
                  f"{st['bootstrap']:.4f} s, em {st['em']:.4f} s; {n_bin} bin and {n_em} EM kernel "
                  f"launches; .coal vs --binning auto (native) rel {rel:.3e} (<= 1e-3) [{smi}]",
                  flush=True)
        check(same_bytes(os.path.join(tmp, "bin_warm.coal"), os.path.join(tmp, "bin_sharded.coal")),
              "--binning sharded writes --binning device's .coal")
        stats = {}
        for binning in ("device", "sharded"):
            c = cli.mut_config(cli.build_parser().parse_args(
                argv + ["--binning", binning, "-o", os.path.join(tmp, "cfg")]))
            stats[binning] = suffstats(c, c.seed, device=dev)
        check(all(np.array_equal(a, b) for a, b in zip(stats["device"][:4], stats["sharded"][:4])),
              "--binning sharded bins bitwise as --binning device")
        print("--binning sharded: histograms and .coal bitwise equal to --binning device", flush=True)

        # ---- 14-17. --checkpoint, shards and ranks, parity on the card ----
        ckpt = checkpoint_phase(argv, tmp, smi)
        shards = shard_phase(sites, argv, tmp, dev, smi)
        del sites
        ranks_phase(argv, tmp, smi)
        parity_phase(tmp, smi)

        # ---- 18-20. mode mut on BCF and BAM inputs, parity on them ----
        base = ["--mode", "mut", "--bins", BINS, "--seed", "1", "--num_bootstraps", str(B_E2E),
                "--torch_device", "cuda"]
        legs = bcf_phase(fix, base + ["--mut", fix["mut_prefix"], "--chr", fix["chrfile"]], dev,
                         tmp, smi)
        legs.update(bam_phase(base, dev, tmp, smi))
        bcf_bam_parity_phase(tmp, smi)
        bcf_bam = {k: v for k, v in legs.items() if "em" in v}

        # ---- 10-13. the tree estimators ----
        programs, anc, mut, coords = tree_layers(dev, smi)
        trees = tree_cli_phases(tmp, anc, mut, coords, smi)["input"]
        del anc, mut, coords

        # ---- 21. the last host modes, as processes, without torch ----
        print(json.dumps({"host_modes": host_modes_phase(fix, trees, tmp, smi)}), flush=True)

        # ---- 22. the library surface: importers, .trees, E-steps ----
        print(json.dumps({"library_surface": library_phase(trees, tmp, dev, smi)}), flush=True)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "colate_tpu"))
    check(not loaded, f"the port ran without JAX and without colate_tpu (loaded: {loaded})")

    print(json.dumps({"device_programs": programs}))
    print(json.dumps({"kernels": [{
        "name": "em_run_f32",
        "route": "cuda",
        "source": "colate_tpu_torch/csrc/em_step.cu",
        "replaces": "colate_tpu/ops/em_pallas.py:142",
        "launches": runs["cold"]["launches"],
        "launches_per_run": runs["warm"]["launches"],
        "launches_by_path": {
            "checkpoint_default_chunk": ckpt["uninterrupted"]["em"],
            "checkpoint_chunk128": ckpt["chunk128_launches"],
            "devices1": shards["devices"][1]["em"],
            "dryrun_4_shards_one_card": shards["dryrun"]["em_launches"],
            **{f"mut_{k}": v["em"] for k, v in bcf_bam.items()},
        },
        "max_abs_err": max(max_abs, run_abs),
        "ms": em_ms,
        "plain_ms": plain_run_ms,
        "bound_ms": em_bound_ms,
        "bound_by": em_bound_by,
        "library_ms": None,
    }, {
        "name": "bin_hist_f32",
        "route": "cuda",
        "source": "colate_tpu_torch/csrc/bin_hist.cu",
        "replaces": "colate_tpu/ops/bin_pallas.py:89",
        "launches": runs9["cold"]["bin_launches"],
        "launches_per_run": runs9["warm"]["bin_launches"],
        "launches_by_path": {
            "devices1_sharded": shards["devices"][1]["bin"],
            "dryrun_4_shards_one_card": shards["dryrun"]["bin_launches"],
            **{f"mut_{k}": v["bin"] for k, v in bcf_bam.items()},
        },
        "max_abs_err": bin_abs,
        "ms": bin_ms,
        "plain_ms": bin_plain_ms,
        "bound_ms": bin_bound_ms,
        "bound_by": bin_bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
