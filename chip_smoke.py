#!/usr/bin/env python3
"""Smoke run of colate_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from colate_tpu_torch/csrc/ (one nvcc per
source, started together) and:

1-6. holds the EM kernel against its plain torch twin on the card, checks
     the EM against the host float64 EM, drives mode ``mut`` through the
     port's CLI at 1024 bootstrap replicates on a synthetic 4 x 300k-row
     fixture (the north-star fixture of bench.py), binning on the host,
     checks the ``.coal`` it writes, and times the EM;
7.   holds the binning kernel against its plain torch version and the host
     float64 binning on the card, and checks that a stream split at a
     block boundary bins bitwise identically;
8.   bins 22.2M sites in 125 blocks (the whole-genome site count, with
     bench.py's generator) and times the kernel, its plain version, the
     port's binning end to end and the host binning;
9.   drives mode ``mut --binning device`` (and once ``sharded``) through
     the CLI on the north-star fixture at 1024 replicates.

Prints the measured times, one JSON line about the kernels, and as its
last line ``{"ok": true, "device": {...}}``.  Any failed check raises; the
script exits non-zero without a result when torch sees no CUDA device.

    python3 chip_smoke.py --profile

adds a torch.profiler trace of the EM at 1024 replicates (device busy
time and idle share) and the times of one-shot CLI processes, the native
host EM against the kernel.
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


def time_processes(argv: list[str], tmp: str, smi: str) -> None:
    """Wall and em stage of one-shot ``python -m colate_tpu_torch``
    processes, the native host EM against the kernel."""
    env = dict(os.environ, COLATE_TPU_LOG="json")
    for B, em_dtype in ((1024, "auto"), (800, "auto"), (800, "float32"),
                        (128, "auto"), (128, "float32")):
        cmd = [sys.executable, "-m", "colate_tpu_torch", *argv, "--num_bootstraps", str(B),
               "--em_dtype", em_dtype, "-o", os.path.join(tmp, f"proc_{B}_{em_dtype}")]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"one-shot process B={B} exits 0: {p.stderr[-2000:]}")
        em = [json.loads(x) for x in p.stderr.splitlines() if x.startswith('{"event": "mut_em"')]
        check(len(em) == 1, f"one-shot process B={B} logged its EM")
        print(f"one-shot process B={B} --em_dtype {em_dtype}: wall {wall:.4f} s, em "
              f"{em[0]['sec']:.4f} s, provider {em[0]['provider']} [{smi}]", flush=True)


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
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from colate_tpu_torch import cli
    from colate_tpu_torch.models.mut_em import (
        bootstrap_counts, join_tmp_inputs, mut_epochs, suffstats,
    )
    from colate_tpu_torch.ops import bin_kernel, em_kernel
    from colate_tpu_torch.ops.em import run_em, run_em_native
    from colate_tpu_torch.pipeline.binning import bin_sites_analytic, bin_sites_analytic_native
    from helpers.sites import bench_sites, beyond_table_sites, hist_rel, synthetic_sites
    from helpers.synth import make_fixture

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(m.kernel_library) for m in (em_kernel, bin_kernel)]
        builds = [f.result() for f in builds]
    print(f"kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
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
        t_bins = em_kernel.bin_constants(epochs)["t"].astype(np.float64)
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
        print(f"suffstats in {time.perf_counter() - t0:.3f} s (native library build "
              f"included): {num_sites} sites in {nb} blocks", flush=True)
        sc, nc = bootstrap_counts(cfg, stats, cfg.seed)
        t0 = time.perf_counter()
        r_native, _, it_native = run_em_native(epochs, init, sc, nc)
        t_native = time.perf_counter() - t0
        print(f"host f64 EM at B={B_E2E}: {t_native:.3f} s, {int(it_native.max())} "
              f"iterations", flush=True)

        # ---- 4. EM to convergence against the host f64 EM ----
        for B in (128,):
            out = em_kernel.run_em_kernel(
                epochs, init, torch.as_tensor(sc[:B], device=dev),
                torch.as_tensor(nc[:B], device=dev),
            )
            strong, weak = tiers(out[0].cpu().numpy(), r_native[:B])
            print(f"run_em_kernel vs host f64 EM, B={B}: identified rel {strong:.3e} "
                  f"(<= 1e-4), weak rel {weak:.3e} (<= 2e-2)", flush=True)
            check(strong <= 1e-4 and weak <= 2e-2, f"f32 tiers at B={B}")
        out = run_em(epochs, init, sc[:8], nc[:8], dtype="float64", device=dev)
        r64 = out[0].cpu().numpy()
        rel64 = float(np.max(np.abs(r64 - r_native[:8]) / np.maximum(np.abs(r_native[:8]), 1e-300)))
        print(f"torch f64 EM on the card vs host f64 EM, B=8: rates rel {rel64:.3e} "
              f"(<= 1e-9), iterations equal {np.array_equal(out[2].cpu().numpy(), it_native[:8])}",
              flush=True)
        check(rel64 <= 1e-9, "torch f64 EM on the card within 1e-9 of the host EM")

        # ---- 5. the main path: mode mut through the CLI, B=1024 ----
        os.environ["COLATE_TPU_LOG"] = "json"
        runs = {}
        for phase in ("cold", "warm"):
            out_prefix = os.path.join(tmp, f"out_{phase}")
            log = io.StringIO()
            em_kernel.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(log):
                rc = cli.main(argv + ["-o", out_prefix])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = em_kernel.launches
            events = {}
            for line in log.getvalue().splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    events[rec["event"]] = rec
            check(rc == 0, f"{phase} CLI run exits 0 (got {rc})")
            check(events["mut_em"]["provider"] == "cuda-kernel:float32",
                  f"{phase} run took the CUDA kernel (provider {events['mut_em']['provider']})")
            check(n_launch > 0, f"{phase} run launched the kernel")
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
        del os.environ["COLATE_TPU_LOG"]

        # ---- 6. times ----
        times = {}
        for B in (8, 128, 1024):
            r0 = rates0(B)
            s = torch.as_tensor(sc[:B], dtype=torch.float32, device=dev)
            n = torch.as_tensor(nc[:B], dtype=torch.float32, device=dev)
            ms_k = cuda_ms(lambda: em_kernel.em_chunk(epochs, r0, s, n, K), 50)
            ms_t = cuda_ms(lambda: em_kernel.em_chunk_reference(epochs, r0, s, n, K), 10)
            t0 = time.perf_counter()
            rn = run_em_native(epochs, init, sc[:B], nc[:B])
            s_native = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rk = em_kernel.run_em_kernel(epochs, init, s, n)
            torch.cuda.synchronize()
            s_kernel = time.perf_counter() - t0
            times[B] = dict(kernel_ms=ms_k, twin_ms=ms_t, native_s=s_native, run_kernel_s=s_kernel,
                            native_iters=int(rn[2].max()), kernel_iters=int(rk[2].max()))
            print(f"B={B}: per {K}-iteration chunk kernel {ms_k:.4f} ms, twin {ms_t:.4f} ms; "
                  f"EM to convergence host native {s_native:.4f} s ({int(rn[2].max())} it), "
                  f"run_em_kernel {s_kernel:.4f} s ({int(rk[2].max())} it) [{smi}]", flush=True)

        if opts.profile:
            profile_em(lambda: em_kernel.run_em_kernel(epochs, init, s, n), smi)
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
            "north-star fixture (the main path's sites)": (join_tmp_inputs(cfg), 0.0),
        }
        for name, (sites, age) in cases.items():
            packed = bin_kernel.pack_sites(sites, age).to(dev)
            hk = bin_kernel.bin_chunks(packed)
            torch.cuda.synchronize()
            hp = bin_kernel.bin_chunks_reference(packed)
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
            print(f"bin kernel, {name} ({len(sites)} sites, {nb} blocks, {packed.n_chunks} "
                  f"chunks): vs plain {rel_plain:.3e} (<= 2e-5), vs native f64 "
                  f"{rel_native:.3e} (<= 5e-5)", flush=True)
            check(rel_plain <= 2e-5, f"{name}: bin kernel within 2e-5 of its plain version")
            check(rel_native <= 5e-5, f"{name}: bin kernel within 5e-5 of native f64")
            check(same, f"{name}: bin_sites_analytic on the card gives the kernel's sums")
        sites = cases["bench generator 1M sites, 125 blocks"][0]
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
        del cases, sites, whole, halves

        # ---- 8. the whole-genome site count: 22.2M sites in 125 blocks ----
        t0 = time.perf_counter()
        sites = bench_sites(N_WHOLE_GENOME)
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        packed_host = bin_kernel.pack_sites(sites)
        t_pack = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = packed_host.to(dev)
        torch.cuda.synchronize()
        t_h2d = time.perf_counter() - t0
        bin_ms = cuda_ms(lambda: bin_kernel.bin_chunks(packed), 5)
        bin_plain_ms = cuda_ms(lambda: bin_kernel.bin_chunks_reference(packed), 1)
        hk = bin_kernel.bin_chunks(packed).cpu().numpy()
        hp = bin_kernel.bin_chunks_reference(packed).cpu().numpy()
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
        print(f"whole genome: {n_wg} sites, {sites.num_blocks} blocks, {packed.n_chunks} chunks "
              f"(generated in {t_gen:.3f} s) [{smi}]", flush=True)
        print(f"  kernel, stream resident on the card: {bin_ms:.4f} ms ({rate(bin_ms / 1e3):.1f}M sites/s)")
        print(f"  plain torch version on the card:     {bin_plain_ms:.4f} ms "
              f"({rate(bin_plain_ms / 1e3):.1f}M sites/s)")
        print(f"  host packing {t_pack:.4f} s ({rate(t_pack):.1f}M sites/s), host-to-device copy "
              f"{t_h2d:.4f} s of {packed.fv.nbytes + packed.meta.nbytes} bytes")
        print(f"  bin_sites_analytic end to end (pack + copy + kernel + copy back): "
              f"{', '.join(f'{t:.4f}' for t in t_e2e)} s ({rate(min(t_e2e)):.1f}M sites/s)")
        print(f"  native cn_bin_analytic on the host: {', '.join(f'{t:.4f}' for t in t_native)} s "
              f"({rate(min(t_native)):.1f}M sites/s)")
        print(f"  kernel vs plain {rel_plain:.3e} (<= 2e-5), vs native f64 {rel_native:.3e} "
              f"(<= 5e-5), max abs vs plain {bin_abs:.3e}", flush=True)
        check(rel_plain <= 2e-5, "whole genome: bin kernel within 2e-5 of its plain version")
        check(rel_native <= 5e-5, "whole genome: bin kernel within 5e-5 of native f64")
        check(same, "whole genome: bin_sites_analytic gives the kernel's sums")
        del sites, packed_host, packed, native, e2e, hk, hp, ours

        # ---- 9. the main path of this slice: mode mut --binning device ----
        native_coal = read_coal_rates(os.path.join(tmp, "out_warm.coal"))
        os.environ["COLATE_TPU_LOG"] = "json"
        runs9 = {}
        for phase in ("cold", "warm", "sharded"):
            out_prefix = os.path.join(tmp, f"bin_{phase}")
            binning = "sharded" if phase == "sharded" else "device"
            log = io.StringIO()
            em_kernel.launches = 0
            bin_kernel.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(log):
                rc = cli.main(argv + ["--binning", binning, "-o", out_prefix])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_bin, n_em = bin_kernel.launches, em_kernel.launches
            events = {}
            for line in log.getvalue().splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    events[rec["event"]] = rec
            check(rc == 0, f"--binning {binning} {phase} CLI run exits 0 (got {rc})")
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
        del os.environ["COLATE_TPU_LOG"]
        check(filecmp.cmp(os.path.join(tmp, "bin_warm.coal"), os.path.join(tmp, "bin_sharded.coal"),
                          shallow=False), "--binning sharded writes --binning device's .coal")
        stats = {}
        for binning in ("device", "sharded"):
            c = cli.mut_config(cli.build_parser().parse_args(
                argv + ["--binning", binning, "-o", os.path.join(tmp, "cfg")]))
            stats[binning] = suffstats(c, c.seed, device=dev)
        check(all(np.array_equal(a, b) for a, b in zip(stats["device"][:4], stats["sharded"][:4])),
              "--binning sharded bins bitwise as --binning device")
        print("--binning sharded: histograms and .coal bitwise equal to --binning device", flush=True)

    check("jax" not in sys.modules, "the port ran without loading JAX")

    print(json.dumps({"kernels": [{
        "name": "em_step_f32",
        "route": "cuda",
        "source": "colate_tpu_torch/csrc/em_step.cu",
        "replaces": "colate_tpu/ops/em_pallas.py:142",
        "launches": runs["cold"]["launches"],
        "max_abs_err": max_abs,
        "ms": times[1024]["kernel_ms"],
        "plain_ms": times[1024]["twin_ms"],
    }, {
        "name": "bin_hist_f32",
        "route": "cuda",
        "source": "colate_tpu_torch/csrc/bin_hist.cu",
        "replaces": "colate_tpu/ops/bin_pallas.py:89",
        "launches": runs9["cold"]["bin_launches"],
        "max_abs_err": bin_abs,
        "ms": bin_ms,
        "plain_ms": bin_plain_ms,
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
