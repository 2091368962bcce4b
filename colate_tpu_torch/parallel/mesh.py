"""Mode ``mut`` over several torch devices.

Port of colate_tpu/parallel/mesh.py.  A mesh here is an explicit list of
``torch.device``s: there is no SPMD program and no collective.  Each
device works on its shard, and the results come back to the host and are
put together there:

- **binning**: the sites are cut at block boundaries
  (:func:`_block_aligned_site_bounds`) and each shard is binned on its
  device by pipeline/binning.py (the CUDA kernel on a card, its plain
  version on the CPU).  Every block lies wholly in one shard, so the host
  sum of the per-shard [num_blocks, 185] float64 histograms adds exact
  zeros: bitwise what one shard gives.
- **EM**: the bootstrap replicates are cut into contiguous shards, each
  run on its device by the CUDA EM kernel (bitwise independent of the
  batch) or by the replicate-sequential torch f64 EM, and concatenated.

Every device's work is queued before any result is copied back, so N
cards work at once.  (The f64 EM waits on its device at every iteration,
so its shards run one after another.)
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from colate_tpu_torch._torch import torch
from colate_tpu_torch.config import EM_MAX_ITER, EM_MIN_ITER, NUM_AGE_BINS
from colate_tpu_torch.pipeline.join import JoinedSites


def make_mesh(n_devices: int, device_type: str = "cuda") -> list[torch.device]:
    """The first ``n_devices`` cards, ``[cuda:0, ..., cuda:n-1]``; raises
    when torch sees fewer.  ``device_type="cpu"`` gives n shards on the
    CPU."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, not {n_devices}")
    if device_type == "cpu":
        return [torch.device("cpu")] * n_devices
    if device_type != "cuda":
        raise ValueError(f"no mesh of {device_type} devices")
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"a mesh of {n_devices} cards, but torch sees {have} CUDA device(s)")
    return [torch.device("cuda", i) for i in range(n_devices)]


def _balanced_cuts(allowed: np.ndarray, total: int, nd: int) -> np.ndarray:
    """[nd+1] nondecreasing boundaries drawn from the `allowed` cut
    points (which must start at 0 and end at `total`), each nearest to
    its even-split target."""
    bounds = np.zeros(nd + 1, np.int64)
    bounds[nd] = total
    for d in range(1, nd):
        target = (total * d) // nd
        i = int(np.searchsorted(allowed, target, "left"))
        if i >= allowed.size:
            i = allowed.size - 1
        elif i > 0 and target - allowed[i - 1] <= allowed[i] - target:
            i -= 1
        bounds[d] = allowed[i]
    return np.maximum.accumulate(bounds)


def _block_aligned_site_bounds(blk: np.ndarray, nd: int) -> np.ndarray:
    """[nd+1] site-index device boundaries that only cut at block-id
    changes, balancing site counts.  With nondecreasing ids this puts
    every block wholly on one device, so the per-device histogram
    partials are disjoint and the psum merge is exact (+0 elsewhere) —
    the same argument the multihost chromosome partition makes
    (parallel/multihost.py)."""
    n = blk.size
    if n == 0:
        return np.zeros(nd + 1, np.int64)
    cut = np.flatnonzero(np.diff(blk)) + 1
    allowed = np.concatenate([[0], cut, [n]]).astype(np.int64)
    return _balanced_cuts(allowed, n, nd)


def _site_slice(sites: JoinedSites, lo: int, hi: int) -> JoinedSites:
    return JoinedSites(
        age_begin=sites.age_begin[lo:hi], age_end=sites.age_end[lo:hi],
        w_shared=sites.w_shared[lo:hi], w_notshared=sites.w_notshared[lo:hi],
        block_id=sites.block_id[lo:hi], num_blocks=sites.num_blocks,
    )


def sharded_bin_sites(devices, sites: JoinedSites, age: float = 0.0):
    """Analytic binning of ``sites`` over ``devices``: the four
    [num_blocks, 185] float64 histograms (shared, notshared, shared_emp,
    notshared_emp), bitwise equal for any number of devices when the
    block ids are nondecreasing (see the module doc)."""
    from colate_tpu_torch.pipeline.binning import bin_sites_device

    bounds = _block_aligned_site_bounds(np.asarray(sites.block_id, np.int64), len(devices))
    queued = [
        bin_sites_device(_site_slice(sites, int(lo), int(hi)), age, dev)
        for dev, lo, hi in zip(devices, bounds[:-1], bounds[1:]) if hi > lo
    ]
    if not queued:
        z = np.zeros((sites.num_blocks, NUM_AGE_BINS), np.float64)
        return z, z.copy(), z.copy(), z.copy()
    total = queued[0].cpu().numpy()
    for h in queued[1:]:
        total += h.cpu().numpy()
    return tuple(np.ascontiguousarray(total[:, j]) for j in range(4))


def sharded_run_em(devices, epochs, init_rates, shared_counts, notshared_counts,
                   backend: str = "kernel", max_iter: int = EM_MAX_ITER,
                   min_iter: int = EM_MIN_ITER):
    """Bootstrap-parallel EM: the replicates of the [B, 185] count matrices
    in contiguous shards over ``devices``.  ``backend`` "kernel" runs
    ops/em_kernel.py:run_em_kernel (float32; the CUDA kernel on a card, its
    plain version on the CPU), "float64" ops/em.py:run_em_sequential.
    Either gives bitwise the same result for any number of devices.
    Returns numpy (rates [B,E] f64, logl [B] f64, iters [B] i32)."""
    from colate_tpu_torch.ops.em import run_em_sequential
    from colate_tpu_torch.ops.em_kernel import run_em_kernel

    if backend not in ("kernel", "float64"):
        raise ValueError(f"sharded_run_em: no backend {backend!r}")
    sc = torch.as_tensor(np.asarray(shared_counts, np.float64))
    nc = torch.as_tensor(np.asarray(notshared_counts, np.float64))
    shards = [(dev, s, n) for dev, s, n in zip(devices, sc.tensor_split(len(devices)),
                                               nc.tensor_split(len(devices))) if s.shape[0]]
    queued = []
    for dev, s, n in shards or [(devices[0], sc, nc)]:
        if backend == "kernel":
            f32 = dict(device=dev, dtype=torch.float32)
            queued.append(run_em_kernel(epochs, init_rates, s.to(**f32), n.to(**f32),
                                        max_iter=max_iter, min_iter=min_iter))
        else:
            queued.append(run_em_sequential(epochs, init_rates, s, n, max_iter=max_iter,
                                            min_iter=min_iter, dtype="float64", device=dev))
    return tuple(torch.cat([out[i].cpu() for out in queued]).numpy() for i in range(3))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, devices=None, sites: JoinedSites | None = None,
                     B: int = 8) -> dict:
    """The sharded path on ``n_devices`` devices against one
    (__graft_entry__.py:dryrun_multichip): the binning of ``sites`` (by
    default 20,000 synthetic sites in 12 blocks) and the EM of B bootstrap
    replicates of its histograms must be bitwise equal to one device's,
    and a mode ``mut`` run on a written fixture must write the same
    ``.coal`` bytes sharded as through the CLI's single-device mesh path.
    ``devices`` (default :func:`make_mesh`) may repeat a device: n shards
    on one card.  The EM is the CUDA kernel on cards and the f64 EM on the
    CPU.  Raises on any difference; returns what it ran and the host-clock
    seconds of each binning and EM (``bin_sharded``, ``bin_one``,
    ``em_sharded``, ``em_one``)."""
    from colate_tpu_torch.fixtures import synthetic_sites
    from colate_tpu_torch.ops.bootstrap import bootstrap_weights, redistribute_emp, weighted_counts
    from colate_tpu_torch.ops.epochs import epochs_from_bins

    devices = make_mesh(n_devices) if devices is None else list(devices)
    _require(len(devices) == n_devices, f"{n_devices} devices asked, {len(devices)} given")
    on = ", ".join(sorted({str(d) for d in devices}))
    backend = "kernel" if devices[0].type == "cuda" else "float64"
    if sites is None:
        sites = synthetic_sites(n=20_000, nb=12, seed=1)
    nb = sites.num_blocks
    info = dict(devices=[str(d) for d in devices], backend=backend, sites=len(sites), blocks=nb,
                B=B)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        info[name] = time.perf_counter() - t0
        return out

    hists = timed("bin_sharded", lambda: sharded_bin_sites(devices, sites))
    single = timed("bin_one", lambda: sharded_bin_sites(devices[:1], sites))
    _require(all(np.array_equal(a, b) for a, b in zip(hists, single)),
             "the sharded binning deviates from one device's")

    w = bootstrap_weights(B, nb, seed=0)
    sc, nc, se, ne = weighted_counts(w, *hists)
    sc = redistribute_emp(sc, se, ne)
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, 1 / 20000.0)
    rates, logl, iters = timed("em_sharded", lambda: sharded_run_em(
        devices, epochs, init, sc, nc, backend))
    r1, l1, i1 = timed("em_one", lambda: sharded_run_em(devices[:1], epochs, init, sc, nc, backend))
    _require(rates.shape == (B, epochs.shape[0]) and np.isfinite(rates).all(), "EM rates")
    _require(int(iters.min()) > 1000, f"the EM did not converge: iters={iters}")
    _require(np.array_equal(iters, i1) and np.array_equal(rates, r1) and np.array_equal(logl, l1),
             "the sharded EM deviates from one device's")
    print(f"dryrun_multichip({n_devices}) on {on}: {len(sites)} sites in {nb} blocks binned and "
          f"B={B} EM ({backend}, iters {int(iters.min())}-{int(iters.max())}, E={epochs.shape[0]}) "
          f"bitwise identical to one device", flush=True)
    info.update(iters_max=int(iters.max()), e2e_sites=_dryrun_mut_e2e(devices, backend, B))
    return info


def _dryrun_mut_e2e(devices, backend: str, B: int) -> int:
    """Mode ``mut`` on a written fixture: the CLI's path with
    ``--binning sharded --devices 1`` on the first device against the
    sites joined on the host, binned and run sharded over ``devices``,
    and written; the two ``.coal`` must be byte-identical.  Returns the
    fixture's site count."""
    from colate_tpu_torch.config import MutRunConfig
    from colate_tpu_torch.fixtures import make_fixture
    from colate_tpu_torch.formats.coal import write_mut_coal
    from colate_tpu_torch.models.mut_em import (
        bootstrap_counts, join_inputs, mut_epochs, run_mut_and_write,
    )

    with tempfile.TemporaryDirectory(prefix="colate_dryrun_") as tmp:
        fix = make_fixture(tmp, chroms=("1", "2"), n_per_chrom=1500, seed=13)
        cfg = MutRunConfig(
            mut=fix["mut_prefix"], output=os.path.join(tmp, "single"), chr_list=["1", "2"],
            target_tmp=fix["target"], reference_tmp=fix["reference"], bins="3,7,0.25", seed=11,
            num_bootstrap=B, sampling="analytic",
            em_dtype="auto" if backend == "kernel" else "float64", binning="sharded", devices=1,
        )
        res = run_mut_and_write(cfg, devices[0])
        want = f"mesh[1]:{'cuda-kernel:float32' if backend == 'kernel' else 'torch:float64(cpu)'}"
        _require(res.em_provider == want, f"the single leg's EM is {res.em_provider}, not {want}")

        sites = join_inputs(cfg)
        stats = (*sharded_bin_sites(devices, sites), len(sites), sites.num_blocks)
        sc, nc = bootstrap_counts(cfg, stats, cfg.seed)
        epochs, init, ep_null = mut_epochs(cfg)
        rates, _, _ = sharded_run_em(devices, epochs, init, sc, nc, backend)
        meshed = os.path.join(tmp, "mesh.coal")
        write_mut_coal(meshed, epochs, rates, is_ancient=False, ep_null=ep_null)
        with open(cfg.output + ".coal", "rb") as a, open(meshed, "rb") as b:
            _require(a.read() == b.read(), "the sharded mode mut .coal differs from the single run's")
    print(f"dryrun_multichip({len(devices)}): mode mut on the mesh, {len(sites)} sites in "
          f"{sites.num_blocks} blocks, .coal byte-identical to the single-device run", flush=True)
    return len(sites)
