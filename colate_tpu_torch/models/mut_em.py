"""Mode ``mut`` on PyTorch: parse on the host, bin on the host or the
device, EM on the device.

Port of colate_tpu/models/mut_em.py (run_mut, finish_from_suffstats,
run_mut_and_write) without its mesh and checkpoint branches.  The host
stages are colate_tpu's own and are imported, not copied: the parsers and
the native C++ join+binning (``compute_suffstats``), the numpy bootstrap,
the epoch grid and the ``.coal`` writer.  The binning is one of:

- ``native``: the host C++ inside ``compute_suffstats`` (``--binning
  auto|native``);
- ``mc_parity(host)``: the reference's draw replay (``--sampling
  mc_parity``, whatever ``--binning`` says);
- ``cuda-kernel:float32``: ``.colate.in`` inputs under ``--binning
  device|sharded`` on a card, the CUDA kernel of ops/bin_kernel.py;
- ``torch-twin:float32(cpu)``: the same on the CPU, its plain torch version.

The EM is this package's:

- ``native``: the host C++ f64 EM, for B <= EM_HOST_MAX_B under ``auto``;
- ``cuda-kernel:float32``: the fused CUDA step (ops/em_kernel.py);
- ``torch-twin:float32(cpu)``: its plain torch twin on the CPU;
- ``torch:float64(<device>)``: the torch EM (ops/em.py) in f64.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from colate_tpu.config import COLATE_MAT_NORM, EM_HOST_MAX_B, INITIAL_COAL_RATE, MutRunConfig, age_bin_centers
from colate_tpu.formats.coal import write_mut_coal
from colate_tpu.formats.colate_in import read_colate_in
from colate_tpu.formats.colate_mat import read_colate_mat, write_colate_mat
from colate_tpu.formats.fasta import read_mask
from colate_tpu.formats.mut import MutTable
from colate_tpu.hostrng import MT19937
from colate_tpu.models.mut_em import MutResult, compute_suffstats, resolve_tmp_inputs
from colate_tpu.ops.bootstrap import bootstrap_weights, redistribute_emp, weighted_counts
from colate_tpu.ops.epochs import epochs_from_bins, epochs_from_coal_file
from colate_tpu.pipeline.join import join_tmptmp
from colate_tpu.utils.progress import log_event
from colate_tpu_torch.ops.em import run_em, run_em_native
from colate_tpu_torch.ops.em_kernel import run_em_kernel
from colate_tpu_torch.pipeline.binning import bin_sites_analytic

# EM_HOST_MAX_B (B <= 800 runs the host EM under --em_dtype auto) is the
# JAX package's threshold, kept so that both packages dispatch alike.  It
# was measured on a TPU; it is to be re-decided from H100 measurements.


def _ages(cfg: MutRunConfig):
    """(age, ref_age) in generations, parsed as float32 like the reference."""
    target_age = float(np.float32(cfg.target_age))
    ref_age_y = float(np.float32(cfg.reference_age))
    ypg = float(np.float32(cfg.years_per_gen))
    return max(target_age, ref_age_y) / ypg, ref_age_y / ypg


def run_mut(cfg: MutRunConfig, device: str | torch.device = "cuda") -> MutResult:
    """Mode mut end to end; the EM runs on ``device``."""
    device = torch.device(device)
    timings: dict = {}
    seed = cfg.seed if cfg.seed is not None else (int(time.time()) + os.getpid())
    rng = MT19937(seed) if cfg.sampling == "mc_parity" else None

    mat_path = cfg.output + ".colate_mat"
    if os.path.exists(mat_path):
        _, shared_counts, notshared_counts = read_colate_mat(mat_path, cfg.num_bootstrap)
        timings["parse"] = 0.0
        return finish_from_suffstats(
            cfg, None, timings, device, rng=rng, seed=seed,
            counts=(shared_counts, notshared_counts),
        )
    stats = suffstats(cfg, seed, rng=rng, timings=timings, device=device)
    return finish_from_suffstats(cfg, stats, timings, device, rng=rng, seed=seed)


def bins_on_device(cfg: MutRunConfig) -> bool:
    """Whether cfg's sites are binned by the port on the torch device:
    ``--binning device|sharded`` outside ``--sampling mc_parity``, which
    bins by its draw replay on the host whatever ``--binning`` says."""
    return cfg.binning in ("device", "sharded") and cfg.sampling != "mc_parity"


def binning_route(cfg: MutRunConfig, device: torch.device) -> str:
    """Which binning a run of cfg on ``device`` takes (see the module doc)."""
    if cfg.sampling == "mc_parity":
        return "mc_parity(host)"
    if bins_on_device(cfg):
        return "cuda-kernel:float32" if device.type == "cuda" else f"torch-twin:float32({device.type})"
    return "native"


def suffstats(cfg: MutRunConfig, seed: int, rng=None, timings: dict | None = None,
              device: str | torch.device = "cuda"):
    """Per-block sufficient statistics of cfg's inputs: the tuple (sh_b,
    ns_b, se_b, ne_b, num_sites, num_blocks) of colate_tpu's
    ``compute_suffstats``.  Under :func:`bins_on_device` the port decodes,
    joins and bins ``.colate.in`` inputs itself, binning on ``device``;
    otherwise the native host library parses, joins and bins."""
    from colate_tpu import native

    timings = {} if timings is None else timings
    if bins_on_device(cfg):
        if cfg.target_bcf or cfg.target_bam or not (cfg.target_tmp and cfg.reference_tmp):
            raise ValueError(
                f"--binning {cfg.binning} is ported for .colate.in inputs "
                "(--target_tmp/--reference_tmp) only; BCF/BAM inputs are "
                "ROADMAP queue 1, item 4 (device binning of BCF/BAM inputs)"
            )
        t0 = time.time()
        sites = join_tmp_inputs(cfg)
        timings["parse"] = time.time() - t0
        t0 = time.time()
        # every parser forces age=0 (e.g. coal.cpp:597-598, 2073-2074)
        sh_b, ns_b, se_b, ne_b = bin_sites_analytic(sites, 0.0, device)
        timings["binning"] = time.time() - t0
        return sh_b, ns_b, se_b, ne_b, len(sites), sites.num_blocks
    # without the native library compute_suffstats would bin through the
    # JAX program (colate_tpu/pipeline/binning.py:bin_sites_analytic)
    if native.load() is None:
        so = os.environ.get("COLATE_NATIVE_SO", native._SO)
        raise RuntimeError(
            f"native library failed to build or load: {so}; mode mut with "
            f"--binning {cfg.binning} needs it (--binning device does not)"
        )
    age, ref_age = _ages(cfg)
    chroms, mut_files, tmask_files, rmask_files = resolve_tmp_inputs(cfg)
    return compute_suffstats(
        cfg, chroms, mut_files, tmask_files, rmask_files, age, ref_age,
        cfg.sampling == "mc_parity", rng, seed, timings,
    )


def join_tmp_inputs(cfg: MutRunConfig):
    """The accepted sites (a colate_tpu ``JoinedSites``) of cfg's
    ``.colate.in`` inputs: the reference's staged decode and join
    (colate_tpu/models/mut_em.py:205-248, without the native prefilter),
    all of it colate_tpu's host code."""
    from concurrent.futures import ThreadPoolExecutor

    age, ref_age = _ages(cfg)
    chroms, mut_files, tmask_files, rmask_files = resolve_tmp_inputs(cfg)
    tmasks = [read_mask(f) for f in tmask_files] if tmask_files else None
    rmasks = [read_mask(f) for f in rmask_files] if rmask_files else None
    with ThreadPoolExecutor(max_workers=2) as ex:
        fut_t = ex.submit(read_colate_in, cfg.target_tmp)
        fut_r = ex.submit(read_colate_in, cfg.reference_tmp)
        target, reference = fut_t.result(), fut_r.result()
    mut_tables = [MutTable.read(f) for f in mut_files]
    return join_tmptmp(chroms, mut_tables, target, reference, tmasks, rmasks, age, ref_age)


def bootstrap_counts(cfg: MutRunConfig, stats, seed: int, rng=None):
    """The shared and notshared count matrices [B, 185] of
    cfg.num_bootstrap block-bootstrap replicates of :func:`suffstats`."""
    sh_b, ns_b, se_b, ne_b, _, num_blocks = stats
    weights = bootstrap_weights(cfg.num_bootstrap, num_blocks, rng=rng, seed=seed)
    shared_counts, notshared_counts, se, ne = weighted_counts(weights, sh_b, ns_b, se_b, ne_b)
    return redistribute_emp(shared_counts, se, ne, age=_ages(cfg)[0]), notshared_counts


def mut_epochs(cfg: MutRunConfig):
    """(epochs [E], initial rates [E], ep_null) from --coal or --bins."""
    age, _ = _ages(cfg)
    if cfg.coal:
        return epochs_from_coal_file(cfg.coal, age)
    if not cfg.bins:
        raise ValueError("either --bins or --coal is required")
    epochs, ep_null = epochs_from_bins(cfg.bins, float(np.float32(cfg.years_per_gen)), age)
    return epochs, np.full(epochs.shape, INITIAL_COAL_RATE), ep_null


def finish_from_suffstats(
    cfg: MutRunConfig,
    stats,
    timings: dict,
    device: torch.device,
    rng=None,
    seed: int | None = None,
    counts=None,
) -> MutResult:
    """Bootstrap + EM from the per-block sufficient statistics of
    :func:`suffstats`, or from the count matrices of a ``.colate_mat``
    cache (``counts``, with ``stats`` None)."""
    age, _ = _ages(cfg)
    parity = cfg.sampling == "mc_parity"
    B = cfg.num_bootstrap
    num_sites, num_blocks = (0, 0) if stats is None else stats[4:6]
    if seed is None:
        seed = cfg.seed if cfg.seed is not None else (int(time.time()) + os.getpid())

    if counts is not None:
        shared_counts, notshared_counts = counts
    else:
        t0 = time.time()
        shared_counts, notshared_counts = bootstrap_counts(cfg, stats, seed, rng=rng)
        if cfg.target_tmp is None or cfg.reference_tmp is None:
            shared_counts = shared_counts / COLATE_MAT_NORM
            notshared_counts = notshared_counts / COLATE_MAT_NORM
            write_colate_mat(
                cfg.output + ".colate_mat", age_bin_centers(),
                shared_counts, notshared_counts,
            )
        timings["bootstrap"] = time.time() - t0

    epochs, init_rates, ep_null = mut_epochs(cfg)

    log_event(
        "mut_suffstats",
        sites=num_sites,
        blocks=num_blocks,
        bootstraps=B,
        binning="colate_mat" if stats is None else binning_route(cfg, device),
        sec_parse=timings.get("parse", 0.0),
        sec_binning=timings.get("binning", 0.0),
        sec_bootstrap=timings.get("bootstrap", 0.0),
    )
    t0 = time.time()
    em_dtype = cfg.em_dtype
    if em_dtype == "auto" and B <= EM_HOST_MAX_B and not parity:
        # the host EM; parity runs keep the torch f64 EM below, like the
        # reference keeps its JAX f64 EM for byte-identity runs
        rates, logl, iters = run_em_native(epochs, init_rates, shared_counts, notshared_counts)
        provider = "native"
    else:
        if em_dtype == "auto":
            em_dtype = "float64" if (parity or device.type == "cpu") else "float32"
        if em_dtype == "float32":
            sc = torch.as_tensor(np.asarray(shared_counts, np.float32), device=device)
            nc = torch.as_tensor(np.asarray(notshared_counts, np.float32), device=device)
            out = run_em_kernel(epochs, init_rates, sc, nc)
            provider = "cuda-kernel:float32" if device.type == "cuda" else "torch-twin:float32(cpu)"
        else:
            out = run_em(
                epochs, init_rates, np.asarray(shared_counts, np.float64),
                np.asarray(notshared_counts, np.float64), dtype="float64", device=device,
            )
            provider = f"torch:float64({device.type})"
        rates, logl, iters = (x.cpu().numpy() for x in out)
    timings["em"] = time.time() - t0
    log_event("mut_em", provider=provider, iters=int(np.max(iters)), sec=timings["em"])
    return MutResult(
        epochs=epochs,
        rates=rates,
        logl=logl,
        iterations=iters,
        num_sites=num_sites,
        num_blocks=num_blocks,
        is_ancient=age > 0.0,
        ep_null=ep_null,
        timings=timings,
        em_provider=provider,
    )


def run_mut_and_write(cfg: MutRunConfig, device: str | torch.device = "cuda") -> MutResult:
    """Mode mut, then ``<output>.coal``."""
    res = run_mut(cfg, device)
    write_mut_coal(
        cfg.output + ".coal", res.epochs, res.rates,
        is_ancient=res.is_ancient, ep_null=res.ep_null,
    )
    log_event(
        "mut_done",
        sites=res.num_sites,
        blocks=res.num_blocks,
        provider=res.em_provider,
        iters=res.iterations.tolist(),
        timings=res.timings,
    )
    return res
