"""Mode ``mut`` as one process per rank (torch.distributed).

Port of colate_tpu/parallel/multihost.py:

- every process calls :func:`init_distributed` (rendezvous address, world
  size and rank from the arguments, or ``env://``'s MASTER_ADDR,
  MASTER_PORT, WORLD_SIZE and RANK), then :func:`run_mut_multihost`;
- the chromosomes are partitioned contiguously over the ranks, and each
  rank decodes and bins only its own, on its own device;
- each rank's [local_blocks, 185] histograms are placed at their global
  block offsets in zeros and summed over the ranks with one
  ``all_reduce``.  Each chromosome starts a fresh 30 Mb block
  (coal.cpp:2113-2120), so the ranks' block ranges are disjoint and every
  cell is 0 + ... + x + ... + 0: the merged histograms are bitwise the
  single-process ones, and the seeded bootstrap and the EM that follow on
  every rank write the single-process ``.coal`` byte for byte.  Rank 0
  writes it, and for BCF and BAM inputs the ``.colate_mat``.

The merge runs over **gloo** on every machine: the merged tensors are
host histograms of a few hundred kB (4 x [125, 185] float64 at whole-genome
size) that are on the host anyway, and NCCL cannot put two ranks on one
card.  The kernels still run on each rank's card.  The process group gets
an explicit timeout, so a rank that dies fails the others instead of
hanging them.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch.distributed as dist

from colate_tpu_torch._torch import torch
from colate_tpu_torch.config import NUM_AGE_BINS, MutRunConfig

TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> None:
    """Join the gloo process group (idempotent): ``tcp://<coordinator>``
    when given, else ``env://`` (MASTER_ADDR/MASTER_PORT); the world size
    and rank default to WORLD_SIZE and RANK."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"]),
        rank=int(process_id if process_id is not None else os.environ["RANK"]),
        timeout=timeout,
    )


def partition_chromosomes(chroms: list, num_processes: int, process_id: int):
    """Contiguous partition: preserves global block order under
    concatenation of the per-process block ranges."""
    n = len(chroms)
    lo = n * process_id // num_processes
    hi = n * (process_id + 1) // num_processes
    return lo, hi


def psum_histograms(local_hists, local_offset: int, total_blocks: int):
    """Merge each rank's [local_blocks, nbins] histograms into global
    [total_blocks, nbins] arrays: placed at ``local_offset`` in zeros and
    summed over the ranks with one ``all_reduce``.  The block ranges are
    disjoint, so the sum is exact."""
    nbins = local_hists[0].shape[1]
    g = torch.zeros((len(local_hists), total_blocks, nbins), dtype=torch.float64)
    for i, h in enumerate(local_hists):
        g[i, local_offset : local_offset + h.shape[0]] = torch.from_numpy(np.asarray(h, np.float64))
    dist.all_reduce(g, op=dist.ReduceOp.SUM)
    return tuple(g.numpy())


def allgather_scalars(*vals: int) -> np.ndarray:
    """[num_processes, len(vals)] int64 table of per-process scalars."""
    mine = torch.tensor(vals, dtype=torch.int64)
    table = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(table, mine)
    return torch.stack(table).numpy()


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK or rank>`` modulo the cards
    (two ranks on one card share it), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def run_mut_multihost(cfg: MutRunConfig, device: str | torch.device = "cuda"):
    """Mode mut with the chromosomes' decode and binning split over the
    ranks of an initialised process group; the binning and the EM run on
    :func:`rank_device`.  Needs analytic sampling (mc_parity replays one
    RNG stream through the whole parse).  Every rank returns the same
    MutResult; rank 0 writes ``<out>.coal``."""

    from colate_tpu_torch.formats.coal import write_mut_coal
    from colate_tpu_torch.models import mut_em
    from colate_tpu_torch.utils.progress import StageTimer, log_event

    if cfg.sampling == "mc_parity":
        raise ValueError("multihost runs require analytic sampling")
    if cfg.target_bcf and not cfg.reference_bcf:
        # The half-split parser (parse_vcf, coal.cpp:594-904) consumes ONE
        # continuous MT19937(seed) stream across all chromosomes for its
        # haplotype split; per-process replay over a chromosome subset
        # would realise a different split than the single-process run, so
        # the merged suffstats would not match.  Only RNG-free parsers
        # (tmp/bam/vcfvcf) are supported multi-host.
        raise ValueError(
            "multihost mode mut does not support the single-BCF half-split "
            "parser (its haplotype split draws from one sequential RNG "
            "stream across chromosomes); run it single-process or use "
            "make_tmp first"
        )
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        raise RuntimeError(
            "torch.distributed is not initialised (or single-process); "
            "use run_mut instead"
        )
    nproc, pid = dist.get_world_size(), dist.get_rank()
    device = rank_device(device)

    st = StageTimer()
    age, ref_age = mut_em._ages(cfg)
    seed = cfg.seed if cfg.seed is not None else 1
    chroms, mut_files, tmask_files, rmask_files = mut_em.resolve_tmp_inputs(cfg)

    lo, hi = partition_chromosomes(chroms, nproc, pid)
    sub = slice(lo, hi)
    with st.stage("parse_local"):
        if lo < hi:
            sh, ns, se, ne, nsites_loc, nb_loc = mut_em.compute_suffstats(
                cfg,
                chroms[sub],
                mut_files[sub],
                tmask_files[sub] if tmask_files else None,
                rmask_files[sub] if rmask_files else None,
                age,
                ref_age,
                False,
                None,
                seed,
                st,
                device,
            )
        else:  # more processes than chromosomes: empty shard
            sh = ns = se = ne = np.zeros((0, NUM_AGE_BINS), np.float64)
            nsites_loc, nb_loc = 0, 0

    with st.stage("dcn_merge"):
        table = allgather_scalars(nb_loc, nsites_loc)
        offsets = np.concatenate([[0], np.cumsum(table[:, 0])])
        total_blocks = int(offsets[-1])
        num_sites = int(table[:, 1].sum())
        merged = psum_histograms((sh, ns, se, ne), int(offsets[pid]), total_blocks)
    log_event(
        "multihost_merge",
        process=pid,
        processes=nproc,
        device=str(device),
        chroms_local=hi - lo,
        blocks_local=nb_loc,
        blocks_total=total_blocks,
        sites_total=num_sites,
        sec=st.timings["dcn_merge"],
    )

    # the bootstrap and the EM are deterministic given the merged
    # histograms and the seed, so every rank computes the same result.  The
    # seed is passed on: without it each rank would draw its own from
    # time+pid and the ranks' bootstrap weights would differ.
    res = mut_em.finish_from_suffstats(
        cfg, (*merged, num_sites, total_blocks), st, device, seed=seed,
        write_outputs=pid == 0,
    )
    if pid == 0:
        write_mut_coal(
            cfg.output + ".coal",
            res.epochs,
            res.rates,
            is_ancient=res.is_ancient,
            ep_null=res.ep_null,
        )
    return res
