"""Colate-compatible command line of the PyTorch port.

The flag surface is colate_tpu's (``_build_parser``, ``_read_chr_list``
and ``_print_rusage`` are copied from colate_tpu/cli.py) plus
``--torch_device {cuda,cpu}``.  Every mode of colate_tpu's CLI runs:

- mode ``mut`` on every input of the reference: ``--target_bcf`` with or
  without ``--reference_bcf``, ``--target_bam`` with ``--reference_bcf``
  (``--per_chr_bam``) or ``--reference_bam`` (BAM or CRAM), and
  ``--target_tmp/--reference_tmp``;
- the tree estimators, modes ``tree``/``coal`` and ``local_ancestry``;
- the host modes ``make_tmp``, ``preprocess_mut``, ``print_tmp``,
  ``compare_tmp``, ``count_topo``, ``calc_depth``, ``get_deam`` and
  ``CondCoalRates``, which do no device work, need no card and never
  import torch (this module imports it only for the modes that use it).

``--torch_device cuda`` on a machine without a card raises in mode
``mut`` and the tree estimators: the port never drops to the CPU by
itself.  Under ``cuda`` the tree estimators run their device programs on
the card; under ``cpu`` the reference's host routes (the native walks;
the torch program on the CPU for ancient leaves in mode tree).

``--binning device`` and ``--binning sharded`` bin the sites of mode
``mut`` on ``--torch_device``.  Without ``--devices`` ``sharded`` is one
shard: the block-aligned kernel over the whole stream, which is what
``device`` runs, so the two write the same histograms.  ``--devices N``
splits the bootstrap EM (and the binning under ``sharded``) over the
first N cards; ``--checkpoint`` caches the histograms and the EM's loop
state; ``--coordinator/--num_processes/--process_id`` run one process per
rank with ``torch.distributed`` (parallel/multihost.py).
"""

from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="colate-tpu-torch",
        description="Coalescence-rate engine on PyTorch/CUDA (Colate-compatible)",
    )
    p.add_argument("--mode", required=True,
                   help="mut, make_tmp, preprocess_mut, print_tmp, compare_tmp, "
                        "count_topo, calc_depth, get_deam, CondCoalRates, tree, "
                        "local_ancestry")
    p.add_argument("--anc", help="filename of file containing trees")
    p.add_argument("--mut", help="filename of file containing mut")
    p.add_argument("--target_bcf")
    p.add_argument("--reference_bcf")
    p.add_argument("--target_mask")
    p.add_argument("--reference_mask")
    p.add_argument("--target_table")
    p.add_argument("--target_bam")
    p.add_argument("--reference_bam")
    p.add_argument("--target_tmp")
    p.add_argument("--reference_tmp")
    p.add_argument("--target_age", type=float, default=0.0)
    p.add_argument("--reference_age", type=float, default=0.0)
    p.add_argument("--ref_genome")
    p.add_argument("--anc_genome")
    p.add_argument("--mask")
    p.add_argument("--mask_cutoff", type=float, default=0.9)
    p.add_argument("--chr", dest="chr_file")
    p.add_argument("--bins")
    p.add_argument("--lineage_bin")
    p.add_argument("--outgroup_tmrca", type=float)
    p.add_argument("--years_per_gen", type=float, default=28.0)
    p.add_argument("--coal")
    p.add_argument("--seed", type=int)
    p.add_argument("--num_bootstraps", type=int, default=1)
    p.add_argument("--filters", default="20,30,10",
                   help="MAPQ,LEN,MAX_MISMATCH for BAM parsing")
    p.add_argument("--strandfilter", action="store_true")
    p.add_argument("--groups")
    p.add_argument("--poplabels")
    p.add_argument("--map")
    p.add_argument("--dist",
                   help="mode tree: per-chromosome <dist>_chr<name>.dist "
                        "files providing (pos, dist) spans instead of the "
                        ".mut dist column (relate_lib AncMutIterators "
                        "3-arg constructor, mutations.cpp:399-465)")
    p.add_argument("-i", "--input")
    p.add_argument("-o", "--output", required=True)
    # engine extensions
    p.add_argument("--sampling", choices=["analytic", "mc_parity"],
                   default="analytic",
                   help="age-histogram mode: analytic expectation (default) "
                        "or bit-exact replay of the reference's MC draws")
    p.add_argument("--em_dtype", choices=["auto", "float64", "float32"],
                   default="auto",
                   help="EM working precision (auto: the float32 CUDA "
                        "kernel on a card; on the CPU the host f64 EM up "
                        "to 800 replicates, torch f64 above and under "
                        "--checkpoint or --devices; f64 for --sampling "
                        "mc_parity)")
    p.add_argument("--checkpoint", action="store_true",
                   help="cache per-block histograms to <output>.suffstats.npz "
                        "keyed by an input fingerprint, so reruns skip "
                        "parse+binning, and save the EM's loop state to "
                        "<output>.emstate.npz, so a killed run resumes "
                        "(analytic mode)")
    p.add_argument("--per_chr_bam", action="store_true",
                   help="mode mut with --target_bam+--reference_bcf: read "
                        "one BAM per chromosome (<target_bam>_chr<name>.bam) "
                        "instead of one multi-contig BAM (the reference's "
                        "parse_bamvcf layout, coal.cpp:1229-1510)")
    p.add_argument("--devices", type=int,
                   help="mode mut: split the bootstrap EM (and the binning "
                        "under --binning sharded) over the first N cards "
                        "(the CUDA EM kernel on each; parallel/mesh.py), or N "
                        "shards under --torch_device cpu; raises when torch "
                        "sees fewer cards; default: one device")
    p.add_argument("--binning",
                   choices=["auto", "native", "device", "sharded"],
                   default="auto",
                   help="mode mut analytic-binning backend: auto (the "
                        "native C++ f64 host binning, fused with the parse), "
                        "native (the same after a staged join), device (the "
                        "CUDA binning kernel on --torch_device), sharded "
                        "(the kernel over the --devices cards — bitwise "
                        "invariant to their count)")
    p.add_argument("--coordinator",
                   help="multi-process mode mut: the torch.distributed "
                        "rendezvous address host:port (launch one process "
                        "per rank with --num_processes/--process_id; each "
                        "rank parses and bins its chromosomes on its card, "
                        "cuda:<LOCAL_RANK or rank> modulo the cards, the "
                        "histograms are merged over gloo, and rank 0 writes "
                        "the .coal)")
    p.add_argument("--num_processes", type=int,
                   help="total process count for --coordinator runs "
                        "(default: WORLD_SIZE, with MASTER_ADDR/MASTER_PORT)")
    p.add_argument("--process_id", type=int,
                   help="this process's rank for --coordinator runs "
                        "(default: RANK)")
    return p


def _read_chr_list(path: str | None) -> list[str] | None:
    if not path:
        return None
    with open(path) as fh:
        return [ln.strip() for ln in fh if ln.strip()]


def _print_rusage() -> None:
    """End-of-run resource report, same shape as the reference's
    getrusage print (coal.cpp:3852-3861)."""
    try:
        import resource

        u = resource.getrusage(resource.RUSAGE_SELF)
        cpu = u.ru_utime + u.ru_stime
        print(
            f"CPU Time spent: {cpu:.6f}s; Max Memory usage: "
            f"{u.ru_maxrss / 1000.0}Mb.",
            file=sys.stderr,
        )
        print("-" * 57 + "\n", file=sys.stderr)
    except Exception:
        pass


def build_parser():
    p = _build_parser()
    p.add_argument("--torch_device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the EM, of --binning device|sharded and "
                        "of the tree estimators' programs (cuda: the "
                        "hand-written kernels and the programs on the card; "
                        "cpu: the plain torch versions and the host routes)")
    return p


def main(argv: list[str] | None = None) -> int:
    """CLI entry point (colate_tpu.cli.main's error blocks and rusage)."""
    try:
        return _dispatch(argv)
    except (ValueError, FileNotFoundError) as exc:
        print(f"####### error #######\n{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    finally:
        _print_rusage()


def _dispatch(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    mode = args.mode
    if mode == "mut":
        return _run_mut(args)
    # the host modes: converters, stream comparisons, BAM statistics and
    # CondCoalRates, no device work
    if mode == "make_tmp":
        from colate_tpu_torch.models.make_tmp import run_make_tmp

        return run_make_tmp(args)
    if mode == "print_tmp":
        from colate_tpu_torch.models.print_tmp import run_print_tmp

        return run_print_tmp(args)
    if mode == "preprocess_mut":
        from colate_tpu_torch.models.preprocess_mut import run_preprocess_mut

        return run_preprocess_mut(args)
    if mode == "compare_tmp":
        from colate_tpu_torch.models.compare_tmp import run_compare_tmp

        return run_compare_tmp(args)
    if mode == "count_topo":
        from colate_tpu_torch.models.compare_tmp import run_count_topo

        return run_count_topo(args)
    if mode == "CondCoalRates":
        from colate_tpu_torch.models.cond_coal import run_cond_coal

        return run_cond_coal(args)
    if mode == "calc_depth":
        from colate_tpu_torch.models.bam_stats import run_calc_depth

        return run_calc_depth(args)
    if mode == "get_deam":
        from colate_tpu_torch.models.bam_stats import run_get_deam

        return run_get_deam(args)
    if mode in ("tree", "coal", "local_ancestry"):
        _require_card(args)
        if mode == "local_ancestry":
            from colate_tpu_torch.models.local_ancestry import run_local_ancestry

            return run_local_ancestry(args)
        from colate_tpu_torch.models.tree_coal import run_tree_mode

        return run_tree_mode(args)
    print(f"####### error #######\nInvalid or missing mode: {mode}", file=sys.stderr)
    return 2


def _run_mut(args) -> int:
    _require_card(args)
    if (args.coordinator, args.num_processes, args.process_id) != (None, None, None):
        # one process per rank runs this same command; rank 0 writes the .coal
        import torch.distributed as dist

        from colate_tpu_torch.parallel.multihost import init_distributed, run_mut_multihost
        from colate_tpu_torch.utils.progress import profile_trace

        init_distributed(args.coordinator, args.num_processes, args.process_id)
        try:
            with profile_trace():  # COLATE_TPU_TRACE=<dir>: each rank's whole run
                run_mut_multihost(mut_config(args), args.torch_device)
        finally:
            dist.destroy_process_group()
        return 0

    from colate_tpu_torch.models.mut_em import run_mut_and_write

    run_mut_and_write(mut_config(args), args.torch_device)
    return 0


def _require_card(args) -> None:
    from colate_tpu_torch._torch import torch

    if args.torch_device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--torch_device cuda, but torch sees no CUDA device; "
            "pass --torch_device cpu to run on the CPU"
        )


def mut_config(args):
    """The mode-mut run configuration (``MutRunConfig``) of parsed arguments."""
    from colate_tpu_torch.config import MutRunConfig

    return MutRunConfig(
        mut=args.mut,
        output=args.output,
        chr_list=_read_chr_list(args.chr_file),
        target_tmp=args.target_tmp,
        reference_tmp=args.reference_tmp,
        target_bcf=args.target_bcf,
        reference_bcf=args.reference_bcf,
        target_bam=args.target_bam,
        reference_bam=args.reference_bam,
        ref_genome=args.ref_genome,
        target_mask=args.target_mask,
        reference_mask=args.reference_mask,
        coal=args.coal,
        bins=args.bins,
        target_age=args.target_age,
        reference_age=args.reference_age,
        years_per_gen=args.years_per_gen,
        num_bootstrap=args.num_bootstraps,
        seed=args.seed,
        filters=args.filters,
        sampling=args.sampling,
        em_dtype=args.em_dtype,
        checkpoint=args.checkpoint,
        per_chr_bam=args.per_chr_bam,
        devices=args.devices,
        binning=args.binning,
    )


if __name__ == "__main__":
    raise SystemExit(main())
