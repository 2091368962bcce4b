"""Colate-compatible command line of the PyTorch port.

The flag surface is colate_tpu's (``colate_tpu.cli._build_parser``) plus
``--torch_device {cuda,cpu}``.  Mode ``mut`` is ported; the modes and
flags that are not yet exit non-zero with an error block naming the
ROADMAP item that ports them.  ``--torch_device cuda`` on a machine
without a card raises: the port never drops to the CPU by itself.

``--binning device`` and ``--binning sharded`` bin ``.colate.in`` inputs
on ``--torch_device``.  Without ``--devices`` (multi-GPU is not ported)
``sharded`` is one shard: the block-aligned kernel over the whole stream,
which is what ``device`` runs, so the two write the same histograms.
"""

from __future__ import annotations

import sys

import torch

from colate_tpu.cli import _build_parser, _print_rusage, _read_chr_list


def build_parser():
    p = _build_parser()
    p.prog = "colate-tpu-torch"
    p.description = "Coalescence-rate engine on PyTorch/CUDA (Colate-compatible)"
    p.add_argument("--torch_device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the EM and of --binning device|sharded "
                        "(cuda: the hand-written kernels; cpu: their plain "
                        "torch versions)")
    return p


def _not_ported(what: str, item: str) -> int:
    print(
        f"####### error #######\n{what} is not ported to colate_tpu_torch yet "
        f"(ROADMAP queue 1: {item}); use python -m colate_tpu",
        file=sys.stderr,
    )
    return 2


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
    if args.mode != "mut":
        return _not_ported(f"mode {args.mode}", "the remaining modes")
    if args.devices is not None:
        return _not_ported("--devices", "multi-GPU")
    if args.checkpoint:
        return _not_ported("--checkpoint", "--checkpoint")
    if (args.coordinator, args.num_processes, args.process_id) != (None, None, None):
        return _not_ported("--coordinator/--num_processes/--process_id", "multi-process")
    if args.torch_device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--torch_device cuda, but torch sees no CUDA device; "
            "pass --torch_device cpu to run on the CPU"
        )

    from colate_tpu_torch.models.mut_em import run_mut_and_write

    run_mut_and_write(mut_config(args), args.torch_device)
    return 0


def mut_config(args):
    """The mode-mut run configuration (``MutRunConfig``) of parsed arguments."""
    from colate_tpu.config import MutRunConfig

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
        per_chr_bam=args.per_chr_bam,
        binning=args.binning,
    )


if __name__ == "__main__":
    raise SystemExit(main())
