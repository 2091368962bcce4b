"""Modes ``calc_depth`` and ``get_deam``: BAM coverage / deamination QC.

Reference: calc_depth (coal/coal.cpp:2812-2863) and get_deam
(coal.cpp:2865-2921) with the read loop in bam_parser::read_deam
(include/vcf/htslib.cpp:440-486).

- calc_depth: mean coverage before/after the mapq/len/mismatch filters,
  totalled over all chromosomes; writes "<cov> <cov_filtered>".
- get_deam: C→T (fwd) / G→A (as-ref) mismatch counts by distance from
  each read end (15 positions), CpG-stratified; mapq/len filters only.
  The first contig-matching read per chromosome is consumed by
  assign_contig and is NOT deam-counted (read_deam only counts reads
  its own loop consumes — htslib.cpp:443-447).

Copied from colate_tpu/models/bam_stats.py with its imports rewritten.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.models.bam_pileup import BamCursor


def _chr_list(args) -> list[str]:
    with open(args.chr_file) as fh:
        return [ln.rstrip("\n") for ln in fh if ln.rstrip("\n")]


def run_calc_depth(args) -> int:
    if not (args.target_bam and args.ref_genome and args.chr_file and args.output):
        print("Needed: target_bam, ref_genome, chr, output.", file=sys.stderr)
        return 2
    chroms = _chr_list(args)
    target = BamCursor(args.target_bam, args.filters or "20,30,10")
    cov = cov_filtered = genome_length = 0.0
    for c in chroms:
        target.assign_contig(c, f"{args.ref_genome}_chr{c}.fa")
        target.read_to_pos(target.ref.shape[0])
        cov += target.coverage
        cov_filtered += target.coverage_after_filter
        genome_length += target.ref.shape[0]
    with open(args.output, "w") as fh:
        fh.write(f"{cov / genome_length:g} {cov_filtered / genome_length:g}\n")
    return 0


def run_get_deam(args) -> int:
    if not (args.target_bam and args.ref_genome and args.chr_file and args.output):
        print("Needed: target_bam, ref_genome, chr, output.", file=sys.stderr)
        return 2
    chroms = _chr_list(args)
    target = BamCursor(args.target_bam, args.filters or "20,30,10")
    stats = {
        k + e: np.zeros(15, np.int64)
        for k in ("isC", "isCT", "isCpG", "isCpGt")
        for e in ("1", "2")
    }
    for c in chroms:
        target.assign_contig(c, f"{args.ref_genome}_chr{c}.fa")
        target.read_deam(target.ref.shape[0], stats)
    with open(args.output, "w") as fh:
        fh.write("pos numC numCpG numCT numCpGT\n")
        for i in range(15):
            fh.write(
                f"{i + 1} {stats['isC1'][i]} {stats['isCpG1'][i]} "
                f"{stats['isCT1'][i]} {stats['isCpGt1'][i]}\n"
            )
        for i in range(15):
            fh.write(
                f"{-(i + 1)} {stats['isC2'][i]} {stats['isCpG2'][i]} "
                f"{stats['isCT2'][i]} {stats['isCpGt2'][i]}\n"
            )
    return 0
