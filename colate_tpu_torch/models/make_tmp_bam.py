"""``make_tmp --target_bam``: BAM pileup → .colate.in site stream.

Reference: maketmp_bam (coal/coal.cpp:2526-2680).  Per .mut row (with
flipped==0, single branch, nonempty anc/der alleles, ancestral in
{A,C,G,T,0}, mask 'P' at bp-1 when a mask is given):

- stream the pileup cursor to bp-1 (0-based);
- the site is emitted only if the position has a pileup entry
  (coal.cpp:2607) with at least one read (num_reads>0, coal.cpp:2615)
  and AAF+DAF > 0 (coal.cpp:2645);
- AAF/DAF are the A/C/G/T counts matching the ancestral/derived
  allele letters (coal.cpp:2618-2641);
- one BAM file covers all chromosomes; genomes/masks/muts are per-chr
  (<prefix>_chr<name>.fa, coal.cpp:2990-3006).

Copied from colate_tpu/models/make_tmp_bam.py with its imports rewritten.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.formats.colate_in import write_colate_in
from colate_tpu_torch.formats.fasta import read_mask
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.models.bam_pileup import open_pileup

_VALID_ANC = {"A", "C", "G", "T", "0"}
_LETTER = {"A": 0, "C": 1, "G": 2, "T": 3}


def maketmp_bam(
    chrom_names: list[str],
    mut_files: list[str],
    bam_file: str,
    mask_files: list[str] | None,
    ref_genome_files: list[str],
    anc_genome_files: list[str] | None,
    out_path: str,
    params: str = "20,30,10",
    strandfilter: bool = False,
) -> int:
    target = open_pileup(bam_file, params, strandfilter)
    o_chrom, o_bp, o_anc, o_der, o_aaf, o_daf = [], [], [], [], [], []
    for ci, chrom in enumerate(chrom_names):
        print(f"parsing CHR: {ci + 1} / {len(chrom_names)}", file=sys.stderr)
        mask = read_mask(mask_files[ci]) if mask_files else None
        mt = MutTable.read(mut_files[ci])  # native fast parse keeps mtype

        # ---- static row filters (coal.cpp:2569-2607), vectorised where
        # numeric; the mutation_type string parse only touches survivors
        base = (mt.flipped == 0) & (mt.num_branches == 1)
        if mask is not None:
            bp_all = mt.pos.astype(np.int64)
            inb = bp_all < mask.shape[0]
            midx = np.clip(bp_all - 1, 0, max(mask.shape[0] - 1, 0))
            base &= inb & (mask[midx] == ord("P"))
        cand0 = np.nonzero(base)[0]
        cand: list[int] = []
        anc_col = []  # count column, -1 when the allele matches no base
        der_col = []
        anc0 = []  # first character (emitted byte)
        der0 = []
        mtypes = mt.mutation_type
        for r in cand0.tolist():
            mtype = mtypes[r]
            j = mtype.find("/")
            ancestral = mtype[:j] if j >= 0 else mtype
            derived = mtype[j + 1 :] if j >= 0 else ""
            if not ancestral or not derived:
                continue
            if ancestral not in _VALID_ANC:
                continue
            cand.append(r)
            anc_col.append(_LETTER.get(ancestral, -1))
            der_col.append(_LETTER.get(derived, -1))
            anc0.append(ord(ancestral[0]))
            der0.append(ord(derived[0]))

        # ---- one streamed pass over the contig, answering all rows ----
        bp = mt.pos[np.asarray(cand, np.int64)].astype(np.int64) if cand else (
            np.zeros(0, np.int64)
        )
        claimed, counts, cov_raw, cova_raw, glen = target.contig_counts(
            chrom,
            ref_genome_files[ci],
            anc_genome_files[ci] if strandfilter else None,
            bp - 1,
        )
        m = bp.shape[0]
        if m:
            ac = np.asarray(anc_col, np.int64)
            dc = np.asarray(der_col, np.int64)
            rows_i = np.arange(m)
            aaf = np.where(ac >= 0, counts[rows_i, np.maximum(ac, 0)], 0)
            daf = np.where(dc >= 0, counts[rows_i, np.maximum(dc, 0)], 0)
            sel = claimed & (counts.sum(axis=1) > 0) & ((aaf > 0) | (daf > 0))
            ks = np.nonzero(sel)[0]
            o_chrom.append(np.full(ks.shape[0], chrom, object))
            o_bp.append(bp[ks])
            o_anc.append(np.asarray(anc0, np.uint8)[ks])
            o_der.append(np.asarray(der0, np.uint8)[ks])
            o_aaf.append(aaf[ks])
            o_daf.append(daf[ks])
        print(
            f"Bam coverage: {cov_raw / max(glen, 1):g} "
            f"{cova_raw / max(glen, 1):g}",
            file=sys.stderr,
        )
    cat = lambda parts, dt: (
        np.concatenate(parts).astype(dt) if parts else np.zeros(0, dt)
    )
    bp_out = cat(o_bp, np.int64)
    write_colate_in(
        out_path,
        cat(o_chrom, object),
        bp_out,
        cat(o_anc, np.uint8),
        cat(o_der, np.uint8),
        cat(o_aaf, np.int64),
        cat(o_daf, np.int64),
    )
    return int(bp_out.shape[0])
