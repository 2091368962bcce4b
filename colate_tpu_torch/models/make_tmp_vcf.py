"""maketmp_vcf: BCF/VCF genotypes → ``.colate.in`` site stream.

Reference: coal/coal.cpp:2325-2524.  Per mutation row (flipped==0, one
branch, valid alleles, mask pass — here out-of-range positions FAIL,
both mask conventions are applied):

- advance the VCF cursor to the first record at/after the position;
- record present: three cases on (REF, first ALT):
  * REF == derived, no ALT: fixed-for-derived candidate — all genotypes
    must be 0 (DAF sum == 0), then DAF := N;
  * alleles match straight or flipped: DAF = Σ allele indices (missing
    genotypes contribute -1, a bcf_gt_allele quirk), flipped ⇒ N-DAF;
    any allele index > 1 drops the site;
  * otherwise drop;
- record absent (or cursor at EOF): the reference genome base decides —
  == derived ⇒ DAF=N, == ancestral ⇒ DAF=0, else drop.  N here is
  n_samples·ploidy from the most recent record.

Copied from colate_tpu/models/make_tmp_vcf.py with its imports rewritten.
"""

from __future__ import annotations

import numpy as np

from colate_tpu_torch.formats.colate_in import write_colate_in
from colate_tpu_torch.formats.fasta import read_fasta, read_mask
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.formats.vcf import read_vcf
from colate_tpu_torch.pipeline.join import allele_codes


def maketmp_vcf(
    chrom_names: list[str],
    mut_files: list[str],
    vcf_files: list[str],
    mask_files: list[str] | None,
    ref_genome_files: list[str] | None,
    out_path: str,
) -> int:
    o_chrom, o_bp, o_anc, o_der, o_aaf, o_daf = [], [], [], [], [], []
    for ci, chrom in enumerate(chrom_names):
        mt = MutTable.read(mut_files[ci])
        vt = read_vcf(vcf_files[ci])
        mask = read_mask(mask_files[ci]) if mask_files else None
        ref_genome = read_fasta(ref_genome_files[ci]) if ref_genome_files else None
        anc_c, der_c, valid = allele_codes(mt)

        n_rec = len(vt)
        n_hap = vt.gt.shape[1]
        cursor = 0  # current record (first record pre-read, coal.cpp:2360)
        n_target = n_hap
        for r in range(len(mt)):
            if mt.flipped[r] != 0 or mt.num_branches[r] != 1 or not valid[r]:
                continue
            bp_mut = int(mt.pos[r])
            if mask is not None:
                if bp_mut >= mask.shape[0] or mask[bp_mut - 1] != ord("P"):
                    continue
            anc = chr(anc_c[r])
            der = chr(der_c[r])
            # cursor advance: first record with pos >= bp_mut (stops there)
            if cursor < n_rec and vt.pos[cursor] < bp_mut:
                while cursor + 1 < n_rec:
                    cursor += 1
                    if vt.pos[cursor] >= bp_mut:
                        break
                else:
                    cursor = n_rec - 1 if n_rec else 0
            present = n_rec > 0 and int(vt.pos[cursor]) == bp_mut
            use = True
            daf = 0
            if present:
                ref_al = vt.ref[cursor]
                alt_al = vt.alt[cursor]
                row = vt.gt[cursor].astype(np.int64)
                if ref_al == der and alt_al == "":
                    s = int(row.sum())
                    n_target = row.shape[0]
                    if np.any(row > 1):
                        use = False
                    elif s != 0:
                        use = False
                    else:
                        daf = n_target
                elif (ref_al == anc and alt_al == der) or (
                    ref_al == der and alt_al == anc
                ):
                    flip = ref_al == der and alt_al == anc
                    s = int(row.sum())
                    n_target = row.shape[0]
                    if np.any(row > 1):
                        use = False
                    else:
                        daf = n_target - s if flip else s
                else:
                    use = False
            else:
                if ref_genome is not None and bp_mut - 1 < len(ref_genome):
                    base = ref_genome[bp_mut - 1]
                    if base == der:
                        daf = n_target
                    elif base == anc:
                        daf = 0
                    else:
                        use = False
                else:
                    use = False
            if use:
                o_chrom.append(chrom)
                o_bp.append(bp_mut)
                o_anc.append(ord(anc))
                o_der.append(ord(der))
                o_aaf.append(n_target - daf)
                o_daf.append(daf)
    write_colate_in(
        out_path,
        np.array(o_chrom, object),
        np.array(o_bp, np.int64),
        np.array(o_anc, np.uint8),
        np.array(o_der, np.uint8),
        np.array(o_aaf, np.int64),
        np.array(o_daf, np.int64),
    )
    return len(o_bp)
