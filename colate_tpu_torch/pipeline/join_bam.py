"""Joins of ``.mut`` tables against BAM pileup evidence (mode ``mut``).

``join_onebamvcf`` replicates parse_onebamvcf (coal/coal.cpp:1512-1796):
one multi-contig target BAM pileup vs a per-chromosome reference BCF.
``join_onebambam`` replicates parse_onebambam (coal/coal.cpp:1798-2069):
target and reference both BAM pileups.  ``join_bamvcf`` replicates
parse_bamvcf (coal/coal.cpp:1229-1510): one target BAM *per
chromosome* vs a per-chromosome reference BCF.  parse_bamvcf is dead
code in the reference CLI (coal.cpp:3256 routes
--target_bam+--reference_bcf to parse_onebamvcf; the per-chr filename
resolution is commented out at coal.cpp:3273), so there is no binary
oracle for it; its per-site math is identical to parse_onebamvcf
(verified line-by-line: the only differences are the per-chromosome
bam_parser construction and block/coverage bookkeeping, which match
too), and we pin it by equality against join_onebamvcf on a
contig-split of the same BAM.  Dispatch is opt-in via --per_chr_bam
with the commented-out convention ``<target_bam>_chr<name>.bam``.

Shared semantics (exact):
- mut-row filters as in the other parsers: flipped==0, one branch,
  age_begin<age_end, valid alleles, masks 'P' at bp-1 when in range
  (coal.cpp:1580-1598); NO anc!=der check in these parsers;
- pileup evidence at bp-1 (0-based): the position must have a claimed
  entry, >0 reads, anc- or der-base count >0, and at most 2 distinct
  observed bases (coal.cpp:1665-1705); AAF/DAF are the anc/der base
  counts (0 when the allele is '0'/'1', which never matches a base);
- onebamvcf reference stream: BCF cursor advancing while bp < bp_mut
  (no consumed-record requirement), straight/flip allele match on
  REF/first-ALT only (a no-ALT record never matches), missing genotypes
  count -1, non-biallelic rejects; absent sites fall back to the ref
  genome with DAF_ref = N_ref — the reference reuses a *stale* N_ref
  there (coal.cpp:1648-1656, N_ref last assigned at a matched record),
  but since the weights only ever use the ratio DAF_ref/N_ref == 1 the
  numerical result is DAF_target (resp. AAF_target) regardless, which
  is what we compute; DAF_ref == 0 rejects;
- onebambam reference stream: pileup evidence with the same filters as
  the target, DAF_ref==0 rejects, N_ref = AAF_ref + DAF_ref
  (coal.cpp:1930-1934);
- weights: w_shared = DAF_target*DAF_ref/N_ref,
  w_notshared = AAF_target*DAF_ref/N_ref (NOT N-DAF: coal.cpp:1723);
- 30 Mb blocks per used site + one boundary per chromosome end.

The BAM streams through :func:`open_pileup` — the native streaming
cursor (bounded memory, native/hts.cpp) for BAM and CRAM, the in-memory
Python :class:`BamCursor` for SAM text — both answering per-contig batch
queries that are provably count-equivalent to the reference's
horizon-limited ``read_to_pos`` walk for the monotone queries this mode
issues.

Copied from colate_tpu/pipeline/join_bam.py with its imports rewritten.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.config import NUM_BASES_PER_BLOCK
from colate_tpu_torch.formats.fasta import read_fasta, read_mask
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.formats.vcf import read_vcf
from colate_tpu_torch.models.bam_pileup import open_pileup
from colate_tpu_torch.pipeline.join import JoinedSites, _mask_pass, allele_codes
from colate_tpu_torch.pipeline.join_vcf import _cursor_index, _vcf_columns

_BASE_COL = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}


def _filtered_rows(mt: MutTable, age: float, tmask, rmask):
    """Rows passing the shared pre-stream filters; returns (rows, pos,
    anc, der) with anc/der as uint8 codes."""
    anc_c, der_c, valid = allele_codes(mt)
    keep = (
        (mt.flipped == 0)
        & (mt.num_branches == 1)
        & (mt.age_begin < mt.age_end)
        & (mt.age_end >= age)
        & valid
    )
    if tmask is not None:
        keep &= _mask_pass(tmask, mt.pos)
    if rmask is not None:
        keep &= _mask_pass(rmask, mt.pos)
    rows = np.nonzero(keep)[0]
    return rows, mt.pos[rows].astype(np.int64), anc_c[rows], der_c[rows]


def _pileup_evidence(claimed: np.ndarray, counts: np.ndarray,
                     anc: np.ndarray, der: np.ndarray):
    """(accept, aaf, daf) from pileup (claimed, counts[n,4]) evidence
    (coal.cpp:1665-1705)."""
    num_reads = counts.sum(axis=1)
    num_alleles = (counts > 0).sum(axis=1)
    # base-column gather; '0'/'1' alleles never match a base -> count 0
    col = np.zeros((256,), np.int64)
    ok = np.zeros((256,), bool)
    for b, c in _BASE_COL.items():
        col[b] = c
        ok[b] = True
    n = claimed.shape[0]
    aaf = np.where(ok[anc], counts[np.arange(n), col[anc]], 0)
    daf = np.where(ok[der], counts[np.arange(n), col[der]], 0)
    accept = claimed & (num_reads > 0) & ((aaf > 0) | (daf > 0)) & (num_alleles <= 2)
    return accept, aaf.astype(np.int64), daf.astype(np.int64)


def _emit(out, mt, mrows, ws, wn, ref_age, block_offset):
    """Append used sites for one chromosome; returns the chromosome's
    last block index (0 when no site was used)."""
    if mrows.size == 0:
        return 0
    ab = np.maximum(mt.age_begin[mrows], ref_age)
    ae = mt.age_end[mrows]
    bp_used = mt.pos[mrows].astype(np.int64)
    blk = np.maximum((bp_used - 1) // NUM_BASES_PER_BLOCK, 0).astype(np.int64)
    out["ab"].append(ab)
    out["ae"].append(ae)
    out["ws"].append(ws)
    out["wn"].append(wn)
    out["blk"].append(blk + block_offset)
    return int(blk[-1])


def _finish(out, block_offset: int) -> JoinedSites:
    if out["ab"]:
        return JoinedSites(
            age_begin=np.concatenate(out["ab"]),
            age_end=np.concatenate(out["ae"]),
            w_shared=np.concatenate(out["ws"]),
            w_notshared=np.concatenate(out["wn"]),
            block_id=np.concatenate(out["blk"]).astype(np.int32),
            num_blocks=block_offset,
        )
    return JoinedSites(
        age_begin=np.zeros(0),
        age_end=np.zeros(0),
        w_shared=np.zeros(0),
        w_notshared=np.zeros(0),
        block_id=np.zeros(0, np.int32),
        num_blocks=block_offset,
    )


def _bamvcf_chrom(
    cursor,
    chrom: str,
    mut_file: str,
    ref_bcf_file: str,
    tmask_file: str | None,
    rmask_file: str | None,
    ref_genome_file: str,
    age: float,
    ref_age: float,
    out: dict,
    block_offset: int,
    n_ref_defined: bool,
) -> tuple[int, bool]:
    """One chromosome of the shared BAM-target/BCF-reference join
    (the per-mut-row body of coal.cpp:1282-1486 == 1565-1769); returns
    the updated (block_offset, n_ref_defined)."""
    mt = MutTable.read(mut_file)
    ref = read_vcf(ref_bcf_file)
    tmask = read_mask(tmask_file) if tmask_file else None
    rmask = read_mask(rmask_file) if rmask_file else None
    genome = np.frombuffer(read_fasta(ref_genome_file).encode(), np.uint8)

    rows, pos, anc, der = _filtered_rows(mt, age, tmask, rmask)

    # ---- reference BCF stream (coal.cpp:1603-1659) ----
    r_ref1, r_alt1, _, r_daf, r_bi, n_ref = _vcf_columns(ref)
    ridx, rexists = _cursor_index(ref.pos, pos)
    straight = rexists & (r_ref1[ridx] == anc) & (r_alt1[ridx] == der)
    flip = rexists & (r_ref1[ridx] == der) & (r_alt1[ridx] == anc)
    m = straight | flip
    r_use = ~rexists | (m & r_bi[ridx])
    daf_ref = np.where(
        rexists & m, np.where(flip, n_ref - r_daf[ridx], r_daf[ridx]), 0
    )
    # absent -> ref-genome fallback with ratio DAF_ref/N_ref == 1
    gidx = np.clip(pos - 1, 0, max(genome.shape[0] - 1, 0))
    gbase = np.where(
        (pos - 1 >= 0) & (pos - 1 < genome.shape[0]),
        genome[gidx] if genome.shape[0] else 0,
        0,
    )
    absent_ok = ~rexists & (gbase == der)
    if not n_ref_defined:
        mi = np.nonzero(m)[0]
        if mi.size:
            absent_ok &= np.arange(pos.shape[0]) >= mi[0]
            n_ref_defined = True
        else:
            absent_ok &= False
    daf_ref = np.where(absent_ok, n_ref, daf_ref)
    r_use &= rexists | absent_ok
    r_use &= daf_ref != 0
    rsel = np.nonzero(r_use)[0]

    # ---- target pileup (coal.cpp:1661-1705): stream the contig once,
    # answering the surviving rows' positions ----
    claimed, counts, cov_raw, cova_raw, glen = cursor.contig_counts(
        chrom, ref_genome_file, None, pos[rsel] - 1
    )
    t_ok, aaf_t, daf_t = _pileup_evidence(
        claimed, counts, anc[rsel], der[rsel]
    )
    tsel = rsel[t_ok]

    dr = daf_ref[tsel].astype(np.float64)
    ws = daf_t[t_ok].astype(np.float64) * dr / float(n_ref)
    wn = aaf_t[t_ok].astype(np.float64) * dr / float(n_ref)
    last_blk = _emit(out, mt, rows[tsel], ws, wn, ref_age, block_offset)
    print(
        f"Coverage: {cov_raw / max(glen, 1)} {cova_raw / max(glen, 1)}",
        file=sys.stderr,
    )
    return block_offset + last_blk + 1, n_ref_defined


def join_onebamvcf(
    chrom_names: list[str],
    mut_files: list[str],
    bam_file: str,
    ref_bcf_files: list[str],
    tmask_files: list[str] | None,
    rmask_files: list[str] | None,
    ref_genome_files: list[str],
    params: str = "20,30,10",
    age: float = 0.0,
    ref_age: float = 0.0,
) -> JoinedSites:
    age = 0.0  # forced (coal.cpp:1515-1516)
    ref_age = 0.0
    cursor = open_pileup(bam_file, params)
    out = {k: [] for k in ("ab", "ae", "ws", "wn", "blk")}
    block_offset = 0
    # N_ref is uninitialised (0 under the oracle build) until the first
    # allele-matching BCF record, so absent-site fallbacks before it hit
    # the DAF_ref==0 reject (coal.cpp:1648-1656); persists across chrs
    n_ref_defined = False

    for ci, chrom in enumerate(chrom_names):
        print(f"parsing CHR: {ci + 1} / {len(chrom_names)}", file=sys.stderr)
        block_offset, n_ref_defined = _bamvcf_chrom(
            cursor, chrom, mut_files[ci], ref_bcf_files[ci],
            tmask_files[ci] if tmask_files else None,
            rmask_files[ci] if rmask_files else None,
            ref_genome_files[ci], age, ref_age, out, block_offset,
            n_ref_defined,
        )

    return _finish(out, block_offset)


def join_bamvcf(
    chrom_names: list[str],
    mut_files: list[str],
    bam_files: list[str],
    ref_bcf_files: list[str],
    tmask_files: list[str] | None,
    rmask_files: list[str] | None,
    ref_genome_files: list[str],
    params: str = "20,30,10",
    age: float = 0.0,
    ref_age: float = 0.0,
) -> JoinedSites:
    """parse_bamvcf (coal.cpp:1229-1510): one target BAM *per
    chromosome* (``bam_files[ci]``) against per-chromosome reference
    BCFs.  Identical per-site math to join_onebamvcf — the reference's
    two functions differ only in bam_parser lifetime (constructed per
    chromosome with the chromosome's ref genome, coal.cpp:1270) — so a
    contig-split of a multi-contig BAM yields identical sufficient
    statistics (pinned in tests/test_mut_bam.py).  N_ref staleness
    carries across chromosomes exactly as in the reference (the local
    is declared once at coal.cpp:1236)."""
    age = 0.0  # forced (coal.cpp:1231-1232)
    ref_age = 0.0
    out = {k: [] for k in ("ab", "ae", "ws", "wn", "blk")}
    block_offset = 0
    n_ref_defined = False

    for ci, chrom in enumerate(chrom_names):
        print(f"parsing CHR: {ci + 1} / {len(chrom_names)}", file=sys.stderr)
        cursor = open_pileup(bam_files[ci], params)
        try:
            block_offset, n_ref_defined = _bamvcf_chrom(
                cursor, chrom, mut_files[ci], ref_bcf_files[ci],
                tmask_files[ci] if tmask_files else None,
                rmask_files[ci] if rmask_files else None,
                ref_genome_files[ci], age, ref_age, out, block_offset,
                n_ref_defined,
            )
        finally:
            close = getattr(cursor, "close", None)
            if close is not None:
                close()

    return _finish(out, block_offset)


def join_onebambam(
    chrom_names: list[str],
    mut_files: list[str],
    target_bam: str,
    reference_bam: str,
    tmask_files: list[str] | None,
    rmask_files: list[str] | None,
    ref_genome_files: list[str],
    params: str = "20,30,10",
    age: float = 0.0,
    ref_age: float = 0.0,
) -> JoinedSites:
    age = 0.0  # forced (coal.cpp:1800-1801)
    ref_age = 0.0
    target = open_pileup(target_bam, params)
    reference = open_pileup(reference_bam, params)
    out = {k: [] for k in ("ab", "ae", "ws", "wn", "blk")}
    block_offset = 0

    for ci, chrom in enumerate(chrom_names):
        print(f"parsing CHR: {ci + 1} / {len(chrom_names)}", file=sys.stderr)
        mt = MutTable.read(mut_files[ci])
        tmask = read_mask(tmask_files[ci]) if tmask_files else None
        rmask = read_mask(rmask_files[ci]) if rmask_files else None

        rows, pos, anc, der = _filtered_rows(mt, age, tmask, rmask)

        # ---- reference pileup (coal.cpp:1886-1934) ----
        r_claim, r_counts, r_cov, r_cova, glen = reference.contig_counts(
            chrom, ref_genome_files[ci], None, pos - 1
        )
        r_ok, aaf_r, daf_r = _pileup_evidence(r_claim, r_counts, anc, der)
        r_ok &= daf_r != 0
        n_ref = (aaf_r + daf_r).astype(np.float64)
        rsel = np.nonzero(r_ok)[0]

        # ---- target pileup (coal.cpp:1938-1988) ----
        t_claim, t_counts, t_cov, t_cova, glen = target.contig_counts(
            chrom, ref_genome_files[ci], None, pos[rsel] - 1
        )
        t_ok, aaf_t, daf_t = _pileup_evidence(
            t_claim, t_counts, anc[rsel], der[rsel]
        )
        tsel = rsel[t_ok]

        dr = daf_r[tsel].astype(np.float64)
        nr = n_ref[tsel]
        ws = daf_t[t_ok].astype(np.float64) * dr / nr
        wn = aaf_t[t_ok].astype(np.float64) * dr / nr
        last_blk = _emit(out, mt, rows[tsel], ws, wn, ref_age, block_offset)
        block_offset += last_blk + 1
        glen = max(glen, 1)
        print(
            f"Target coverage: {t_cov / glen} {t_cova / glen}",
            file=sys.stderr,
        )
        print(
            f"Reference coverage: {r_cov / glen} {r_cova / glen}",
            file=sys.stderr,
        )

    return _finish(out, block_offset)
