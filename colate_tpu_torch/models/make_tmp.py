"""Mode ``make_tmp``: precompute ``.colate.in`` site streams.

Three input kinds (reference coal/coal.cpp:2924-3069):
- BCF  (maketmp_vcf,   coal.cpp:2325-2524) — via the native BCF decoder;
- BAM  (maketmp_bam,   coal.cpp:2526-2680) — via the native pileup engine;
- text table "CHR BP allele" (maketmp_table, coal.cpp:2682-2808).

The table variant (pure host logic) is implemented here; byte-compatible
records are emitted through formats/colate_in.py.  Notable reference
semantics replicated exactly:

- filters: flipped==0 and a single mapped branch only (NO age check);
- mask: sites at/after the mask end FAIL (unlike mode mut, where
  out-of-range sites pass — coal.cpp:2752-2757 vs 2163-2168);
- the table token cursor can match a *stale* record (no advance
  requirement), and with a ref genome a mismatching allele drops the
  site entirely; without one, DAF = (allele != ancestral);
- N_target = 1 (single sampled read per site).

Copied from colate_tpu/models/make_tmp.py with its imports rewritten.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.formats.colate_in import write_colate_in
from colate_tpu_torch.formats.fasta import read_fasta, read_mask
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.pipeline.join import allele_codes


class _TableCursor:
    """Sequential whitespace-token cursor over a 'CHR BP allele' table."""

    def __init__(self, path: str):
        toks = open(path).read().split()
        if len(toks) % 3:
            toks = toks[: len(toks) - len(toks) % 3]
        self.chrom = toks[0::3]
        self.bp = np.array([int(x) for x in toks[1::3]], dtype=np.int64)
        self.allele = toks[2::3]
        self.i = -1  # current record; -1 = nothing read yet
        self.n = len(self.bp)

    def prime(self) -> None:
        if self.i < 0:
            self.i = 0 if self.n else self.n

    def scan_chrom(self, chrom: str) -> None:
        self.prime()
        while self.i < self.n and self.chrom[self.i] != chrom:
            self.i += 1

    def cur(self):
        if 0 <= self.i < self.n:
            return self.chrom[self.i], int(self.bp[self.i]), self.allele[self.i]
        return None, None, None  # stream exhausted


def maketmp_table(
    chrom_names: list[str],
    mut_files: list[str],
    target_table: str,
    mask_files: list[str] | None,
    ref_genome_files: list[str] | None,
    out_path: str,
) -> int:
    cur = _TableCursor(target_table)
    o_chrom, o_bp, o_anc, o_der, o_aaf, o_daf = [], [], [], [], [], []
    for ci, chrom in enumerate(chrom_names):
        mt = MutTable.read(mut_files[ci])
        mask = read_mask(mask_files[ci]) if mask_files else None
        has_ref_genome = bool(ref_genome_files)
        if has_ref_genome:
            read_fasta(ref_genome_files[ci])  # loaded, only presence matters

        anc_c, der_c, valid = allele_codes(mt)
        cur.scan_chrom(chrom)
        for r in range(len(mt)):
            if mt.flipped[r] != 0 or mt.num_branches[r] != 1 or not valid[r]:
                continue
            bp_mut = int(mt.pos[r])
            if mask is not None:
                if bp_mut >= mask.shape[0] or mask[bp_mut - 1] != ord("P"):
                    continue
            c, bp, allele = cur.cur()
            while c == chrom and bp is not None and bp < bp_mut:
                cur.i += 1
                c, bp, allele = cur.cur()
            if c != chrom or bp != bp_mut:
                continue
            anc = chr(anc_c[r])
            der = chr(der_c[r])
            if has_ref_genome:
                if allele == der:
                    daf = 1
                elif allele == anc:
                    daf = 0
                else:
                    continue  # unexpected allele drops the site
            else:
                daf = 1 if allele != anc else 0
            o_chrom.append(chrom)
            o_bp.append(bp_mut)
            o_anc.append(ord(anc))
            o_der.append(ord(der))
            o_aaf.append(1 - daf)
            o_daf.append(daf)
    write_colate_in(
        out_path,
        np.array(o_chrom, dtype=object),
        np.array(o_bp, dtype=np.int64),
        np.array(o_anc, dtype=np.uint8),
        np.array(o_der, dtype=np.uint8),
        np.array(o_aaf, dtype=np.int64),
        np.array(o_daf, dtype=np.int64),
    )
    return len(o_bp)


def _resolve(args, attr_ext: list[tuple[str, str]]):
    """Per-chromosome filename resolution (coal.cpp:2953-2983)."""
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]
    else:
        chroms = [""]

    def names(prefix: str | None, ext: str):
        if prefix is None:
            return None
        if chroms == [""]:
            return [prefix]
        return [f"{prefix}_chr{c}{ext}" for c in chroms]

    return chroms, names


def run_make_tmp(args) -> int:
    chroms, names = _resolve(args, [])
    out = args.output + ".colate.in"
    if args.target_table:
        n = maketmp_table(
            chroms,
            names(args.mut, ".mut"),
            args.target_table,
            names(args.target_mask, ".fa"),
            names(args.ref_genome, ".fa"),
            out,
        )
        print(f"make_tmp: wrote {n} records to {out}", file=sys.stderr)
        return 0
    if args.target_bcf:
        from colate_tpu_torch.models.make_tmp_vcf import maketmp_vcf

        n = maketmp_vcf(
            chroms,
            names(args.mut, ".mut"),
            names(args.target_bcf, ".bcf"),
            names(args.target_mask, ".fa"),
            names(args.ref_genome, ".fa"),
            out,
        )
        print(f"make_tmp: wrote {n} records to {out}", file=sys.stderr)
        return 0
    if args.target_bam:
        from colate_tpu_torch.models.make_tmp_bam import maketmp_bam

        n = maketmp_bam(
            chroms,
            names(args.mut, ".mut"),
            args.target_bam,
            names(args.target_mask, ".fa"),
            names(args.ref_genome, ".fa"),
            names(args.anc_genome, ".fa"),
            out,
            params=getattr(args, "filters", None) or "20,30,10",
            strandfilter=bool(getattr(args, "strandfilter", False)),
        )
        print(f"make_tmp: wrote {n} records to {out}", file=sys.stderr)
        return 0
    print("make_tmp: need --target_bcf, --target_bam or --target_table",
          file=sys.stderr)
    return 2
