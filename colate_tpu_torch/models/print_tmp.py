"""Mode ``print_tmp``: decode a ``.colate.in`` against ``.mut`` to text.

Copied from colate_tpu/models/print_tmp.py with the imports rewritten.

Reference: coal/coal.cpp:4148-4295.  Output row per matched site:
``chrom bp anc der age_begin age_end AAF DAF``.

Cursor semantics differ subtly from mode mut's parser: the advance loop
stops at the first record with bp >= pos, and the *current* record is
compared — matching does NOT require that any record was freshly read,
so a stale record at the same position can match repeated mutation rows.
Filters: flipped==0, single branch, age_begin <= age_end, valid alleles
(no masks, no age threshold).
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.formats.colate_in import read_colate_in
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.pipeline.join import _allele_codes


def print_tmp(
    chrom_names: list[str],
    mut_files: list[str],
    target_tmp: str,
    out_path: str,
) -> int:
    stream = read_colate_in(target_tmp)
    n_rec = len(stream)
    consumed = 0  # records consumed so far (cursor = index consumed-1)
    cur_chrom: str | None = None
    n_out = 0
    with open(out_path, "w") as os_:
        for chrom, mf in zip(chrom_names, mut_files):
            mt = MutTable.read(mf)
            anc_c, der_c, valid = _allele_codes(mt.mutation_type)
            keep = (
                (mt.flipped == 0)
                & (mt.num_branches == 1)
                & (mt.age_begin <= mt.age_end)
                & valid
            )
            rows = np.nonzero(keep)[0]
            pos = mt.pos[rows].astype(np.int64)

            # chromosome scan: consume records until the current one matches
            if cur_chrom != chrom:
                i = consumed  # index of next unread record
                while i < n_rec and stream.chrom[i] != chrom:
                    i += 1
                if i >= n_rec:
                    consumed = n_rec
                    cur_chrom = chrom
                    continue
                consumed = i + 1
                cur_chrom = chrom
            lo = consumed - 1  # current (consumed) record index
            hi = lo
            while hi < n_rec and stream.chrom[hi] == chrom:
                hi += 1
            if lo >= hi:
                continue
            seg_bp = stream.bp[lo:hi]
            s = np.searchsorted(seg_bp, pos, side="left")
            cursor = np.maximum.accumulate(np.maximum(s, 0))
            in_seg = cursor < (hi - lo)
            idx = np.where(in_seg, cursor, 0)
            ok = (
                in_seg
                & (seg_bp[idx] == pos)
                & (stream.anc[lo:hi][idx] == anc_c[rows])
                & (stream.der[lo:hi][idx] == der_c[rows])
            )
            for j in np.nonzero(ok)[0]:
                r = lo + idx[j]
                mrow = rows[j]
                os_.write(
                    f"{chrom} {stream.bp[r]} {chr(stream.anc[r])} "
                    f"{chr(stream.der[r])} {mt.age_begin[mrow]:g} "
                    f"{mt.age_end[mrow]:g} {stream.aaf[r]} {stream.daf[r]}\n"
                )
                n_out += 1
            # final cursor state
            if pos.size:
                final = int(cursor[-1])
                if final >= (hi - lo):
                    consumed = hi + 1 if hi < n_rec else n_rec
                    cur_chrom = stream.chrom[hi] if hi < n_rec else cur_chrom
                else:
                    consumed = lo + final + 1
    return n_out


def run_print_tmp(args) -> int:
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]
        mut_files = [f"{args.mut}_chr{c}.mut" for c in chroms]
    else:
        chroms = [""]
        mut_files = [args.mut]
    n = print_tmp(chroms, mut_files, args.target_tmp, args.output)
    print(f"print_tmp: wrote {n} rows to {args.output}", file=sys.stderr)
    return 0
