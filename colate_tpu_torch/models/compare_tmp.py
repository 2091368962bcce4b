"""Mode ``compare_tmp``: pairwise-mismatch profile in 10 Mb bins.

Copied from colate_tpu/models/compare_tmp.py with the imports rewritten.

Reference: coal/coal.cpp:4297-4521.  Per matched site, one pseudo-allele
is "sampled" per genome — but the reference's sampling probability
``DAF/(AAF+DAF)`` is INTEGER division, so the draw is deterministic:
sampled=1 iff DAF==N.  The two rng draws are still consumed per matched
site (replicated so seeded runs agree).  Output rows per 10 Mb bin:
``chrom current_bp num_mismatch num_snps``.

Mode ``count_topo`` (coal.cpp:4523-4781) shares the 3-stream cursor walk:
for sites present in target+reference (allele-matched) where the
conditional stream's *current* record (no position/allele match is
required — replicated quirk) has N>0 and DAF>0, two f32-rounded uniform
draws pick pseudo-alleles; discordant sites emit ±1 lines.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.formats.colate_in import read_colate_in
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.hostrng import MT19937
from colate_tpu_torch.pipeline.join import _allele_codes

BIN_SIZE = 10_000_000


class _Walk:
    """Shared cursor state over a SiteStream (advance-then-inspect)."""

    def __init__(self, stream):
        self.st = stream
        self.n = len(stream)
        self.consumed = -1
        self.cur_chrom: str | None = "\x00uninit"

    def scan(self, chrom: str):
        if self.cur_chrom != chrom:
            i = self.consumed + 1
            while i < self.n and self.st.chrom[i] != chrom:
                i += 1
            if i >= self.n:
                self.consumed = self.n
                self.cur_chrom = chrom
                return
            self.consumed = i
            self.cur_chrom = chrom

    def advance_vec(self, chrom: str, pos: np.ndarray):
        """Per row: (record_index_at_cursor, fresh_read_happened)."""
        self.scan(chrom)
        lo = min(self.consumed, self.n)
        hi = lo
        while hi < self.n and self.st.chrom[hi] == chrom:
            hi += 1
        m = pos.shape[0]
        if lo >= hi or m == 0:
            idx = np.full(m, -1, np.int64)
            return idx, np.zeros(m, bool)
        seg_bp = self.st.bp[lo:hi]
        s = np.searchsorted(seg_bp, pos, side="left")
        s_prev = np.maximum.accumulate(np.concatenate([[0], s[:-1]]))
        cursor = np.maximum(s, s_prev)
        fresh = s > s_prev
        in_seg = cursor < (hi - lo)
        idx = np.where(in_seg, lo + cursor, -1)
        final = int(max(np.max(s), 0))
        if final >= (hi - lo):
            self.consumed = hi
            self.cur_chrom = self.st.chrom[hi] if hi < self.n else self.cur_chrom
        else:
            self.consumed = lo + final
        return idx, fresh


def run_compare_tmp(args) -> int:
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]
        mut_files = [f"{args.mut}_chr{c}.mut" for c in chroms]
    else:
        chroms = [""]
        mut_files = [args.mut]
    seed = args.seed if args.seed is not None else 1
    rng = MT19937(seed)
    tgt = _Walk(read_colate_in(args.target_tmp))
    ref = _Walk(read_colate_in(args.reference_tmp))

    with open(args.output, "w") as os_:
        for chrom, mf in zip(chroms, mut_files):
            mt = MutTable.read(mf)
            anc_c, der_c, valid = _allele_codes(mt.mutation_type)
            keep = (
                (mt.flipped == 0)
                & (mt.num_branches == 1)
                & (mt.age_begin < mt.age_end)
                & valid
            )
            rows = np.nonzero(keep)[0]
            pos = mt.pos[rows].astype(np.int64)
            t_idx, t_fresh = tgt.advance_vec(chrom, pos)
            r_idx, r_fresh = ref.advance_vec(chrom, pos)

            def rec(walk, idx, field):
                arr = getattr(walk.st, field)
                return np.where(idx >= 0, arr[np.maximum(idx, 0)], 0)

            # the counts are reset before each advance, so a stale cursor
            # yields N==0 (coal.cpp:4443-4462) and the site is skipped
            t_bp = rec(tgt, t_idx, "bp")
            t_ok = (
                (t_idx >= 0)
                & (t_bp == pos)
                & (rec(tgt, t_idx, "anc") == anc_c[rows])
                & (rec(tgt, t_idx, "der") == der_c[rows])
            )
            r_ok = (
                (r_idx >= 0)
                & (rec(ref, r_idx, "bp") == pos)
                & (rec(ref, r_idx, "anc") == anc_c[rows])
                & (rec(ref, r_idx, "der") == der_c[rows])
            )
            t_daf = np.where(t_fresh, rec(tgt, t_idx, "daf"), 0)
            t_aaf = np.where(t_fresh, rec(tgt, t_idx, "aaf"), 0)
            r_daf = np.where(r_fresh, rec(ref, r_idx, "daf"), 0)
            r_aaf = np.where(r_fresh, rec(ref, r_idx, "aaf"), 0)
            matched = t_ok & r_ok & ((t_daf + t_aaf) > 0) & ((r_daf + r_aaf) > 0)

            # binned output with the reference's draw consumption
            num_mismatch = 0.0
            num_snps = 0
            current_bp = int(mt.pos[0]) if len(mt) else 0
            midx = np.nonzero(matched)[0]
            mpos = pos[midx]
            draws = rng.uniform01(2 * midx.size).reshape(-1, 2)
            j = 0
            for k in range(rows.size):
                p = int(pos[k])
                while p > current_bp + BIN_SIZE:
                    os_.write(f"{chrom} {current_bp} {num_mismatch:g} {num_snps:g}\n")
                    num_mismatch = 0.0
                    num_snps = 0
                    current_bp += BIN_SIZE
                if matched[k]:
                    ts = 1 if t_daf[k] == t_daf[k] + t_aaf[k] else 0
                    rs = 1 if r_daf[k] == r_daf[k] + r_aaf[k] else 0
                    # two draws consumed regardless (integer-division quirk
                    # makes the comparison deterministic)
                    j += 1
                    num_mismatch += abs(ts - rs)
                    num_snps += 1
            os_.write(f"{chrom} {current_bp} {num_mismatch:g} {num_snps:g}\n")
    print(f"compare_tmp -> {args.output}", file=sys.stderr)
    return 0


def run_count_topo(args) -> int:
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]
        mut_files = [f"{args.mut}_chr{c}.mut" for c in chroms]
    else:
        chroms = [""]
        mut_files = [args.mut]
    seed = args.seed if args.seed is not None else 1
    rng = MT19937(seed)
    cond = _Walk(read_colate_in(args.input))
    tgt = _Walk(read_colate_in(args.target_tmp))
    ref = _Walk(read_colate_in(args.reference_tmp))

    with open(args.output, "w") as os_:
        for chrom, mf in zip(chroms, mut_files):
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
            c_idx, _ = cond.advance_vec(chrom, pos)
            t_idx, _ = tgt.advance_vec(chrom, pos)
            r_idx, _ = ref.advance_vec(chrom, pos)

            def rec(walk, idx, field):
                arr = getattr(walk.st, field)
                return np.where(idx >= 0, arr[np.maximum(idx, 0)], 0)

            # count_topo never resets the counts: the CURRENT record's
            # values are used even without a fresh read, and the
            # conditional stream needs no position/allele match at all
            t_ok = (
                (t_idx >= 0)
                & (rec(tgt, t_idx, "bp") == pos)
                & (rec(tgt, t_idx, "anc") == anc_c[rows])
                & (rec(tgt, t_idx, "der") == der_c[rows])
            )
            r_ok = (
                (r_idx >= 0)
                & (rec(ref, r_idx, "bp") == pos)
                & (rec(ref, r_idx, "anc") == anc_c[rows])
                & (rec(ref, r_idx, "der") == der_c[rows])
            )
            t_daf = rec(tgt, t_idx, "daf")
            t_n = t_daf + rec(tgt, t_idx, "aaf")
            r_daf = rec(ref, r_idx, "daf")
            r_n = r_daf + rec(ref, r_idx, "aaf")
            c_daf = rec(cond, c_idx, "daf")
            c_n = c_daf + rec(cond, c_idx, "aaf")
            active = t_ok & r_ok & (c_n > 0) & (t_n > 0) & (r_n > 0) & (c_daf > 0)

            for k in np.nonzero(active)[0]:
                d1 = np.float32(rng.uniform01_scalar())
                d2 = np.float32(rng.uniform01_scalar())
                ft = t_daf[k] / t_n[k]
                fr = r_daf[k] / r_n[k]
                fc = c_daf[k] / c_n[k]
                mrow = rows[k]
                if d1 <= ft and d2 > fr:
                    os_.write(
                        f"{chrom} {pos[k]} {mt.age_begin[mrow]:g} "
                        f"{mt.age_end[mrow]:g} 1 {fc:g}\n"
                    )
                elif d1 > ft and d2 <= fr:
                    os_.write(
                        f"{chrom} {pos[k]} {mt.age_begin[mrow]:g} "
                        f"{mt.age_end[mrow]:g} -1 {-fc:g}\n"
                    )
    print(f"count_topo -> {args.output}", file=sys.stderr)
    return 0
