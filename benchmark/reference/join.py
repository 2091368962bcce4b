"""Colate's ``parse_tmptmp`` join (coal/coal.cpp:2071-2321), in numpy.

A ``.mut`` row is considered only when it is not flipped, maps to exactly
one branch, has ``age_begin < age_end`` and valid alleles (the ancestral
one of ``ACGT0``, the derived one of ``ACGT1``).  The reference stream's
cursor advances, over records with ``bp < pos``, only for considered rows,
and a row matches only when that advance consumed at least one record and
landed on ``(pos, anc, der)`` with a derived count above 0.  The target
stream's cursor advances only for rows the reference matched; the row is
kept when the target's record matches and its allele count is above 0.
Blocks are 30 Mb, numbered on from the last block of the previous
chromosome that kept a site.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK_BP = 30_000_000


@dataclasses.dataclass
class Stream:
    """A ``.colate.in`` stream in file order: per record its chromosome
    run (``starts`` [R+1] into the records, ``names`` [R]), position, the
    two allele codes and the two allele counts."""

    starts: np.ndarray
    names: list
    bp: np.ndarray
    anc: np.ndarray
    der: np.ndarray
    aaf: np.ndarray
    daf: np.ndarray

    def __len__(self) -> int:
        return int(self.bp.shape[0])


@dataclasses.dataclass
class MutRows:
    """One chromosome's ``.mut`` columns that the join reads."""

    pos: np.ndarray
    age_begin: np.ndarray
    age_end: np.ndarray
    flipped: np.ndarray
    num_branches: np.ndarray
    anc: np.ndarray      # uint8 code of the ancestral allele's letter
    der: np.ndarray
    valid: np.ndarray    # the mutation type is exactly "X/Y", X in ACGT0, Y in ACGT1


@dataclasses.dataclass
class Sites:
    age_begin: np.ndarray
    age_end: np.ndarray
    w_shared: np.ndarray
    w_notshared: np.ndarray
    block: np.ndarray
    num_blocks: int

    def __len__(self) -> int:
        return int(self.age_begin.shape[0])


class _Cursor:
    """The last record a stream's reader consumed (-1: none yet)."""

    def __init__(self, stream: Stream):
        self.s = stream
        self.consumed = -1
        self.chrom = None

    def segment(self, chrom: str) -> tuple[int, int]:
        """Records [lo, hi) of ``chrom`` from the cursor on.  Moving to a new
        chromosome consumes records until one of it is current."""
        st, n = self.s, len(self.s)
        if self.chrom != chrom:
            j = self.consumed + 1
            r = int(np.searchsorted(st.starts, j, side="right")) - 1 if j < n else len(st.names)
            while r < len(st.names) and st.names[r] != chrom:
                r += 1
            self.chrom = chrom
            if r >= len(st.names):
                self.consumed = n
                return n, n
            self.consumed = max(j, int(st.starts[r]))
        lo = max(self.consumed, 0)
        if lo >= n:
            return n, n
        r = int(np.searchsorted(st.starts, lo, side="right")) - 1
        return lo, (int(st.starts[r + 1]) if st.names[r] == chrom else lo)

    def match(self, chrom: str, pos, anc, der):
        """(matched, aaf, daf) of rows at nondecreasing ``pos``."""
        lo, hi = self.segment(chrom)
        st = self.s
        ok = np.zeros(pos.shape[0], bool)
        aaf = np.zeros(pos.shape[0], np.int64)
        daf = np.zeros(pos.shape[0], np.int64)
        if pos.shape[0] == 0 or lo >= hi:
            return ok, aaf, daf
        bp = st.bp[lo:hi]
        s = np.searchsorted(bp, pos, side="left")       # the record each row reads up to
        before = np.maximum.accumulate(np.concatenate([[0], s[:-1]]))
        inside = s < hi - lo
        i = np.where(inside, s, 0)
        ok = ((s > before) & inside & (bp[i] == pos) & (st.anc[lo:hi][i] == anc)
              & (st.der[lo:hi][i] == der))
        aaf = np.where(ok, st.aaf[lo:hi][i], 0).astype(np.int64)
        daf = np.where(ok, st.daf[lo:hi][i], 0).astype(np.int64)
        last = int(s.max())
        if last >= hi - lo:              # read on into the next chromosome's first record
            self.consumed = hi
            self.chrom = st.names[int(np.searchsorted(st.starts, hi, side="right")) - 1] \
                if hi < len(st) else self.chrom
        else:
            self.consumed = lo + last
        return ok, aaf, daf


def join(chroms: list, muts: list, target: Stream, reference: Stream) -> Sites:
    """The accepted sites of the chromosomes ``chroms`` (``muts`` their rows)."""
    tc, rc = _Cursor(target), _Cursor(reference)
    out = {k: [] for k in ("ab", "ae", "ws", "wn", "blk")}
    offset = 0
    for chrom, m in zip(chroms, muts):
        keep = ((m.flipped == 0) & (m.num_branches == 1) & (m.age_begin < m.age_end)
                & (m.age_end >= 0.0) & m.valid)
        rows = np.flatnonzero(keep)
        pos, anc, der = m.pos[rows], m.anc[rows], m.der[rows]
        r_ok, r_aaf, r_daf = rc.match(chrom, pos, anc, der)
        r_sel = np.flatnonzero(r_ok & (r_daf > 0))
        t_ok, t_aaf, t_daf = tc.match(chrom, pos[r_sel], anc[r_sel], der[r_sel])
        n_t = t_aaf + t_daf
        t_ok &= n_t > 0
        sel = r_sel[t_ok]
        last_blk = 0
        if sel.size:
            n_ref = (r_aaf + r_daf)[sel].astype(np.float64)
            d_ref = r_daf[sel].astype(np.float64)
            half = n_t[t_ok] / 2.0
            # the reference stores the quotient as a float, then rounds half away from 0
            f_d = np.floor((t_daf[t_ok] / half).astype(np.float32).astype(np.float64) + 0.5)
            f_a = np.floor((t_aaf[t_ok] / half).astype(np.float32).astype(np.float64) + 0.5)
            mrow = rows[sel]
            blk = np.maximum((m.pos[mrow] - 1) // BLOCK_BP, 0)
            out["ab"].append(np.maximum(m.age_begin[mrow], 0.0))
            out["ae"].append(m.age_end[mrow])
            out["ws"].append(f_d * d_ref / n_ref)
            out["wn"].append(f_a * d_ref / n_ref)
            out["blk"].append(blk + offset)
            last_blk = int(blk[-1])
        offset += last_blk + 1
    cat = lambda k, dt: np.concatenate(out[k]).astype(dt) if out[k] else np.zeros(0, dt)
    return Sites(cat("ab", np.float64), cat("ae", np.float64), cat("ws", np.float64),
                 cat("wn", np.float64), cat("blk", np.int64), offset)
