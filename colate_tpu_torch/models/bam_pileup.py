"""BAM pileup cursor replicating the reference's ``bam_parser``.

Reference: include/vcf/htslib.{hpp,cpp}.  Semantics replicated exactly:

- per-read filters: mapq >= mapq_th, len >= len_th (htslib.cpp:61);
  base window [3, len-3) (htslib.cpp:68); base quality >= 30
  (bq_th, htslib.hpp:64); <= mismatch_th mismatches against the ref
  genome among quality bases, and at least one quality base
  (htslib.cpp:112/141);
- reads are treated as UNGAPPED: seq[i] aligns to ref[pos+i], CIGAR is
  never consulted (htslib.cpp:92-104);
- a position "has an entry" iff some mapq/len-passing read contributed
  a baseQ>=30 base there inside [3, len-3) and inside the ref genome
  (the pos_of_entry claim at htslib.cpp:100-104) — even when that read
  later fails the mismatch filter;
- allele counts accumulate only from mismatch-passing reads; with
  --strandfilter, forward-strand bases where ref or anc genome is 'C'
  and reverse-strand bases where ref or anc is 'G' are excluded
  (htslib.cpp:119);
- ``coverage`` sums read lengths of every contig-matching read
  consumed; ``coverage_after_filter`` of every mismatch-passing read;
- the streaming cursor consumes reads until ``pos - query >= 5e4``
  (num_entries/2, htslib.cpp:429-434) or the contig changes; a contig
  boundary read is re-processed under the next contig by
  ``assign_contig`` (htslib.cpp:537-575);
- contig match accepts the name or "chr"+name (htslib.cpp:394).

The circular buffer of the reference is replaced by flat per-contig
count arrays — exactly equivalent for the monotone queries all modes
issue (slots can only be reclaimed >=50kb behind the query horizon).

Copied from colate_tpu/models/bam_pileup.py.  :func:`open_pileup` gives
the in-memory :class:`BamCursor` only for a file the native decoder
answers ``not a BAM file`` for (SAM text, gzip SAM); a native library that
cannot be built or loaded, a file that cannot be opened and a bad CRAM
raise.
"""

from __future__ import annotations

import ctypes

import numpy as np

from colate_tpu_torch import native
from colate_tpu_torch.formats.bam import BamRecords, read_bam
from colate_tpu_torch.formats.fasta import read_fasta

_BASE_INDEX = np.full(256, -1, np.int8)
for _i, _b in enumerate("ACGT"):
    _BASE_INDEX[ord(_b)] = _i

# char → nt16 code (htslib seq_nt16_table; unknowns → N=15)
_NT16_CODE = np.full(256, 15, np.uint8)
for _i, _b in enumerate("=ACMGRSVTWYHKDBN"):
    _NT16_CODE[ord(_b)] = _i

NUM_ENTRIES = 100_000  # htslib.hpp:93


class BamCursor:
    def __init__(self, path: str, params: str = "20,30,10",
                 strandfilter: bool = False, preloaded: BamRecords | None = None):
        parts = params.split(",")
        self.mapq_th = int(parts[0])
        self.len_th = int(parts[1])
        self.mismatch_th = int(parts[2])
        self.bq_th = 30
        self.strandfilter = strandfilter
        self.rec = preloaded if preloaded is not None else read_bam(path)
        self.idx = 0  # next record to consume
        self.loaded = -1  # index of the record in the "aln" slot
        self.chr: str | None = None
        self.pos = 0
        self.contig = ""
        self.eof = False
        self.prev_pos = -1
        self.coverage = 0.0
        self.coverage_after_filter = 0.0
        self.ref = np.zeros(0, np.uint8)
        self.anc = np.zeros(0, np.uint8)
        self.counts = np.zeros((0, 4), np.int64)
        self.claimed = np.zeros(0, bool)

    # -- genome helpers ------------------------------------------------
    @staticmethod
    def _genome(path: str) -> np.ndarray:
        return np.frombuffer(read_fasta(path).encode(), np.uint8).copy()

    def _match(self, chrom: str | None) -> bool:
        return chrom is not None and (
            chrom == self.contig or chrom == "chr" + self.contig
        )

    # -- core read processing (htslib.cpp:60-169) ----------------------
    def _count_alleles_for_read(self, garbled_qual: bool = False) -> None:
        """garbled_qual replicates the assign_contig path, where the
        reference never reassigns q to bam_get_qual (htslib.cpp:549 vs
        406): the 'qualities' are the nt16-packed SEQ bytes, overrunning
        into the real qual array for offsets past (len+1)//2."""
        r = self.rec
        i = self.loaded
        length = len(r.seq[i])
        if r.mapq[i] < self.mapq_th or length < self.len_th:
            return
        start, end = 3, length - 3
        if end <= start:
            return
        gpos = self.pos + np.arange(start, end)
        n_in = int(np.searchsorted(gpos, self.ref.shape[0]))  # break at genome end
        if n_in == 0:
            return
        gpos = gpos[:n_in]
        if garbled_qual:
            q = self._garbled_qual(i)[start : start + n_in]
        else:
            q = r.qual[i][start : start + n_in]
        seq = np.frombuffer(r.seq[i].encode(), np.uint8)[start : start + n_in]
        quality = q >= self.bq_th
        total = int(quality.sum())
        if total:
            refb = self.ref[gpos]
            matching = int((quality & (refb == seq)).sum())
            self.claimed[gpos[quality]] = True
        else:
            matching = 0
        if total - matching <= self.mismatch_th and total > 0:
            self.coverage_after_filter += length
            use = quality
            if self.strandfilter:
                refb = self.ref[gpos]
                ancb = np.where(
                    gpos < self.anc.shape[0],
                    self.anc[np.minimum(gpos, max(self.anc.shape[0] - 1, 0))],
                    0,
                )
                if r.flag[i] & 0x10:  # reverse: exclude G sites
                    ok = (refb != ord("G")) & (ancb != ord("G"))
                else:  # forward: exclude C sites
                    ok = (refb != ord("C")) & (ancb != ord("C"))
                use = use & ok
            codes = _BASE_INDEX[seq]
            sel = use & (codes >= 0)
            np.add.at(self.counts, (gpos[sel], codes[sel]), 1)

    def _garbled_qual(self, i: int) -> np.ndarray:
        """bam_get_seq bytes followed by the real quals (bam1_t layout)."""
        seq = np.frombuffer(self.rec.seq[i].encode(), np.uint8)
        codes = _NT16_CODE[seq]
        if codes.shape[0] % 2:
            codes = np.append(codes, 0)
        packed = (codes[0::2] << 4) | codes[1::2]
        return np.concatenate([packed.astype(np.uint8), self.rec.qual[i]])

    def _process_loaded(self, garbled_qual: bool = False) -> None:
        """The contig-matching body of read_entry (htslib.cpp:391-423)."""
        r = self.rec
        i = self.loaded
        self._count_alleles_for_read(garbled_qual)
        if self.pos < self.prev_pos:
            raise RuntimeError("BAM file not sorted by position")
        self.prev_pos = int(self.pos)
        self.coverage += len(r.seq[i])

    def read_entry(self) -> bool:
        if self.idx >= len(self.rec):
            self.eof = True
            return False
        self.loaded = self.idx
        self.idx += 1
        self.pos = int(self.rec.pos[self.loaded])
        self.chr = str(self.rec.contig[self.loaded])
        if self._match(self.chr):
            self._process_loaded()
        return True

    # -- streaming to a query position (htslib.cpp:426-436) ------------
    def read_to_pos(self, current_pos: int) -> bool:
        if self._match(self.chr):
            if not self.eof and self.pos - current_pos < NUM_ENTRIES / 2.0:
                while self.read_entry():
                    if self.pos - current_pos >= NUM_ENTRIES / 2.0:
                        break
                    if not self._match(self.chr):
                        break
        return self.eof

    # -- per-contig reset (htslib.cpp:490-575) --------------------------
    def assign_contig(self, icontig: str, ref_path: str, anc_path: str = "") -> None:
        if icontig != "":
            self.contig = icontig
        self.ref = self._genome(ref_path)
        self.anc = self._genome(anc_path) if anc_path else np.zeros(0, np.uint8)
        if self.strandfilter and not anc_path:
            raise ValueError("strandfilter requires an ancestral genome")
        self.eof = False
        self.coverage = 0.0
        self.coverage_after_filter = 0.0
        self.prev_pos = -1
        self.counts = np.zeros((self.ref.shape[0], 4), np.int64)
        self.claimed = np.zeros(self.ref.shape[0], bool)
        ret = True
        if self.chr is None:
            ret = self._raw_read()
        while not self._match(self.chr) and ret:
            ret = self._raw_read()
        if ret:
            self.pos = int(self.rec.pos[self.loaded])
            self.chr = str(self.rec.contig[self.loaded])
            if self.contig == "":
                self.contig = self.chr
            self._process_loaded(garbled_qual=True)
        else:
            self.eof = True

    def _raw_read(self) -> bool:
        """sam_read1 without the read_entry processing (seek loop)."""
        if self.idx >= len(self.rec):
            return False
        self.loaded = self.idx
        self.idx += 1
        self.chr = str(self.rec.contig[self.loaded])
        return True

    # -- pileup queries -------------------------------------------------
    def entry_counts(self, bp: int):
        """counts[4] if position bp has a claimed entry, else None."""
        if 0 <= bp < self.claimed.shape[0] and self.claimed[bp]:
            return self.counts[bp]
        return None

    def drain_contig(self) -> None:
        """Process every remaining record of the current contig.

        Equivalent to issuing the mode-mut monotone ``read_to_pos``
        queries: a read can only touch positions >= its start + 3, and
        every read starting before ``query + 50k`` is consumed by the
        reference at query time, so the counts/claims at any queried
        position are identical whether the stream stops at the horizon
        or runs to the contig end (htslib.cpp:426-436).  Leaves the
        cursor on the first record of the next contig (unprocessed),
        exactly where the reference's horizon-limited walk +
        ``assign_contig`` seek would put it.
        """
        while not self.eof and self._match(self.chr):
            if not self.read_entry():
                break

    def counts_at(self, bps: np.ndarray):
        """Vectorised pileup lookup after :meth:`drain_contig`.

        Returns (claimed[n] bool, counts[n,4] int64) for 0-based
        positions ``bps`` (out-of-genome positions report unclaimed).
        """
        n = self.claimed.shape[0]
        idx = np.clip(bps, 0, max(n - 1, 0))
        ok = (bps >= 0) & (bps < n)
        if n == 0:
            return np.zeros(bps.shape, bool), np.zeros((bps.shape[0], 4), np.int64)
        claimed = np.where(ok, self.claimed[idx], False)
        counts = np.where(ok[:, None], self.counts[idx], 0)
        return claimed, counts

    # -- batch per-contig interface (shared with NativeBamPileup) -------
    def contig_counts(self, contig: str, ref_path: str, anc_path: str | None,
                      qpos0: np.ndarray):
        """assign_contig + full drain + counts_at in one call.

        Returns (claimed[n] bool, counts[n,4] int64, coverage,
        coverage_after_filter, ref_len) for 0-based positions qpos0."""
        self.assign_contig(contig, ref_path, anc_path or "")
        self.drain_contig()
        claimed, counts = self.counts_at(np.asarray(qpos0, np.int64))
        return (
            claimed, counts, self.coverage, self.coverage_after_filter,
            int(self.ref.shape[0]),
        )

    # -- deamination profile (htslib.cpp:440-486) ------------------------
    def read_deam(self, current_pos: int, stats: dict) -> bool:
        """stats holds 15-long int arrays: isC1/isC2/isCT1/isCT2/
        isCpG1/isCpG2/isCpGt1/isCpGt2.  The currently loaded read is NOT
        counted (only reads consumed by this loop are)."""
        if self._match(self.chr):
            if not self.eof and self.pos - current_pos < NUM_ENTRIES / 2.0:
                while self.read_entry():
                    if self.pos - current_pos >= NUM_ENTRIES / 2.0:
                        break
                    if not self._match(self.chr):
                        break
                    i = self.loaded
                    length = len(self.rec.seq[i])
                    if self.rec.mapq[i] < self.mapq_th or length < self.len_th:
                        continue
                    gpos = self.pos + np.arange(length)
                    n_in = int(np.searchsorted(gpos, self.ref.shape[0]))
                    if n_in == 0:
                        continue
                    gpos = gpos[:n_in]
                    seq = np.frombuffer(self.rec.seq[i].encode(), np.uint8)[:n_in]
                    refb = self.ref[gpos]
                    right = np.where(
                        gpos + 1 < self.ref.shape[0], self.ref[np.minimum(gpos + 1, self.ref.shape[0] - 1)], 0
                    )
                    left = np.where(gpos - 1 >= 0, self.ref[np.maximum(gpos - 1, 0)], 0)
                    isC = (refb == ord("C")) | (refb == ord("G"))
                    isCpG = ((refb == ord("C")) & (right == ord("G"))) | (
                        (refb == ord("G")) & (left == ord("C"))
                    )
                    deam = ((refb == ord("C")) & (seq == ord("T"))) | (
                        (refb == ord("G")) & (seq == ord("A"))
                    )
                    js = np.arange(n_in)
                    from_end = length - 1 - js
                    for name, lim, idxs in (
                        ("1", js < 15, js),
                        ("2", from_end < 15, from_end),
                    ):
                        m = isC & lim
                        np.add.at(stats["isC" + name], idxs[m], 1)
                        np.add.at(stats["isCT" + name], idxs[m & deam], 1)
                        np.add.at(stats["isCpG" + name], idxs[m & isCpG], 1)
                        np.add.at(stats["isCpGt" + name], idxs[m & isCpG & deam], 1)
        return self.eof


class NativeBamPileup:
    """Streaming native pileup cursor (native/hts.cpp).

    Same per-contig batch interface as :meth:`BamCursor.contig_counts`,
    but the BAM streams through a bounded-memory BGZF inflate + record
    parser and the pileup is accumulated only at the query positions —
    O(queries) state instead of the oracle's whole-contig count arrays,
    so multi-GB whole-genome BAMs run in bounded RSS (the reference
    achieves this with htslib's 1e5-slot circular buffer,
    include/vcf/htslib.hpp:93-95)."""

    def __init__(self, lib, handle, strandfilter: bool):
        self._lib = lib
        self._h = handle
        self._strand = strandfilter

    def close(self) -> None:
        if self._h:
            self._lib.cn_bam_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def contig_counts(self, contig: str, ref_path: str, anc_path: str | None,
                      qpos0: np.ndarray):
        if self._strand and not anc_path:
            raise ValueError("strandfilter requires an ancestral genome")
        ref = np.frombuffer(read_fasta(ref_path).encode(), np.uint8)
        anc = (
            np.frombuffer(read_fasta(anc_path).encode(), np.uint8)
            if anc_path
            else np.zeros(0, np.uint8)
        )
        q = np.ascontiguousarray(qpos0, np.int64)
        order = None
        if q.shape[0] and np.any(np.diff(q) < 0):
            order = np.argsort(q, kind="stable")
            q = np.ascontiguousarray(q[order])
        claimed = np.zeros(q.shape[0], np.uint8)
        counts = np.zeros((q.shape[0], 4), np.int32)
        cov = ctypes.c_double()
        cova = ctypes.c_double()
        errbuf = ctypes.create_string_buffer(256)
        p = lambda a: ctypes.c_void_p(a.ctypes.data)
        rc = self._lib.cn_bam_contig(
            self._h, contig.encode(), p(ref), ref.shape[0], p(anc),
            anc.shape[0], p(q), q.shape[0], p(claimed), p(counts),
            ctypes.byref(cov), ctypes.byref(cova), errbuf, len(errbuf),
        )
        if rc != 0:
            raise RuntimeError(errbuf.value.decode() or "BAM pileup failed")
        claimed_b = claimed.astype(bool)
        counts64 = counts.astype(np.int64)
        if order is not None:
            inv = np.empty_like(order)
            inv[order] = np.arange(order.shape[0])
            claimed_b = claimed_b[inv]
            counts64 = counts64[inv]
        return claimed_b, counts64, cov.value, cova.value, int(ref.shape[0])


# the native decoder's answer for input that is not BGZF BAM or CRAM
# (native/hts.cpp:407): SAM text or gzip SAM, which BamCursor decodes
NOT_BAM = "not a BAM file"


def open_pileup(path: str, params: str = "20,30,10",
                strandfilter: bool = False):
    """The streaming native pileup of a BAM or CRAM file, or the in-memory
    :class:`BamCursor` of a SAM text (or gzip SAM) file.  Raises when the
    native library cannot be built or loaded, and with the native message
    when the file cannot be opened or decoded."""
    lib = native.load()
    parts = params.split(",")
    errbuf = ctypes.create_string_buffer(256)
    h = lib.cn_bam_open(
        path.encode(), int(parts[0]), int(parts[1]), int(parts[2]),
        int(strandfilter), errbuf, len(errbuf),
    )
    if h:
        return NativeBamPileup(lib, h, strandfilter)
    err = errbuf.value.decode()
    if err.startswith(NOT_BAM):
        return BamCursor(path, params, strandfilter)
    if err.startswith("cannot open"):
        raise FileNotFoundError(f"{path}: {err}")
    raise ValueError(f"{path}: {err or 'cannot decode the alignment file'}")
