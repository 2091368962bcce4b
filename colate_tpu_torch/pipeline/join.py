"""Join ``.mut`` mutation tables against target/reference site streams.

Replicates, vectorised, the exact sequential-cursor semantics of the
reference's ``parse_tmptmp`` (coal/coal.cpp:2071-2321):

- a mutation row is considered only if flipped==0, exactly one mapped
  branch, age_begin < age_end, age_end >= age(=0 in tmp mode), both
  alleles valid (A/C/G/T or 0/1) and any masks read 'P' at the site;
- the reference stream cursor advances (reading records while bp < pos)
  only for rows surviving those filters, and a row matches only if the
  advance *consumed at least one record* and landed on (chrom,pos,anc,der)
  with DAF_ref > 0 — so e.g. a second mutation row at the same position
  can never match (the record was already consumed);
- the target cursor advances only for rows that matched the reference
  stream; the row is kept if the target record matches and N_target > 0.

The cursor walk is the native library's (``native/io.cpp``); the rows
are filtered here, vectorised.  The output is a columnar
:class:`JoinedSites` ready for binning.  Copied from
colate_tpu/pipeline/join.py without its numpy cursor walk: a failed
native load raises instead of falling back.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from colate_tpu_torch.config import AGE_BIN_C, NUM_AGE_BINS, NUM_BASES_PER_BLOCK, age_bin_edges
from colate_tpu_torch.formats.colate_in import SiteStream
from colate_tpu_torch.formats.mut import MutTable

@dataclasses.dataclass
class JoinedSites:
    """Accepted sites with their histogram weights, concatenated over chroms."""

    age_begin: np.ndarray  # float64 (already max'ed with ref_age)
    age_end: np.ndarray  # float64
    w_shared: np.ndarray  # float64: f_DAF_target * DAF_ref / N_ref
    w_notshared: np.ndarray  # float64: f_AAF_target * DAF_ref / N_ref
    block_id: np.ndarray  # int32 global block index
    num_blocks: int
    # per-MC-draw weights with the reference's exact fp grouping
    # x*DAF_ref/(N_ref*100) — NOT (x*DAF_ref/N_ref)/100, which rounds
    # differently (bit-parity only; analytic binning uses w_* directly)
    w_shared_mc: np.ndarray | None = None
    w_notshared_mc: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.age_begin.shape[0])

    def mc_weights(self) -> tuple[np.ndarray, np.ndarray]:
        ws = self.w_shared_mc if self.w_shared_mc is not None else self.w_shared / 100.0
        wn = (
            self.w_notshared_mc
            if self.w_notshared_mc is not None
            else self.w_notshared / 100.0
        )
        return ws, wn


def join_tmptmp(
    chrom_names: list[str],
    mut_tables: list[MutTable],
    target: SiteStream,
    reference: SiteStream,
    target_masks: list[np.ndarray] | None = None,
    reference_masks: list[np.ndarray] | None = None,
    age: float = 0.0,
    ref_age: float = 0.0,
) -> JoinedSites:
    """The parse_tmptmp join, by the native C++ cursor walk.  NOTE: the
    reference forces age=ref_age=0 for tmp inputs (coal.cpp:2073-2074);
    callers pass 0 to match."""
    return _join_tmptmp_native(
        chrom_names, mut_tables, target, reference,
        target_masks, reference_masks, 0.0, 0.0,
    )


def _stream_ctypes(st: SiteStream):
    """(bp, anc, der, aaf, daf, n, name_blob, name_off, run_starts, nr)
    contiguous buffers for the native join."""
    starts, names = st.runs()
    blob = "".join(names).encode("ascii")
    name_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(n) for n in names], out=name_off[1:])
    return (
        np.ascontiguousarray(st.bp, np.int32),
        np.ascontiguousarray(st.anc, np.uint8),
        np.ascontiguousarray(st.der, np.uint8),
        np.ascontiguousarray(st.aaf, np.int32),
        np.ascontiguousarray(st.daf, np.int32),
        len(st),
        np.frombuffer(blob, np.uint8) if blob else np.zeros(0, np.uint8),
        name_off,
        np.ascontiguousarray(starts, np.int64),
        len(names),
    )


def _join_tmptmp_native(
    chrom_names, mut_tables, target, reference, target_masks,
    reference_masks, age, ref_age,
) -> JoinedSites:
    from colate_tpu_torch import native

    lib = native.load()

    # the reference's row filters per chromosome (coal.cpp:2150-2176),
    # vectorised, then concatenated
    pos_l, ab_l, ae_l, anc_l, der_l = [], [], [], [], []
    off = np.zeros(len(chrom_names) + 1, np.int64)
    for ci, mt in enumerate(mut_tables):
        anc_c, der_c, valid = allele_codes(mt)
        keep = (
            (mt.flipped == 0)
            & (mt.num_branches == 1)
            & (mt.age_begin < mt.age_end)
            & (mt.age_end >= age)
            & valid
        )
        if target_masks is not None and target_masks[ci] is not None:
            keep &= _mask_pass(target_masks[ci], mt.pos)
        if reference_masks is not None and reference_masks[ci] is not None:
            keep &= _mask_pass(reference_masks[ci], mt.pos)
        rows = np.nonzero(keep)[0]
        pos_l.append(mt.pos[rows].astype(np.int64))
        ab_l.append(np.ascontiguousarray(mt.age_begin[rows], np.float64))
        ae_l.append(np.ascontiguousarray(mt.age_end[rows], np.float64))
        anc_l.append(np.ascontiguousarray(anc_c[rows], np.uint8))
        der_l.append(np.ascontiguousarray(der_c[rows], np.uint8))
        off[ci + 1] = off[ci] + rows.shape[0]
    m_pos = np.concatenate(pos_l) if pos_l else np.zeros(0, np.int64)
    m_ab = np.concatenate(ab_l) if ab_l else np.zeros(0)
    m_ae = np.concatenate(ae_l) if ae_l else np.zeros(0)
    m_anc = np.concatenate(anc_l) if anc_l else np.zeros(0, np.uint8)
    m_der = np.concatenate(der_l) if der_l else np.zeros(0, np.uint8)

    cblob = "".join(chrom_names).encode("ascii")
    coff = np.zeros(len(chrom_names) + 1, np.int64)
    np.cumsum([len(c) for c in chrom_names], out=coff[1:])
    cblob_a = np.frombuffer(cblob, np.uint8) if cblob else np.zeros(0, np.uint8)

    t = _stream_ctypes(target)
    r = _stream_ctypes(reference)

    h = lib.cn_join_tmptmp(
        len(chrom_names), _pp(cblob_a), _pp(coff),
        _pp(off), _pp(m_pos), _pp(m_ab), _pp(m_ae), _pp(m_anc), _pp(m_der),
        _pp(t[0]), _pp(t[1]), _pp(t[2]), _pp(t[3]), _pp(t[4]), t[5],
        _pp(t[6]), _pp(t[7]), _pp(t[8]), t[9],
        _pp(r[0]), _pp(r[1]), _pp(r[2]), _pp(r[3]), _pp(r[4]), r[5],
        _pp(r[6]), _pp(r[7]), _pp(r[8]), r[9],
        float(ref_age), NUM_BASES_PER_BLOCK,
    )
    if not h:
        raise RuntimeError("cn_join_tmptmp failed")
    try:
        col = lambda c, dt: native.col_array(lib, lib.cn_join_col, h, c, dt)
        out = JoinedSites(
            age_begin=col(0, np.float64),
            age_end=col(1, np.float64),
            w_shared=col(2, np.float64),
            w_notshared=col(3, np.float64),
            block_id=col(6, np.int32),
            num_blocks=int(lib.cn_join_num_blocks(h)),
            w_shared_mc=col(4, np.float64),
            w_notshared_mc=col(5, np.float64),
        )
    finally:
        lib.cn_join_free(h)
    return out


def _pp(a):
    import ctypes

    return ctypes.c_void_p(a.ctypes.data) if isinstance(a, np.ndarray) else a


def _record_native(recorder, workers_counter: str, spans) -> None:
    """The native spans ``(workers, records)`` of
    ``native.span_records`` into ``recorder`` (a
    ``utils/progress.py:StageTimer``), with the worker count as
    ``workers_counter``."""
    from colate_tpu_torch.native import SPAN_KINDS

    workers, records = spans
    recorder.count(workers_counter, workers)
    for kind, chrom, part, worker, t0, t1, cpu, n0, n1 in records.tolist():
        name, c0, c1 = SPAN_KINDS[kind]
        args = {c0: n0, c1: n1}
        if chrom >= 0:
            args["chrom"] = chrom
        if part >= 0:
            args["part"] = part
        recorder.add_span(name, t0, t1, cpu_ns=cpu, worker=worker, args=args)


def mut_prefilter_native(
    mut_files: list[str],
    target_masks: list[np.ndarray] | None,
    reference_masks: list[np.ndarray] | None,
    age: float = 0.0,
    recorder=None,
):
    """Phase 1 of the fused tmp pipeline: parse + filter the .mut files
    (native, threaded, intra-file sharded).  Independent of the site
    streams, so callers overlap it with the .colate.in decode.  Returns
    an opaque handle for :func:`fused_tmptmp_stream`.  A ``recorder``
    (``StageTimer``) gets the native spans (``prefilter.chrom``, each
    chromosome's rows read and kept; ``prefilter.shard``, nested in it)
    and the counter ``prefilter_workers``.

    NOTE: tmp inputs force age=0 in the reference (parse_tmptmp,
    coal.cpp:2073-2074), so the row filter ignores the caller's age —
    same as :func:`join_tmptmp`."""
    import ctypes

    age = 0.0

    from colate_tpu_torch import native

    lib = native.load()

    pblob = "".join(mut_files).encode()
    poff = np.zeros(len(mut_files) + 1, np.int64)
    np.cumsum([len(f.encode()) for f in mut_files], out=poff[1:])
    pblob_a = np.frombuffer(pblob, np.uint8) if pblob else np.zeros(0, np.uint8)

    def mask_blob(masks):
        if masks is None or all(m is None for m in masks):
            return None, None
        parts = [
            np.zeros(0, np.uint8) if m is None else np.ascontiguousarray(m, np.uint8)
            for m in masks
        ]
        off = np.zeros(len(parts) + 1, np.int64)
        np.cumsum([p.shape[0] for p in parts], out=off[1:])
        blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return blob, off

    tm_blob, tm_off = mask_blob(target_masks)
    rm_blob, rm_off = mask_blob(reference_masks)
    errbuf = ctypes.create_string_buffer(512)
    # keep the blobs alive across the call
    h = lib.cn_mut_prefilter(
        len(mut_files), _pp(pblob_a), _pp(poff),
        _pp(tm_blob), _pp(tm_off), _pp(rm_blob), _pp(rm_off),
        float(age), errbuf, len(errbuf),
    )
    if not h:
        raise FileNotFoundError(errbuf.value.decode() or "cn_mut_prefilter failed")
    if recorder is not None:
        # read now: fused_tmptmp_stream frees the handle
        _record_native(recorder, "prefilter_workers",
                       native.span_records(lib.cn_prefilter_spans, h))
    return h


def fused_tmptmp_stream(
    prefilter,
    chrom_names: list[str],
    target_path: str,
    reference_path: str,
    age: float = 0.0,
    ref_age: float = 0.0,
    recorder=None,
):
    """Streaming phase 2: join + bin straight from the two ``.colate.in``
    FILES, one chromosome run at a time — peak memory is a single
    chromosome's columns per stream, not the whole genome (the reference
    also streams, coal.cpp:2125-2145).  Consumes the prefilter handle.
    Returns (histograms, num_sites, num_blocks); raises on I/O errors.
    A ``recorder`` (``StageTimer``) gets the native spans
    (``join_bin.scan`` of each file, ``join_bin.join`` and
    ``join_bin.bin`` of each chromosome, with its sites) and the counter
    ``join_bin_workers``.

    Equivalent to read_colate_in + join_tmptmp + native binning when
    chromosome names are unique in file order (the run reader applies the
    cursor walk's first-match-after-previous rule)."""
    import ctypes

    from colate_tpu_torch import native

    age = 0.0  # tmp inputs force age=0 (coal.cpp:2073-2074)
    ref_age = 0.0

    lib = native.load()
    blob = "".join(chrom_names).encode()
    off = np.zeros(len(chrom_names) + 1, np.int64)
    np.cumsum([len(c.encode()) for c in chrom_names], out=off[1:])
    blob_a = np.frombuffer(blob, np.uint8) if blob else np.zeros(0, np.uint8)
    edges = np.ascontiguousarray(age_bin_edges())
    errbuf = ctypes.create_string_buffer(512)
    h = lib.cn_tmptmp_fused_stream(
        prefilter, target_path.encode(), reference_path.encode(),
        _pp(blob_a), _pp(off), float(ref_age), NUM_BASES_PER_BLOCK,
        NUM_AGE_BINS, _pp(edges), float(age), AGE_BIN_C, errbuf, len(errbuf),
    )
    if not h:
        raise RuntimeError(
            errbuf.value.decode() or "cn_tmptmp_fused_stream failed"
        )
    try:
        if recorder is not None:
            _record_native(recorder, "join_bin_workers", native.span_records(lib.cn_fused_spans, h))
        num_blocks = int(lib.cn_fused_num_blocks(h))
        num_sites = int(lib.cn_fused_num_sites(h))
        hists = tuple(
            native.col_array(lib, lib.cn_fused_hist, h, i, np.float64).reshape(
                num_blocks, NUM_AGE_BINS
            )
            for i in range(4)
        )
    finally:
        lib.cn_fused_free(h)
    return hists, num_sites, num_blocks


def allele_codes(mt) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(anc uint8, der uint8, valid bool) for a MutTable, using the
    native reader's precomputed codes when present."""
    if mt.anc_code is not None:
        return mt.anc_code, mt.der_code, mt.allele_valid
    return _allele_codes(mt.mutation_type)


def _allele_codes(mutation_type: np.ndarray):
    """Split 'A/C'-style strings into uint8 codes + validity mask.

    The reference validates the full '/'-separated substrings against
    single characters (coal.cpp:2170-2171), so a row is valid iff the
    string is exactly 'X/Y' with X in ACGT0 and Y in ACGT1 — checkable
    on a fixed-width byte view without any per-row Python.
    """
    as_bytes = np.asarray(mutation_type, dtype="S4")
    padded = np.zeros((as_bytes.shape[0], 4), np.uint8)
    view = as_bytes.view(np.uint8).reshape(as_bytes.shape[0], -1)
    padded[:, : view.shape[1]] = view[:, :4]
    b0, b1, b2, b3 = padded[:, 0], padded[:, 1], padded[:, 2], padded[:, 3]
    anc_ok = np.isin(b0, np.frombuffer(b"ACGT0", np.uint8))
    der_ok = np.isin(b2, np.frombuffer(b"ACGT1", np.uint8))
    # exactly 3 chars: S4 keeps a NUL terminator for them; longer strings
    # (invalid anyway) truncate to 4 bytes with b3 != 0
    lengths = np.char.str_len(np.asarray(mutation_type, dtype="U8"))
    valid = anc_ok & der_ok & (b1 == ord("/")) & (b3 == 0) & (lengths == 3)
    anc = np.where(valid, b0, 0).astype(np.uint8)
    der = np.where(valid, b2, 0).astype(np.uint8)
    return anc, der, valid


def _mask_pass(mask: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """'P' at pos-1 required, but only when pos < len(mask) (coal.cpp:2163-2168)."""
    n = mask.shape[0]
    idx = np.clip(pos - 1, 0, max(n - 1, 0))
    in_range = pos < n
    is_p = mask[idx] == ord("P") if n else np.zeros(pos.shape, bool)
    return ~in_range | is_p
