"""BAM/SAM alignment reader → in-memory record arrays (copied from
colate_tpu/formats/bam.py).  Mode ``mut`` and ``make_tmp`` stream BAM
and CRAM through the native pileup (models/bam_pileup.py:open_pileup);
this decoder serves the in-memory cursor of SAM text and of modes
``calc_depth``/``get_deam``.

Mirrors the subset of htslib the reference's ``bam_parser`` touches
(reference: include/vcf/htslib.{hpp,cpp}): for each record we need
contig name, 0-based leftmost position, read length (``l_qseq``),
sequence as IUPAC characters (``seq_nt16_str[bam_seqi(...)]``), raw
phred base qualities (``bam_get_qual``), mapping quality, and the
reverse-strand flag (``bam_is_rev``).  CIGAR is deliberately ignored —
the reference pileup aligns ``seq[i]`` to ``ref[pos+i]`` ungapped
(htslib.cpp:92-104).

Accepts the encodings ``hts_open`` auto-detects: plain SAM text,
gzip/bgzip SAM, and binary BAM (BGZF).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

# htslib's seq_nt16_str: 4-bit code → IUPAC character
_NT16 = "=ACMGRSVTWYHKDBN"


@dataclasses.dataclass
class BamRecords:
    """Column arrays over all alignments, in file order."""

    contig: np.ndarray  # object — contig name per record ("*" if unmapped)
    pos: np.ndarray  # int64, 0-based leftmost
    mapq: np.ndarray  # int32
    flag: np.ndarray  # int32 (bit 0x10 = reverse strand)
    seq: list  # list[str] — IUPAC upper-case sequence
    qual: list  # list[np.ndarray uint8] — raw phred scores

    def __len__(self) -> int:
        return int(self.pos.shape[0])


def read_bam(path: str) -> BamRecords:
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":
        raw = _gunzip_members(raw)
    if raw[:4] == b"BAM\x01":
        return _parse_bam(raw)
    return _parse_sam_text(raw.decode("utf-8", errors="replace"))


def _gunzip_members(raw: bytes) -> bytes:
    out = bytearray()
    d = zlib.decompressobj(31)
    buf = raw
    while buf:
        out += d.decompress(buf)
        buf = d.unused_data
        if not buf:
            break
        d = zlib.decompressobj(31)
    return bytes(out)


def _parse_sam_text(text: str) -> BamRecords:
    contigs, poss, mapqs, flags, seqs, quals = [], [], [], [], [], []
    for line in text.splitlines():
        if not line or line.startswith("@"):
            continue
        f = line.split("\t")
        if len(f) < 11:
            continue
        flags.append(int(f[1]))
        contigs.append(f[2])
        poss.append(int(f[3]) - 1)  # SAM is 1-based; aln->core.pos is 0-based
        mapqs.append(int(f[4]))
        # normalize through the nt16 table exactly like htslib does
        seqs.append("".join(_NT16[_nt16_code(c)] for c in f[9]))
        q = f[10]
        if q == "*":
            quals.append(np.full(len(f[9]), 0xFF, np.uint8))
        else:
            quals.append(np.frombuffer(q.encode(), np.uint8) - 33)
    return BamRecords(
        contig=np.array(contigs, object),
        pos=np.array(poss, np.int64),
        mapq=np.array(mapqs, np.int32),
        flag=np.array(flags, np.int32),
        seq=seqs,
        qual=quals,
    )


def _nt16_code(c: str) -> int:
    i = "=ACMGRSVTWYHKDBN".find(c.upper())
    return i if i >= 0 else 15  # unknown → N


def _parse_bam(data: bytes) -> BamRecords:
    mv = memoryview(data)
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        names.append(bytes(mv[off + 4 : off + 4 + l_name - 1]).decode())
        off += 4 + l_name + 4  # skip l_ref
    contigs, poss, mapqs, flags, seqs, quals = [], [], [], [], [], []
    n = len(data)
    nt16 = np.frombuffer(_NT16.encode(), np.uint8)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        if end > n:
            break
        ref_id, pos, l_rn_mq_bin, flag_nc, l_seq = struct.unpack_from(
            "<iiIIi", data, off
        )
        l_read_name = l_rn_mq_bin & 0xFF
        mapq = (l_rn_mq_bin >> 8) & 0xFF
        flag = flag_nc >> 16
        n_cigar = flag_nc & 0xFFFF
        p = off + 32 + l_read_name + 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(mv[p : p + nbytes], np.uint8)
        codes = np.empty(nbytes * 2, np.uint8)
        codes[0::2] = packed >> 4
        codes[1::2] = packed & 0x0F
        seqs.append(nt16[codes[:l_seq]].tobytes().decode())
        p += nbytes
        quals.append(np.frombuffer(mv[p : p + l_seq], np.uint8).copy())
        contigs.append(names[ref_id] if 0 <= ref_id < len(names) else "*")
        poss.append(pos)
        mapqs.append(mapq)
        flags.append(flag)
        off = end
    return BamRecords(
        contig=np.array(contigs, object),
        pos=np.array(poss, np.int64),
        mapq=np.array(mapqs, np.int32),
        flag=np.array(flags, np.int32),
        seq=seqs,
        qual=quals,
    )
