"""VCF/BCF genotype reader → columnar arrays.

Handles the three on-disk encodings htslib's ``bcf_open`` auto-detects
(the reference passes files named .bcf but htslib accepts any):
plain-text VCF, bgzip/gzip VCF, and binary BCF2 (BGZF-compressed).

Returns one :class:`VcfTable` per file: 1-based positions, REF/first-ALT
allele strings, and the GT matrix as int8 (allele index per haplotype,
-1 for missing — matching ``bcf_gt_allele`` which maps '.' to -1; the
reference then *subtracts* 1 per missing call when summing DAF, a quirk
its consumers replicate).

Copied from colate_tpu/formats/vcf.py without its pure-Python BCF2
parser: BCF2 is decoded by the native library (native/hts.cpp), whose
failure to build or load raises.  Only a file the native decoder answers
``not-bcf`` for (text or gzip VCF, whatever its name) takes the Python
text parser.
"""

from __future__ import annotations

import ctypes
import dataclasses
import zlib

import numpy as np

from colate_tpu_torch import native


@dataclasses.dataclass
class VcfTable:
    chrom: np.ndarray  # object (string per record)
    pos: np.ndarray  # int64, 1-based
    ref: np.ndarray  # object — REF allele string
    alt: np.ndarray  # object — first ALT string ("" when none)
    n_allele: np.ndarray  # int32
    gt: np.ndarray  # int8 [sites, n_samples*ploidy]; -1 = missing
    n_samples: int
    ploidy: int

    def __len__(self) -> int:
        return int(self.pos.shape[0])


def read_vcf(path: str) -> VcfTable:
    out = _read_bcf_native(path)
    if out is not None:
        return out
    return _parse_vcf_text(_read_raw(path).decode("utf-8", errors="replace"))


def _read_bcf_native(path: str) -> VcfTable | None:
    """Streaming native BCF decode (native/hts.cpp): bounded input memory,
    columnar output.  Returns None for text VCF (the Python parser handles
    it); raises when the native library cannot be built or loaded, or the
    file cannot be read."""
    lib = native.load()
    errbuf = ctypes.create_string_buffer(256)
    h = lib.cn_bcf_read(path.encode(), errbuf, len(errbuf))
    if not h:
        err = errbuf.value.decode()
        if err == "not-bcf":
            return None  # text VCF / gzip VCF: Python parser
        raise FileNotFoundError(err or f"cannot read {path}")
    try:
        n = int(lib.cn_bcf_n(h))
        n_samples = int(lib.cn_bcf_meta(h, 0))
        ploidy = int(lib.cn_bcf_meta(h, 1))
        width = int(lib.cn_bcf_meta(h, 2))
        col = lambda i, dt: native.col_array(lib, lib.cn_bcf_col, h, i, dt)
        pos = col(0, np.int64)
        n_allele = col(1, np.int32)
        chrom_id = col(2, np.int32)
        ref_blob = col(3, np.uint8).tobytes()
        ref_off = col(4, np.uint64)
        alt_blob = col(5, np.uint8).tobytes()
        alt_off = col(6, np.uint64)
        gt = col(7, np.int8).reshape(n, width) if width else np.zeros(
            (n, 0), np.int8
        )
        cname_blob = col(8, np.uint8).tobytes()
        cname_off = col(9, np.uint64)
        cname_idx = col(10, np.int64)
    finally:
        lib.cn_bcf_free(h)
    names = {
        int(cname_idx[i]): cname_blob[cname_off[i] : cname_off[i + 1]].decode()
        for i in range(cname_idx.shape[0])
    }
    chrom = np.array(
        [names.get(int(c), str(int(c))) for c in chrom_id], object
    )
    ref = np.array(
        [ref_blob[ref_off[i] : ref_off[i + 1]].decode() for i in range(n)],
        object,
    )
    alt = np.array(
        [alt_blob[alt_off[i] : alt_off[i + 1]].decode() for i in range(n)],
        object,
    )
    return VcfTable(
        chrom=chrom,
        pos=pos,
        ref=ref,
        alt=alt,
        n_allele=n_allele,
        gt=gt,
        n_samples=n_samples,
        ploidy=max(ploidy, 1),
    )


def _read_raw(path: str) -> bytes:
    with open(path, "rb") as fh:
        head = fh.read(2)
        fh.seek(0)
        raw = fh.read()
    if head == b"\x1f\x8b":
        # gzip or BGZF — members concatenate; zlib handles both
        out = bytearray()
        d = zlib.decompressobj(31)
        buf = raw
        while buf:
            out += d.decompress(buf)
            buf = d.unused_data
            if buf:
                d = zlib.decompressobj(31)
            else:
                break
        return bytes(out)
    return raw


def _parse_vcf_text(text: str) -> VcfTable:
    chroms, poss, refs, alts, nals, gts = [], [], [], [], [], []
    n_samples = 0
    ploidy = 2
    for line in text.splitlines():
        if not line or line.startswith("##"):
            continue
        if line.startswith("#CHROM"):
            n_samples = max(len(line.split("\t")) - 9, 0)
            continue
        f = line.split("\t")
        if len(f) < 8:
            f = line.split()
        chroms.append(f[0])
        poss.append(int(f[1]))
        refs.append(f[3])
        alt_field = f[4]
        alt_list = [] if alt_field in (".", "") else alt_field.split(",")
        alts.append(alt_list[0] if alt_list else "")
        nals.append(1 + len(alt_list))
        row: list[int] = []
        if len(f) > 9:
            fmt = f[8].split(":")
            gt_i = fmt.index("GT") if "GT" in fmt else -1
            for s in f[9:]:
                val = s.split(":")[gt_i] if gt_i >= 0 else "."
                calls = val.replace("|", "/").split("/")
                for c in calls:
                    row.append(-1 if c in (".", "") else int(c))
        gts.append(row)
    n = len(poss)
    if n and gts[0]:
        ploidy = len(gts[0]) // max(n_samples, 1) if n_samples else 2
    width = n_samples * ploidy
    gt = np.full((n, width), -1, np.int8)
    for i, row in enumerate(gts):
        m = min(len(row), width)
        gt[i, :m] = row[:m]
    return VcfTable(
        chrom=np.array(chroms, object),
        pos=np.array(poss, np.int64),
        ref=np.array(refs, object),
        alt=np.array(alts, object),
        n_allele=np.array(nals, np.int32),
        gt=gt,
        n_samples=n_samples,
        ploidy=ploidy,
    )
