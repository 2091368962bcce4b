"""The native host library (C++, bound with ctypes): the columnar
``.mut``, ``.colate.in`` and ``.anc`` decoders, the fused prefilter, join
and analytic binning of mode ``mut``, the host f64 EM, the host walks of
modes ``tree`` and ``local_ancestry`` (node ages, children, the sorted
populate, the local-ancestry accumulation), the BCF2 decoder and the
streaming BAM/CRAM pileup of ``hts.cpp``, the CondCoalRates walks of
``cond.cpp`` (the analytic f64 prefix-sum walk and the f32 replay),
the threaded ``.colate_mat`` reader (``io.cpp:cn_colate_mat_read``) and
the ``.coal`` row formatter (``io.cpp:cn_coal_rows``).

The sources are the JAX package's ``native/`` C++, copied whole, and all
of them are built; ``io.cpp``'s fused prefilter and join+bin also time
themselves per chromosome, shard and worker (:func:`span_records`), and
``io.cpp`` adds the ``.colate_mat`` reader, which the JAX package does
with ``np.loadtxt``, and the ``.coal`` formatter, which it does with
Python's ``f"{x:g}"``.  The library is built with ``g++`` at first use into
``colate_tpu_torch/_build/`` under a name keyed by a hash of the sources
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  The build writes a temporary file and renames it into place,
under a lock, so processes that load together all see a whole library.  A failed build or load raises,
naming the library's path; nothing falls back to Python decoders.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

SOURCES = ("io.cpp", "em.cpp", "hts.cpp", "la.cpp", "cond.cpp")
HEADERS = ("cram.hpp",)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")

_lib = None


def library_path(build_dir: str | None = None) -> str:
    """Where the library of the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_HERE, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(build_dir or BUILD_DIR, f"libcolate_io-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """Compile the sources into ``so``: into a temporary file first, then
    renamed into place, so a concurrent loader never sees a partial file."""
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, *(os.path.join(_HERE, s) for s in SOURCES), "-o", tmp, *LIBS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native library failed to build or load: {so}: {exc}") from exc
    if r.returncode != 0:
        raise RuntimeError(
            f"native library failed to build or load: {so}: g++ exited "
            f"{r.returncode}:\n{r.stderr[-4000:]}"
        )
    os.replace(tmp, so)


def load(so: str | None = None):
    """ctypes handle to the native library, built at first use.

    ``so`` loads that file instead of the build of the current sources,
    and never builds it.  Raises RuntimeError naming the path when the
    build or the load fails; a later call tries again."""
    global _lib
    if so is None and _lib is not None:
        return _lib
    path = so or library_path()
    if so is None and not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # one process builds; the others wait
            if not os.path.exists(path):
                _build(path)
    try:
        lib = ctypes.CDLL(path)
    except OSError as exc:
        raise RuntimeError(f"native library failed to build or load: {path}: {exc}") from exc
    _declare(lib)
    if so is None:
        _lib = lib
    return lib


def _declare(lib) -> None:
    """Argument and result types of the entry points the port calls."""
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
    col = [P, I, ctypes.POINTER(L)]
    lib.cn_mut_read.restype = P
    lib.cn_mut_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p, I]
    lib.cn_mut_n.restype = L
    lib.cn_mut_n.argtypes = [P]
    lib.cn_mut_col.restype = P
    lib.cn_mut_col.argtypes = col
    lib.cn_mut_free.argtypes = [P]
    lib.cn_colatein_read.restype = P
    lib.cn_colatein_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p, I]
    lib.cn_colatein_n.restype = L
    lib.cn_colatein_n.argtypes = [P]
    lib.cn_colatein_col.restype = P
    lib.cn_colatein_col.argtypes = col
    lib.cn_colatein_free.argtypes = [P]
    lib.cn_join_tmptmp.restype = P
    lib.cn_join_tmptmp.argtypes = (
        [I, P, P]                     # n_chr, chrom blob, chrom offsets
        + [P] * 6                     # mut: off, pos, ab, ae, anc, der
        + [P] * 5 + [L] + [P] * 3 + [L]  # target
        + [P] * 5 + [L] + [P] * 3 + [L]  # reference
        + [D, L]                      # ref_age, bases per block
    )
    lib.cn_join_n.restype = L
    lib.cn_join_n.argtypes = [P]
    lib.cn_join_num_blocks.restype = L
    lib.cn_join_num_blocks.argtypes = [P]
    lib.cn_join_col.restype = P
    lib.cn_join_col.argtypes = col
    lib.cn_join_free.argtypes = [P]
    lib.cn_bin_analytic.restype = None
    lib.cn_bin_analytic.argtypes = (
        [L] + [P] * 5                 # n, ab, ae, ws, wn, blk
        + [L, I, P]                   # num_blocks, nbins, edges
        + [D, D]                      # age, bin C
        + [P] * 4                     # output histograms
    )
    lib.cn_mut_prefilter.restype = P
    lib.cn_mut_prefilter.argtypes = (
        [I, P, P]                     # n_chr, mut path blob+offsets
        + [P, P, P, P]                # tmask blob/off, rmask blob/off
        + [D]                         # age
        + [ctypes.c_char_p, I]        # errbuf
    )
    lib.cn_prefilter_free.argtypes = [P]
    lib.cn_prefilter_spans.restype = P
    lib.cn_prefilter_spans.argtypes = [P, ctypes.POINTER(L)]
    lib.cn_tmptmp_fused_stream.restype = P
    lib.cn_tmptmp_fused_stream.argtypes = (
        [P]                           # prefilter handle (consumed)
        + [ctypes.c_char_p, ctypes.c_char_p]  # target/reference paths
        + [P, P]                      # chrom name blob + offsets
        + [D, L]                      # ref_age, bases per block
        + [I, P]                      # nbins, edges
        + [D, D]                      # age, bin C
        + [ctypes.c_char_p, I]        # errbuf
    )
    lib.cn_fused_num_blocks.restype = L
    lib.cn_fused_num_blocks.argtypes = [P]
    lib.cn_fused_num_sites.restype = L
    lib.cn_fused_num_sites.argtypes = [P]
    lib.cn_fused_hist.restype = P
    lib.cn_fused_hist.argtypes = col
    lib.cn_fused_spans.restype = P
    lib.cn_fused_spans.argtypes = [P, ctypes.POINTER(L)]
    lib.cn_fused_free.argtypes = [P]
    lib.cn_em_run.restype = None
    lib.cn_em_run.argtypes = (
        [P, I, P]                     # epochs, E, init_rates
        + [P, P, I, I]                # sc, nc, B, nbins
        + [P, P]                      # t ages, k epoch indices
        + [I, I]                      # max_iter, min_iter
        + [D, D]                      # conv_ratio, rate_floor
        + [P, P, P]                   # out rates, logl, iters
    )
    lib.cn_anc_read.restype = P
    lib.cn_anc_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p, I, I]
    lib.cn_anc_n.restype = L
    lib.cn_anc_n.argtypes = [P]
    lib.cn_anc_nhap.restype = L
    lib.cn_anc_nhap.argtypes = [P]
    lib.cn_anc_col.restype = P
    lib.cn_anc_col.argtypes = col
    lib.cn_anc_free.argtypes = [P]
    lib.cn_tree_coords.restype = I
    lib.cn_tree_coords.argtypes = [L, L, L, P, P, P, P]  # T, M, N, parent, blen, ages|NULL, out
    lib.cn_children.restype = None
    lib.cn_children.argtypes = [L, L, P, P]               # T, M, parent, out [T, M, 2]
    lib.cn_tree_populate_sorted.restype = None
    lib.cn_tree_populate_sorted.argtypes = (
        [L, L, L]                     # T, K, N
        + [P, P, P, P]                # internal ages, spans, blocks, epochs
        + [L, L, ctypes.c_int32]      # E, blocks, threads
        + [P, P]                      # out num, den
    )
    lib.cn_la_accumulate.restype = None
    lib.cn_la_accumulate.argtypes = (
        [L] * 5                       # S, M, N, G, E
        + [P] * 8                     # parent, ages, lab, c1, c2, w, blocks, epochs
        + [L, ctypes.c_int32]         # blocks, threads
        + [P, P]                      # out num, den
    )
    lib.cn_cond_chrom.restype = None
    lib.cn_cond_chrom.argtypes = (
        [L] * 3                       # T, M, N
        + [P, P, P, P]                # parent, blen, factors, blocks
        + [P, L, P, L]                # focal, n, cond, n
        + [P, L]                      # group_of_hap, G
        + [P, L, P, L]                # epochs E, epochs_focal F
        + [P, P, P]                   # sample_ages|NULL, num, denom
    )
    lib.cn_cond_chrom_fast.restype = None
    lib.cn_cond_chrom_fast.argtypes = (
        [L] * 3                       # T, M, N
        + [P, P, P, P]                # parent, blen, factors, blocks
        + [P, L, P, L]                # focal, n, cond, n
        + [P, L]                      # group_of_hap, G
        + [P, L, P, L]                # epochs E, epochs_focal F
        + [P, P]                      # num, denom (f64)
    )
    lib.cn_bam_open.restype = P
    lib.cn_bam_open.argtypes = [ctypes.c_char_p, I, I, I, I, ctypes.c_char_p, I]
    lib.cn_bam_contig.restype = I
    lib.cn_bam_contig.argtypes = (
        [P, ctypes.c_char_p]
        + [P, L, P, L]                # ref, anc genomes
        + [P, L]                      # queries
        + [P, P, P, P]                # claimed, counts, coverage x2
        + [ctypes.c_char_p, I]        # errbuf
    )
    lib.cn_bam_close.argtypes = [P]
    lib.cn_bcf_read.restype = P
    lib.cn_bcf_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p, I]
    lib.cn_bcf_n.restype = L
    lib.cn_bcf_n.argtypes = [P]
    lib.cn_bcf_meta.restype = L
    lib.cn_bcf_meta.argtypes = [P, I]
    lib.cn_bcf_col.restype = P
    lib.cn_bcf_col.argtypes = col
    lib.cn_bcf_free.argtypes = [P]
    lib.cn_colate_mat_read.restype = I
    lib.cn_colate_mat_read.argtypes = (
        [ctypes.c_char_p, L, L]       # path, B, ncols
        + [P, P, P]                   # out ages, shared, notshared
        + [ctypes.POINTER(L)]         # row 0's width
        + [ctypes.c_char_p, I]        # errbuf
    )
    lib.cn_coal_rows.restype = L
    lib.cn_coal_rows.argtypes = (
        [P, L, L, L]                  # values [R, C] float64, R, C, first column
        + [P, P, L]                   # labels [R, 2] int64 or NULL, out, its capacity
    )


# the kinds of the fused parse's spans (io.cpp:SpanKind): the span's name
# and the names of its two counts
SPAN_KINDS = {
    0: ("prefilter.chrom", "rows_read", "rows_kept"),
    1: ("prefilter.shard", "rows_read", "rows_kept"),
    2: ("join_bin.scan", "records", "runs"),
    3: ("join_bin.join", "sites", "rows"),
    4: ("join_bin.bin", "sites", "blocks"),
}
SPAN_FIELDS = 9   # kind, chrom, part, worker, start_ns, end_ns, cpu_ns, n0, n1


def span_records(getter, handle) -> tuple[int, np.ndarray]:
    """(workers, records [n, SPAN_FIELDS] int64) of a handle's spans, copied
    out through ``getter`` (``cn_prefilter_spans`` or ``cn_fused_spans``)."""
    nb = ctypes.c_int64()
    ptr = getter(handle, ctypes.byref(nb))
    flat = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int64)),
                                 shape=(nb.value // 8,)).copy()
    return int(flat[0]), flat[1:].reshape(-1, SPAN_FIELDS)


def col_array(lib, getter, handle, col, dtype):
    """Copy native column ``col`` out as a numpy array of ``dtype``, with
    one memcpy straight out of the native buffer."""
    nb = ctypes.c_int64()
    ptr = getter(handle, col, ctypes.byref(nb))
    n = nb.value
    if n < 0:
        raise ValueError(f"bad native column id {col}")
    if n == 0:
        return np.zeros(0, dtype)
    src = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(n,))
    out = np.empty(n, np.uint8)
    np.copyto(out, src)
    return out.view(dtype)
