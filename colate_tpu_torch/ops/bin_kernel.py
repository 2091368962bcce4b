"""Analytic age-bin histograms: the CUDA kernel, its plain torch version,
and the layout of the site stream they read.

Port of colate_tpu/ops/bin_pallas.py.  Both compute the exact expectation
of the reference's 100-draw Monte Carlo binning (coal/coal.cpp:2244-2298)
per 30 Mb block, as colate_tpu/pipeline/binning.py:_chunk_hist does:
float32 per site and per 512-site chunk, float64 per block.

- :func:`site_stream` lays the site stream out on the host as the kernel
  reads it: the unpadded site columns in stream order (four float32 rows
  and an int32 ``meta`` word per site) and the chunk table of
  :func:`chunk_table`.  The float64-exact pieces stay on the host as in
  the reference: the emp flag ``age_begin <= age`` and the emp bin of
  ``age_end``.
- :func:`bin_chunks` runs the CUDA kernel ``csrc/bin_hist.cu`` on CUDA
  tensors and :func:`bin_chunks_reference` on CPU tensors.
- :func:`bin_chunks_reference` is plain torch: the per-chunk [4, 185]
  float32 partials (:func:`chunk_partials`), then the float64 per-block
  sums (:func:`block_sums`).

The binning has no learned state: its inputs are the port's
``JoinedSites`` and ``config.age_bin_edges()``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np

from colate_tpu_torch._torch import torch
from colate_tpu_torch.config import NUM_AGE_BINS, age_bin_edges
from colate_tpu_torch.pipeline.binning import MAX_BLOCKS

# sites per chunk (colate_tpu/ops/bin_pallas.py:_C)
CHUNK = 512
# chunks per segment, the run of one block's chunks a CTA of the kernel walks
SEG = 8
# meta column: EMP | bin(age_end) on an emp site, 0 on a regular site
EMP = 1024

# kernel launches made by bin_chunks (read by chip_smoke.py to show that a
# run went through the kernel)
launches = 0


@functools.cache
def kernel_library():
    """The built ``bin_hist`` library (compiled at first use)."""
    from colate_tpu_torch._build import build

    b = build("bin_hist.cu")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    b.lib.bin_hist_f32.restype = I
    b.lib.bin_hist_f32.argtypes = [P, L, P, P, P, P, P, I, P, I, P, ctypes.c_float, P, P, P]
    b.lib.bin_hist_error_string.restype = ctypes.c_char_p
    b.lib.bin_hist_error_string.argtypes = [I]
    for name in ("bin_hist_chunk", "bin_hist_seg", "bin_hist_nbins"):
        getattr(b.lib, name).restype = I
        getattr(b.lib, name).argtypes = []
    built = (b.lib.bin_hist_chunk(), b.lib.bin_hist_seg(), b.lib.bin_hist_nbins())
    if built != (CHUNK, SEG, NUM_AGE_BINS):
        raise RuntimeError("bin_hist.cu was built for another chunk, segment or bin count")
    return b


def chunk_table(block_id, num_blocks: int) -> dict:
    """The chunks and segments of a site stream with these block ids.

    A chunk is up to CHUNK consecutive sites of one same-block run; runs
    restart the chunking, so no chunk straddles a block.  A segment is up
    to SEG consecutive chunks of one block's chunk list (its chunks in
    stream order), so its bounds depend on that block's sites alone.
    Returns numpy arrays:

    - ``chunk_start`` [n_chunks] int64, ``chunk_n`` [n_chunks] int32:
      each chunk's first site and site count, chunks in stream order;
    - ``chunk_blk`` [n_chunks] int32: each chunk's block;
    - ``block_chunks`` [n_chunks] int32: chunk ids grouped by block, each
      block's in stream order;
    - ``seg_first`` [n_segs + 1] int32: segment s is
      ``block_chunks[seg_first[s]:seg_first[s + 1]]``, segments grouped
      by block;
    - ``block_seg`` [num_blocks + 1] int32: block b's segments are
      ``block_seg[b]:block_seg[b + 1]``.
    """
    blk = np.asarray(block_id)
    n = blk.size
    if n:
        # ids lie in [0, MAX_BLOCKS): an int32 diff cannot overflow
        cut = np.flatnonzero(np.diff(blk.astype(np.int32, copy=False))) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [n]])
    else:
        starts = ends = np.zeros(0, np.int64)
    per_run = -(-(ends - starts) // CHUNK)
    n_chunks = int(per_run.sum())
    run_of = np.repeat(np.arange(starts.size), per_run)
    first = np.cumsum(per_run) - per_run
    chunk_start = (starts[run_of] + (np.arange(n_chunks) - first[run_of]) * CHUNK).astype(np.int64)
    chunk_n = np.minimum(ends[run_of] - chunk_start, CHUNK).astype(np.int32)
    chunk_blk = blk[starts][run_of].astype(np.int32)

    block_chunks = np.argsort(chunk_blk, kind="stable").astype(np.int32)
    per_block = np.bincount(chunk_blk, minlength=num_blocks)
    block_first = np.cumsum(per_block) - per_block
    segs = -(-per_block // SEG)
    block_seg = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(segs, out=block_seg[1:])
    n_segs = int(block_seg[-1])
    seg_blk = np.repeat(np.arange(num_blocks), segs)
    seg_first = np.full(n_segs + 1, n_chunks, np.int64)
    seg_first[:-1] = block_first[seg_blk] + (np.arange(n_segs) - block_seg[seg_blk]) * SEG
    return dict(
        chunk_start=chunk_start, chunk_n=chunk_n, chunk_blk=chunk_blk,
        block_chunks=block_chunks, seg_first=seg_first.astype(np.int32),
        block_seg=block_seg.astype(np.int32),
    )


@dataclasses.dataclass
class SiteStream:
    """A site stream laid out for the kernel, as :func:`site_stream` makes it."""

    fv: torch.Tensor            # [4, n] f32: age_begin, age_end, w_shared, w_notshared
    meta: torch.Tensor          # [n] i32: EMP | bin2 on emp sites, else 0
    chunk_start: torch.Tensor   # [n_chunks] i64 (chunk_table)
    chunk_n: torch.Tensor       # [n_chunks] i32
    chunk_blk: torch.Tensor     # [n_chunks] i32
    block_chunks: torch.Tensor  # [n_chunks] i32
    seg_first: torch.Tensor     # [n_segs + 1] i32
    block_seg: torch.Tensor     # [num_blocks + 1] i32
    num_blocks: int
    age: float

    TABLE = ("chunk_start", "chunk_n", "chunk_blk", "block_chunks", "seg_first", "block_seg")

    @property
    def n_sites(self) -> int:
        return int(self.fv.shape[1])

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_n.shape[0])

    @property
    def n_segs(self) -> int:
        return int(self.seg_first.shape[0]) - 1

    @property
    def nbytes(self) -> int:
        """Bytes of the site columns and the chunk table."""
        return sum(getattr(self, name).nbytes for name in ("fv", "meta", *self.TABLE))

    def to(self, device) -> "SiteStream":
        """The stream on ``device``; the copies are asynchronous from
        pinned memory."""
        move = lambda x: x.to(device, non_blocking=True)
        return dataclasses.replace(
            self, fv=move(self.fv), meta=move(self.meta),
            **{name: move(getattr(self, name)) for name in self.TABLE},
        )


def site_stream(sites, age: float = 0.0, pin: bool = False) -> SiteStream:
    """The stream of ``sites`` (a ``JoinedSites``) as CPU tensors, in
    page-locked memory when ``pin``.  Raises past MAX_BLOCKS blocks, as
    colate_tpu.pipeline.binning._block_bucket."""
    nb = int(sites.num_blocks)
    if nb > MAX_BLOCKS:
        raise ValueError(f"num_blocks={nb} exceeds MAX_BLOCKS={MAX_BLOCKS}")
    n = len(sites)
    blk = np.asarray(sites.block_id)
    if n and (blk.min() < 0 or blk.max() >= nb):
        raise ValueError(f"block ids span [{blk.min()}, {blk.max()}], outside {nb} blocks")
    table = chunk_table(blk, nb)

    fv = torch.empty((4, n), dtype=torch.float32, pin_memory=pin)
    ab64 = np.asarray(sites.age_begin, np.float64)
    for row, col in enumerate((ab64, sites.age_end, sites.w_shared, sites.w_notshared)):
        fv[row].copy_(torch.from_numpy(np.asarray(col, np.float64)))

    # float64-exact on the host: the emp flag and bin(age_end) of emp sites
    # (bin_pallas.py:_fill_cols, binning.py:166-180)
    meta = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
    emp = np.flatnonzero(ab64 <= age)
    if emp.size:
        ae_e = np.asarray(sites.age_end, np.float64)[emp]
        with np.errstate(divide="ignore"):
            b2 = np.floor(np.log(np.maximum(10.0 * ae_e, 1e-300)) * 10.0 + 0.5) + 1
        b2 = np.clip(np.where(ae_e > 0, b2, 0), 0, NUM_AGE_BINS - 1).astype(np.int32)
        meta.numpy()[emp] = EMP + b2
    return SiteStream(
        fv=fv, meta=meta, **{name: torch.from_numpy(table[name]) for name in SiteStream.TABLE},
        num_blocks=nb, age=float(age),
    )


@functools.lru_cache(maxsize=4)
def _edges(device: str) -> torch.Tensor:
    """The 186 bin edges in float32, as the TPU kernel reads them."""
    return torch.as_tensor(age_bin_edges().astype(np.float32), device=device)


def chunk_partials(stream: SiteStream) -> torch.Tensor:
    """Per-chunk [n_chunks, 4, 185] float32 partial histograms in plain
    torch (bin_pallas.py:89-152): the dense formula over all 185 bins,
    each chunk's sites' [4, 185] terms added into its partial in site
    order with ``index_add_``.  Works through 2^19 sites at a time on a
    card and 4096 on the CPU, to bound the [sites, 185] intermediates."""
    dev = stream.fv.device
    sites_per_step = 1 << 19 if dev.type == "cuda" else 4096
    edges = _edges(str(dev))
    elo, ehi = edges[:-1], edges[1:]
    age = torch.tensor(np.float32(stream.age), device=dev)
    last = torch.arange(NUM_AGE_BINS, device=dev) == NUM_AGE_BINS - 1
    bins = torch.arange(NUM_AGE_BINS, dtype=torch.int32, device=dev)
    zero = torch.zeros((), device=dev)

    # the site and chunk of every chunk's every site
    chunk_n = stream.chunk_n.long()
    chunk_of = torch.repeat_interleave(torch.arange(stream.n_chunks, device=dev), chunk_n)
    first = torch.cumsum(chunk_n, 0) - chunk_n
    pos = stream.chunk_start[chunk_of] + torch.arange(chunk_of.shape[0], device=dev) - first[chunk_of]

    out = torch.zeros((stream.n_chunks, 4 * NUM_AGE_BINS), dtype=torch.float32, device=dev)
    for i0 in range(0, pos.shape[0], sites_per_step):
        at = pos[i0 : i0 + sites_per_step]
        ab, ae, ws, wn = stream.fv[:, at].unsqueeze(-1).unbind(0)  # [G, 1]
        meta = stream.meta[at].unsqueeze(-1)
        emp = (meta & EMP) != 0
        bin2 = meta & (EMP - 1)

        # regular sites: U[max(ab, age), ae] conditional on the table
        ov = torch.clamp(torch.minimum(ae, ehi) - torch.maximum(torch.maximum(ab, age), elo), min=0.0)
        s = ov.sum(-1, keepdim=True)
        p = torch.where(s > 0, ov / torch.where(s > 0, s, 1.0), zero)
        # emp sites: the clamped-CDF law, mass beyond the table in the last bin
        width = torch.clamp(ae - ab, min=1e-30)
        cl = torch.where(elo > age, torch.clamp((elo - ab) / width, 0.0, 1.0), zero)
        ch = torch.where(ehi > age, torch.clamp((ehi - ab) / width, 0.0, 1.0), zero)
        p_emp = ch - cl + torch.where(last, 1.0 - ch[:, -1:], zero)
        oh2 = (bin2 == bins).to(torch.float32)

        w_s = torch.where(emp, zero, ws)
        w_nr = torch.where(emp, zero, wn)
        w_se = torch.where(emp, ws, zero)
        w_ne = torch.where(emp, wn, zero)
        terms = torch.cat([p * w_s, p * w_nr + p_emp * w_ne, oh2 * w_se, oh2 * w_ne], dim=1)
        out.index_add_(0, chunk_of[i0 : i0 + sites_per_step], terms)
    return out.reshape(stream.n_chunks, 4, NUM_AGE_BINS)


def block_sums(stream: SiteStream, partials: torch.Tensor) -> torch.Tensor:
    """[num_blocks, 4, 185] float64: each block's chunk partials summed in
    float64.  On the CPU ``index_add_`` adds in chunk order, so a block's
    sums depend only on its own chunks; on the card it may add in another
    order."""
    out = torch.zeros(
        (stream.num_blocks, 4 * NUM_AGE_BINS), dtype=torch.float64, device=partials.device
    )
    out.index_add_(0, stream.chunk_blk.long(), partials.reshape(-1, 4 * NUM_AGE_BINS).double())
    return out.reshape(stream.num_blocks, 4, NUM_AGE_BINS)


def bin_chunks_reference(stream: SiteStream) -> torch.Tensor:
    """The four per-block histograms [num_blocks, 4, 185] float64 in plain
    torch, computing what the CUDA kernel computes."""
    return block_sums(stream, chunk_partials(stream))


def bin_chunks(stream: SiteStream) -> torch.Tensor:
    """The four per-block histograms [num_blocks, 4, 185] float64 of a
    site stream: the CUDA kernel for CUDA tensors, the plain torch version
    for CPU tensors; any other device raises."""
    global launches
    dev = stream.fv.device
    if dev.type == "cpu":
        return bin_chunks_reference(stream)
    if dev.type != "cuda":
        raise ValueError(f"bin_chunks: no kernel for device {dev}")
    want = dict(fv=torch.float32, meta=torch.int32, chunk_start=torch.int64)
    for name in ("fv", "meta", *SiteStream.TABLE):
        x = getattr(stream, name)
        dtype = want.get(name, torch.int32)
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"bin_chunks: {name} must be contiguous {dtype} on {dev}")
    n, n_chunks, n_segs, nb = stream.n_sites, stream.n_chunks, stream.n_segs, stream.num_blocks
    shapes = (stream.fv.shape, stream.meta.shape, stream.chunk_start.shape, stream.chunk_blk.shape,
              stream.block_chunks.shape, stream.block_seg.shape)
    if n_segs < 0 or shapes != ((4, n), (n,), (n_chunks,), (n_chunks,), (n_chunks,), (nb + 1,)):
        raise ValueError("bin_chunks: stream tensors of inconsistent shapes")
    if n_segs == 0:
        return torch.zeros((nb, 4, NUM_AGE_BINS), dtype=torch.float64, device=dev)
    lib = kernel_library().lib
    seg_out = torch.empty((n_segs, 4, NUM_AGE_BINS), dtype=torch.float64, device=dev)
    out = torch.empty((nb, 4, NUM_AGE_BINS), dtype=torch.float64, device=dev)
    p = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        err = lib.bin_hist_f32(
            p(stream.fv), n, p(stream.meta), p(stream.chunk_start), p(stream.chunk_n),
            p(stream.block_chunks), p(stream.seg_first), n_segs, p(stream.block_seg), nb,
            p(_edges(str(dev))), float(np.float32(stream.age)), p(seg_out), p(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"bin_hist_f32 launch failed: {lib.bin_hist_error_string(err).decode()}")
    launches += 1
    return out
