"""Analytic age-bin histograms: the CUDA kernel, its plain torch version,
and the packing of the site stream they read.

Port of colate_tpu/ops/bin_pallas.py.  Both compute the exact expectation
of the reference's 100-draw Monte Carlo binning (coal/coal.cpp:2244-2298)
per 30 Mb block, as colate_tpu/pipeline/binning.py:_chunk_hist does:
float32 per site and per 512-site chunk, float64 per block.

- :func:`pack_sites` lays the site stream out on the host as the kernel
  reads it: chunks of 512 sites that never straddle a block (the plan of
  ``colate_tpu.ops.bin_pallas.segments``), four float32 columns and one
  int32 ``meta`` column per site, and the block of each chunk as an int32.
  The float64-exact pieces stay on the host as in the reference: the emp
  flag ``age_begin <= age`` and the emp bin of ``age_end``.
- :func:`bin_chunks` runs the CUDA kernel ``csrc/bin_hist.cu`` on CUDA
  tensors and :func:`bin_chunks_reference` on CPU tensors.
- :func:`bin_chunks_reference` is plain torch: the per-chunk [4, 185]
  float32 partials (:func:`chunk_partials`), then the fixed-order float64
  per-block reduction (:func:`block_sums`).

Nothing is converted between the two packages: the binning has no learned
state, and its inputs (colate_tpu's ``JoinedSites`` and
``config.age_bin_edges()``) are shared as they are.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from colate_tpu.config import NUM_AGE_BINS, age_bin_edges
from colate_tpu.ops.bin_pallas import _C as CHUNK, segments
from colate_tpu.pipeline.binning import MAX_BLOCKS

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
    b.lib.bin_hist_f32.argtypes = [P, P, P, L, L, P, ctypes.c_float, P, P, I, P, P, P]
    b.lib.bin_hist_error_string.restype = ctypes.c_char_p
    b.lib.bin_hist_error_string.argtypes = [I]
    for name in ("bin_hist_chunk", "bin_hist_nbins"):
        getattr(b.lib, name).restype = I
        getattr(b.lib, name).argtypes = []
    if (b.lib.bin_hist_chunk(), b.lib.bin_hist_nbins()) != (CHUNK, NUM_AGE_BINS):
        raise RuntimeError("bin_hist.cu was built for another chunk width or bin count")
    return b


@dataclasses.dataclass
class Packed:
    """A site stream packed block-aligned, as :func:`pack_sites` makes it."""

    fv: torch.Tensor            # [4, n_packed] f32: age_begin, age_end, w_shared, w_notshared
    meta: torch.Tensor          # [n_packed] i32: EMP | bin2 on emp sites, else 0
    chunk_n: torch.Tensor       # [n_chunks] i32: real sites of each chunk (the rest is padding)
    chunk_blk: torch.Tensor     # [n_chunks] i32: each chunk's block
    block_chunks: torch.Tensor  # [n_chunks] i32: chunk ids grouped by block, in packed order
    block_off: torch.Tensor     # [num_blocks + 1] i32: each block's range in block_chunks
    num_blocks: int
    age: float

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_n.shape[0])

    def to(self, device) -> "Packed":
        move = lambda x: x.to(device)
        return dataclasses.replace(
            self, fv=move(self.fv), meta=move(self.meta), chunk_n=move(self.chunk_n),
            chunk_blk=move(self.chunk_blk), block_chunks=move(self.block_chunks),
            block_off=move(self.block_off),
        )


def pack_sites(sites, age: float = 0.0) -> Packed:
    """The block-aligned packed stream of ``sites`` (a colate_tpu
    ``JoinedSites``), as CPU tensors.  Pad lanes read age_begin 1,
    age_end 2 and zero weight, and are regular sites.  Raises past
    MAX_BLOCKS blocks, as colate_tpu.pipeline.binning._block_bucket."""
    nb = int(sites.num_blocks)
    if nb > MAX_BLOCKS:
        raise ValueError(f"num_blocks={nb} exceeds MAX_BLOCKS={MAX_BLOCKS}")
    n = len(sites)
    blk = np.asarray(sites.block_id, np.int64)
    if n and (blk.min() < 0 or blk.max() >= nb):
        raise ValueError(f"block ids span [{blk.min()}, {blk.max()}], outside {nb} blocks")
    starts, ends, poff, blkseg = segments(blk)
    n_packed = int(poff[-1])
    n_chunks = n_packed // CHUNK

    # site i of run r lands at poff[r] + (i - starts[r])
    lens = ends - starts
    dest = np.arange(n, dtype=np.int64) + np.repeat(poff[:-1] - starts, lens)
    fv = np.zeros((4, n_packed), np.float32)
    fv[0] = 1.0
    fv[1] = 2.0
    ab64 = np.asarray(sites.age_begin, np.float64)
    ae64 = np.asarray(sites.age_end, np.float64)
    for row, col in enumerate((ab64, ae64, sites.w_shared, sites.w_notshared)):
        fv[row, dest] = col

    # float64-exact on the host: the emp flag and bin(age_end) of emp sites
    # (bin_pallas.py:_fill_cols, binning.py:166-180)
    meta = np.zeros(n_packed, np.int32)
    emp = ab64 <= age
    if emp.any():
        ae_e = ae64[emp]
        with np.errstate(divide="ignore"):
            b2 = np.floor(np.log(np.maximum(10.0 * ae_e, 1e-300)) * 10.0 + 0.5) + 1
        b2 = np.clip(np.where(ae_e > 0, b2, 0), 0, NUM_AGE_BINS - 1).astype(np.int32)
        meta[dest[emp]] = EMP + b2

    per_run = (poff[1:] - poff[:-1]) // CHUNK
    chunk_blk = np.repeat(blkseg, per_run).astype(np.int32)
    first = np.repeat(poff[:-1] // CHUNK, per_run)
    chunk_n = np.minimum(np.repeat(lens, per_run) - (np.arange(n_chunks) - first) * CHUNK, CHUNK)
    block_chunks = np.argsort(chunk_blk, kind="stable").astype(np.int32)
    block_off = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(chunk_blk, minlength=nb), out=block_off[1:])
    t = torch.from_numpy
    return Packed(
        fv=t(fv), meta=t(meta), chunk_n=t(chunk_n.astype(np.int32)), chunk_blk=t(chunk_blk),
        block_chunks=t(block_chunks), block_off=t(block_off.astype(np.int32)),
        num_blocks=nb, age=float(age),
    )


@functools.lru_cache(maxsize=4)
def _edges(device: str) -> torch.Tensor:
    """The 186 bin edges in float32, as the TPU kernel reads them."""
    return torch.as_tensor(age_bin_edges().astype(np.float32), device=device)


def chunk_partials(packed: Packed) -> torch.Tensor:
    """Per-chunk [n_chunks, 4, 185] float32 partial histograms in plain
    torch, the kernel's first pass (bin_pallas.py:89-152).  Reads the real
    lanes of each chunk (its first ``chunk_n``) and adds their [4, 185]
    terms into the chunk's partial in site order with ``index_add_``; pad
    lanes, which would add exact zeros, are skipped as the kernel skips
    them.  Works through 2^19 sites at a time on a card and 4096 on the
    CPU, to bound the [sites, 185] intermediates."""
    dev = packed.fv.device
    sites_per_step = 1 << 19 if dev.type == "cuda" else 4096
    edges = _edges(str(dev))
    elo, ehi = edges[:-1], edges[1:]
    age = torch.tensor(np.float32(packed.age), device=dev)
    last = torch.arange(NUM_AGE_BINS, device=dev) == NUM_AGE_BINS - 1
    bins = torch.arange(NUM_AGE_BINS, dtype=torch.int32, device=dev)
    zero = torch.zeros((), device=dev)

    # packed position and chunk of every real lane
    chunk_n = packed.chunk_n.long()
    chunk_of = torch.repeat_interleave(torch.arange(packed.n_chunks, device=dev), chunk_n)
    first = torch.cumsum(chunk_n, 0) - chunk_n
    lane = torch.arange(chunk_of.shape[0], device=dev) - first[chunk_of]
    pos = chunk_of * CHUNK + lane

    out = torch.zeros((packed.n_chunks, 4 * NUM_AGE_BINS), dtype=torch.float32, device=dev)
    for i0 in range(0, pos.shape[0], sites_per_step):
        at = pos[i0 : i0 + sites_per_step]
        ab, ae, ws, wn = packed.fv[:, at].unsqueeze(-1).unbind(0)  # [G, 1]
        meta = packed.meta[at].unsqueeze(-1)
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
    return out.reshape(packed.n_chunks, 4, NUM_AGE_BINS)


def block_sums(packed: Packed, partials: torch.Tensor) -> torch.Tensor:
    """[num_blocks, 4, 185] float64: each block's chunk partials summed in
    packed order, the kernel's second pass.  On the CPU ``index_add_``
    adds in index order, so a block's sums depend only on its own chunks;
    on the card it may add in another order."""
    out = torch.zeros(
        (packed.num_blocks, 4 * NUM_AGE_BINS), dtype=torch.float64, device=partials.device
    )
    out.index_add_(0, packed.chunk_blk.long(), partials.reshape(-1, 4 * NUM_AGE_BINS).double())
    return out.reshape(packed.num_blocks, 4, NUM_AGE_BINS)


def bin_chunks_reference(packed: Packed) -> torch.Tensor:
    """The four per-block histograms [num_blocks, 4, 185] float64 in plain
    torch, computing what the CUDA kernel computes."""
    return block_sums(packed, chunk_partials(packed))


def bin_chunks(packed: Packed) -> torch.Tensor:
    """The four per-block histograms [num_blocks, 4, 185] float64 of a
    packed stream: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors; any other device raises."""
    global launches
    dev = packed.fv.device
    if dev.type == "cpu":
        return bin_chunks_reference(packed)
    if dev.type != "cuda":
        raise ValueError(f"bin_chunks: no kernel for device {dev}")
    for name in ("meta", "chunk_n", "chunk_blk", "block_chunks", "block_off"):
        x = getattr(packed, name)
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"bin_chunks: {name} must be contiguous int32 on {dev}")
    if packed.fv.dtype != torch.float32 or not packed.fv.is_contiguous():
        raise ValueError("bin_chunks: fv must be contiguous float32")
    n_chunks, nb = packed.n_chunks, packed.num_blocks
    if packed.fv.shape != (4, n_chunks * CHUNK) or packed.block_off.shape != (nb + 1,):
        raise ValueError("bin_chunks: packed tensors of inconsistent shapes")
    if n_chunks == 0:
        return torch.zeros((nb, 4, NUM_AGE_BINS), dtype=torch.float64, device=dev)
    lib = kernel_library().lib
    partial = torch.empty((n_chunks, 4, NUM_AGE_BINS), dtype=torch.float32, device=dev)
    out = torch.empty((nb, 4, NUM_AGE_BINS), dtype=torch.float64, device=dev)
    p = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        err = lib.bin_hist_f32(
            p(packed.fv), p(packed.meta), p(packed.chunk_n), n_chunks, n_chunks * CHUNK,
            p(_edges(str(dev))), float(np.float32(packed.age)), p(packed.block_chunks),
            p(packed.block_off), nb, p(partial), p(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"bin_hist_f32 launch failed: {lib.bin_hist_error_string(err).decode()}")
    launches += 1
    return out
