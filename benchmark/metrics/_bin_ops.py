"""The binning kernel's operations and bytes: a frozen copy of
chip_smoke.py's ``bin_ranges``, ``bin_ops`` and the byte count of its
binning bound (the peaks and ``bound_s`` are ``_em_ops``'s).

Float32 operations of the binning as csrc/bin_hist.cu computes it, over
the bins whose terms a site needs: an FMA is two, an add, subtraction or
division one.  Bytes: the site stream and its chunk table
(colate_tpu_torch/ops/bin_kernel.py:site_stream) and the edges read
once, each block's four float64 histograms written once.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.binning import NUM_AGE_BINS, age_bin_edges

# a regular site, per bin: the overlap's subtraction and its add into the
# normaliser s, then the overlap again, the division by s and two FMAs
# into the shared and notshared histograms
BIN_OPS_REG = 8
# an emp site, per bin: the CDF at the bin's upper edge (a subtraction and
# a division), ch - cl and an FMA; per site: the width, the CDF at the
# first edge, the two one-hot adds; in the last bin, 1 - ch and its add
BIN_OPS_EMP = 5
BIN_OPS_EMP_SITE = 5
BIN_OPS_EMP_LAST = 2

CHUNK = 512             # sites a chunk, of one same-block run
SEG = 8                 # chunks a segment, of one block
SITE_BYTES = 4 * 4 + 4  # four float32 columns and an int32 meta word
CHUNK_BYTES = 8 + 4 + 4  # chunk_start (int64), chunk_n, block_chunks (int32)


def bin_ranges(sites, age: float):
    """Per site, the emp flag and the first and last bin whose term the
    dense formula makes non-zero, found as csrc/bin_hist.cu finds them:
    float32 comparisons against the float32 edges, an empty range as
    last < first.  A regular site's range is exactly the bins whose
    overlap with [max(age_begin, age), age_end] is positive; an emp
    site's runs from the bin below the first edge above max(age,
    age_begin) to the bin below the first edge above age where the CDF
    reaches 1 (through the last bin when it never does)."""
    e = age_bin_edges().astype(np.float32)
    age32 = np.float32(age)
    ab = np.asarray(sites.age_begin, np.float32)
    ae = np.asarray(sites.age_end, np.float32)
    emp = np.asarray(sites.age_begin, np.float64) <= age
    top = NUM_AGE_BINS - 1
    lo = np.maximum(np.searchsorted(e, np.maximum(ab, age32), "right") - 1, 0)
    hi = np.minimum(np.searchsorted(e, ae, "left") - 1, top)
    hi = np.where(ae > np.maximum(ab, age32), hi, lo - 1)
    i = np.flatnonzero(emp)
    if i.size:
        a, w = ab[i], np.maximum(ae[i] - ab[i], np.float32(1e-30))
        e_inf = np.append(e, np.float32(np.inf))

        def done(j):  # the kernel's test: CDF 1 from edge j on
            x = e_inf[np.minimum(j, e.size)]
            return (j >= 0) & (x > age32) & (x - a >= w)

        c = np.searchsorted(e, ae[i], "left")  # a guess, moved to the first j done
        while (m := (c > 0) & done(c - 1)).any():
            c = c - m
        while (m := ~done(c)).any():
            c = c + m
        lo[i] = np.minimum(lo[i], top)
        hi[i] = np.minimum(c, NUM_AGE_BINS) - 1
    return emp, lo, hi


def bin_ops(sites, age: float) -> float:
    """Float32 operations of the binning of ``sites`` at ``age``, over the
    bins each site's terms need (bin_ranges), branch by branch.  The
    float64 sums of the chunk partials (740 a chunk) are left out."""
    emp, lo, hi = bin_ranges(sites, age)
    n = np.maximum(hi - lo + 1, 0).astype(np.float64)
    last = (hi == NUM_AGE_BINS - 1) & (n > 0)
    return float(BIN_OPS_REG * n[~emp].sum() + BIN_OPS_EMP * n[emp].sum()
                 + BIN_OPS_EMP_SITE * emp.sum() + BIN_OPS_EMP_LAST * (last & emp).sum())


def bin_bytes(block, num_blocks: int) -> float:
    """Bytes of a binning of sites with these nondecreasing block ids: the
    site columns, the chunk table (chunks of up to CHUNK sites of one
    same-block run, segments of up to SEG chunks of one block) and the
    186 float32 edges read once, the [num_blocks, 4, 185] float64
    histograms written once."""
    blk = np.asarray(block, np.int64)
    n = blk.size
    if n:
        first = np.concatenate([[0], np.flatnonzero(np.diff(blk)) + 1])
        per_run = -(-np.diff(np.append(first, n)) // CHUNK)
        per_block = np.bincount(blk[first], weights=per_run, minlength=num_blocks)
    else:
        per_run = per_block = np.zeros(0, np.int64)
    n_chunks = int(per_run.sum())
    n_segs = int((-(-per_block.astype(np.int64) // SEG)).sum())
    stream = SITE_BYTES * n + CHUNK_BYTES * n_chunks + 4 * (n_segs + 1) + 4 * (num_blocks + 1)
    return float(stream + (NUM_AGE_BINS + 1) * 4 + num_blocks * 4 * NUM_AGE_BINS * 8)
