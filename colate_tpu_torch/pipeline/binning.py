"""Site evidence to per-block age-bin histograms.

Three binnings of the sites of mode ``mut``, copied from or standing for
colate_tpu/pipeline/binning.py:

- :func:`bin_sites_analytic` bins on a torch device: the host lays the
  site stream out (ops/bin_kernel.py:site_stream, in page-locked memory
  for a card), copies it to ``device`` once, and the device bins it, with
  the CUDA kernel on a card and its plain torch version on the CPU.  The
  reference's slab streaming and pooled, pre-faulted pack buffers worked
  around a ~30 ms cost per host-to-device transfer of the TPU host and
  are not carried over.
- :func:`bin_sites_analytic_native`: the host C++ binning in float64.
- :func:`bin_sites_mc_parity`: the bit-exact replay of the reference's
  100-draw Monte Carlo binning (libstdc++ mt19937, see hostrng.py);
  :class:`GrowableBlockHists` holds the histograms that the single-BCF
  join fills site by site under that replay (pipeline/join_vcf.py).

Semantics shared by all (coal.cpp:2244-2298):
- sites with age_begin <= age (==0 for tmp inputs) route their *shared*
  mass into the empirical matrix row keyed by bin(age_end) and their
  *notshared* mass both into that matrix and into the notshared
  histogram (ages drawn over [0, age_end], draws below `age` clamped);
- other sites add shared and notshared mass at the same sampled-age bin,
  with out-of-table draws rejected and redrawn.
Each returns four float64 [num_blocks, num_age_bins] arrays (shared,
notshared, shared_emp, notshared_emp).
"""

from __future__ import annotations

import numpy as np

from colate_tpu_torch._torch import torch
from colate_tpu_torch.config import (
    AGE_BIN_C,
    NUM_AGE_BINS,
    NUM_MC_SAMPLES,
    age_bin_edges,
    bin_of_age,
)
from colate_tpu_torch.hostrng import MT19937
from colate_tpu_torch.pipeline.join import JoinedSites
from colate_tpu_torch.utils.progress import StageTimer

# Loud upper bound on the block axis (the reference allocates 500 fixed
# blocks and silently overruns past them, coal.cpp:3141 — we fail loudly
# instead); 30 Mb blocks put a whole human genome at ~120 blocks.
MAX_BLOCKS = 65536


def bin_sites_analytic(sites: JoinedSites, age: float = 0.0, device: str | torch.device = "cuda",
                       recorder: StageTimer | None = None):
    """The four histograms of ``sites``, binned on ``device``.  Raises past
    MAX_BLOCKS blocks, as the reference does.  Into ``recorder`` go the
    stages ``bin_prep`` (the host lays the site stream out) and
    ``bin_device`` (its copy to the device, the binning and the copy back)
    and the counters ``sites_binned``, ``bin_chunks`` and ``bin_h2d_bytes``
    (the stream's bytes, which a card is sent)."""
    from colate_tpu_torch.ops.bin_kernel import bin_chunks, site_stream

    st = StageTimer() if recorder is None else recorder
    device = torch.device(device)
    with st.stage("bin_prep"):
        stream = site_stream(sites, age, pin=device.type == "cuda")
    with st.stage("bin_device"):
        hists = bin_chunks(stream.to(device)).cpu().numpy()
    st.count("sites_binned", stream.n_sites)
    st.count("bin_chunks", stream.n_chunks)
    st.count("bin_h2d_bytes", stream.nbytes)
    return tuple(np.ascontiguousarray(hists[:, j]) for j in range(4))


def bin_sites_device(sites: JoinedSites, age: float, device: str | torch.device) -> torch.Tensor:
    """The histograms [num_blocks, 4, 185] float64 of ``sites`` as a tensor
    on ``device``: the binning of :func:`bin_sites_analytic` before its
    copy back, queued on the device without waiting for it."""
    from colate_tpu_torch.ops.bin_kernel import bin_chunks, site_stream

    device = torch.device(device)
    return bin_chunks(site_stream(sites, age, pin=device.type == "cuda").to(device))


def bin_sites_analytic_native(sites: JoinedSites, age: float = 0.0):
    """Native (C++) analytic binning: O(sites) range-adds + prefix sums,
    exact f64 (io.cpp:cn_bin_analytic).  Raises when the native library
    cannot be built or loaded."""
    import ctypes

    from colate_tpu_torch import native

    lib = native.load()
    nb = sites.num_blocks
    n = len(sites)
    nbins = NUM_AGE_BINS
    edges = np.ascontiguousarray(age_bin_edges())
    ab = np.ascontiguousarray(sites.age_begin, np.float64)
    ae = np.ascontiguousarray(sites.age_end, np.float64)
    ws = np.ascontiguousarray(sites.w_shared, np.float64)
    wn = np.ascontiguousarray(sites.w_notshared, np.float64)
    blk = np.ascontiguousarray(sites.block_id, np.int32)
    outs = [np.zeros((max(nb, 1), nbins), np.float64) for _ in range(4)]
    p = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_bin_analytic(
        n, p(ab), p(ae), p(ws), p(wn), p(blk), max(nb, 1), nbins, p(edges),
        float(age), AGE_BIN_C, *[p(o) for o in outs]
    )
    return tuple(o[:nb] for o in outs)


class GrowableBlockHists:
    """Four [blocks, nbins] block-histogram accumulators that grow on
    demand — no fixed block cap (a 30 Mb-block genome of any size fits).

    Iterating yields the four current arrays (shared, notshared,
    shared_emp, notshared_emp), so callers that unpack a 4-tuple work
    unchanged; callers that know the upcoming block range call
    :meth:`ensure` first."""

    def __init__(self, nbins: int = NUM_AGE_BINS, initial_blocks: int = 512):
        self.arrays = [
            np.zeros((initial_blocks, nbins), np.float64) for _ in range(4)
        ]

    def ensure(self, blocks: int) -> None:
        cur = self.arrays[0].shape[0]
        if blocks <= cur:
            return
        grow = max(blocks, 2 * cur)
        self.arrays = [
            np.concatenate([a, np.zeros((grow - cur, a.shape[1]))])
            for a in self.arrays
        ]

    def __iter__(self):
        return iter(self.arrays)


def mc_bin_site(
    shared, notshared, shared_emp, notshared_emp,
    blk: int, ab: float, ae: float, ws: float, wn: float,
    rng: MT19937, age: float = 0.0,
    ws_mc: float | None = None, wn_mc: float | None = None,
) -> None:
    """Replay the reference's per-site sampling (coal.cpp:2244-2298) into
    preallocated [>=blk+1, num_age_bins] histograms, consuming `rng` in
    the reference's exact order.

    ws_mc/wn_mc are the per-draw weights in the reference's exact fp
    grouping x*DAF_ref/(N_ref*100.0); they default to ws/100 (one extra
    rounding — only visible under exact cancellation)."""
    nbins = NUM_AGE_BINS
    if ws_mc is None:
        ws_mc = ws / NUM_MC_SAMPLES
    if wn_mc is None:
        wn_mc = wn / NUM_MC_SAMPLES
    if ab <= age:
        bin2 = int(bin_of_age(ae))
        shared_emp[blk, bin2] += ws
        notshared_emp[blk, bin2] += wn
        # 100 unconditional draws over [ab, ae] (ab<=age), clamped up to age
        u = rng.uniform01(NUM_MC_SAMPLES)
        t = u * (ae - ab) + ab
        t = np.maximum(t, age)
        b = bin_of_age(t)
        np.add.at(notshared[blk], b, wn_mc)
    else:
        accepted = 0
        while accepted < NUM_MC_SAMPLES:
            u = rng.uniform01(NUM_MC_SAMPLES - accepted)
            t = u * (ae - ab) + ab
            with np.errstate(divide="ignore"):
                raw_bin = (
                    np.floor(np.log(10.0 * np.maximum(t, 1e-300)) * 10.0 + 0.5)
                ).astype(np.int64) + 1
            raw_bin = np.where(t > 0, np.maximum(raw_bin, 0), 0)
            keep = (t >= age) & (raw_bin < nbins)
            b = raw_bin[keep]
            np.add.at(shared[blk], b, ws_mc)
            np.add.at(notshared[blk], b, wn_mc)
            accepted += int(keep.sum())


def bin_sites_mc_parity(sites: JoinedSites, rng: MT19937, age: float = 0.0):
    """Bit-exact replay of the reference's sampling loop (coal.cpp:2244-2298).

    Draw order: sites in genome order; per site 100 uniforms (with
    rejection-redraw for out-of-table bins in the non-emp branch).
    Returns the same four [num_blocks, num_age_bins] float64 arrays.
    """
    nb = sites.num_blocks
    nbins = NUM_AGE_BINS
    shared = np.zeros((nb, nbins), np.float64)
    notshared = np.zeros((nb, nbins), np.float64)
    shared_emp = np.zeros((nb, nbins), np.float64)
    notshared_emp = np.zeros((nb, nbins), np.float64)

    ws_mc, wn_mc = sites.mc_weights()
    for i in range(len(sites)):
        mc_bin_site(
            shared, notshared, shared_emp, notshared_emp,
            int(sites.block_id[i]), sites.age_begin[i], sites.age_end[i],
            sites.w_shared[i], sites.w_notshared[i], rng, age,
            ws_mc=ws_mc[i], wn_mc=wn_mc[i],
        )
    return shared, notshared, shared_emp, notshared_emp
