"""Synthetic site streams for the analytic binning, and the error measure
the binning tests hold them to.  Imports no JAX: chip_smoke.py and the card
tests use it on a machine without it."""

from __future__ import annotations

import numpy as np

from colate_tpu.pipeline.join import JoinedSites


def synthetic_sites(n=20000, nb=7, seed=0, age=0.0, sorted_blocks=True) -> JoinedSites:
    """tests/test_bin_pallas.py:_sites, with age_end kept above age_begin:
    at age > 0 its emp rows could end before they begin, and native
    ``cn_bin_analytic`` drops such sites while the device binnings keep
    them (ROADMAP queue 3).  At age 0 the sites are the same."""
    g = np.random.default_rng(seed)
    ab = np.exp(g.uniform(np.log(1e-1), np.log(1e4), n))
    ae = ab * np.exp(g.uniform(0.05, 2.0, n))
    emp = g.uniform(size=n) < 0.15
    ab[emp] = age  # emp rows: age_begin <= age
    ae = np.maximum(ae, ab + 1e-3)
    blocks = g.integers(0, nb, n)
    if sorted_blocks:
        blocks = np.sort(blocks)
    return JoinedSites(
        age_begin=ab, age_end=ae,
        w_shared=g.uniform(0, 2, n), w_notshared=g.uniform(0, 2, n),
        block_id=blocks.astype(np.int32), num_blocks=nb,
    )


def beyond_table_sites(n=2000, seed=9) -> JoinedSites:
    """Sites whose ages run past the last bin edge (~9.3e6 generations),
    30% of them emp, in 3 blocks."""
    g = np.random.default_rng(seed)
    ab = np.exp(g.uniform(np.log(1e5), np.log(5e7), n))
    ae = ab * np.exp(g.uniform(0.05, 2.0, n))
    ab[g.uniform(size=n) < 0.3] = 0.0
    return JoinedSites(
        age_begin=ab, age_end=ae, w_shared=g.uniform(0, 2, n), w_notshared=g.uniform(0, 2, n),
        block_id=np.sort(g.integers(0, 3, n)).astype(np.int32), num_blocks=3,
    )


def bench_sites(n: int, nb: int = 125) -> JoinedSites:
    """bench.py:344-356's binning input at n sites: a whole genome's 125
    blocks, 10% emp sites, sorted block ids."""
    g = np.random.default_rng(0)
    ab = np.exp(g.uniform(np.log(1e-1), np.log(1e4), n))
    ae = ab * np.exp(g.uniform(0.05, 2.0, n))
    emp = g.uniform(size=n) < 0.1
    ab[emp] = 0.0
    return JoinedSites(
        age_begin=ab, age_end=ae,
        w_shared=g.uniform(0, 2, n), w_notshared=g.uniform(0, 2, n),
        block_id=np.sort(g.integers(0, nb, n)).astype(np.int32),
        num_blocks=nb,
    )


def hist_rel(ours, ref) -> float:
    """Largest deviation over four float64 histograms, relative to each
    one's max; empty histograms count as no deviation."""
    if not len(ours) == len(ref) == 4:
        raise ValueError(f"expected four histograms, got {len(ours)} and {len(ref)}")
    worst = 0.0
    for a, b in zip(ours, ref):
        if a.shape != b.shape or a.dtype != np.float64 or b.dtype != np.float64:
            raise ValueError(f"histograms {a.shape} {a.dtype} and {b.shape} {b.dtype}")
        if b.size:
            worst = max(worst, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)))
    return worst
