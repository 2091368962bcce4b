"""Analytic age-bin histograms of joined sites, in plain torch (float64).

Colate draws 100 uniform ages per site in ``[age_begin, age_end]`` and adds
the site's weights into 185 log-age bins (coal/coal.cpp:2244-2298); the
analytic binning is that histogram's expectation.  A site with
``age_begin > 0`` spreads its weights over the bins in proportion to the
overlap of its interval with each, conditional on landing below the last
edge (out-of-table draws are redrawn).  A site with ``age_begin == 0`` (an
*emp* site) adds both weights to the emp matrices at ``bin(age_end)``, and
its notshared weight to the notshared histogram by the interval's uniform
law, the mass above the last edge into the last bin.  Per 30 Mb block.

Dense: every site against every bin, a block at a time, in chunks of
``chunk`` sites.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_AGE_BINS = 185


def age_bin_edges() -> np.ndarray:
    """The 186 bin edges: 0, then exp((b - 1.5)/10)/10 for b = 1..185."""
    b = np.arange(1, NUM_AGE_BINS + 1, dtype=np.float64)
    return np.concatenate([[0.0], np.exp((b - 1.5) / 10.0) / 10.0])


def emp_bin(age_end: torch.Tensor) -> torch.Tensor:
    """bin(t) = round(log(10 t) * 10) + 1, half away from 0, within the table."""
    safe = torch.clamp(age_end, min=1e-300)
    raw = torch.floor(torch.log(10.0 * safe) * 10.0 + 0.5).long() + 1
    return torch.where(age_end > 0, raw, torch.zeros_like(raw)).clamp(0, NUM_AGE_BINS - 1)


def _site_laws(ab, ae, edges):
    """Per site and bin, the regular law p and the emp law q [m, 185], and
    the emp flag [m]."""
    lo_e, hi_e, last = edges[:-1], edges[1:], edges[-1]
    width = ae - ab
    keep = width > 0
    emp = keep & (ab <= 0.0)
    # regular: the overlap with each bin over the in-table length
    top = torch.minimum(ae, last)
    z = top - ab
    reg = keep & ~emp & (z > 0)
    ov = torch.clamp(torch.minimum(top[:, None], hi_e) - torch.maximum(ab[:, None], lo_e), min=0.0)
    p = torch.where(reg[:, None], ov / torch.where(reg, z, torch.ones_like(z))[:, None],
                    torch.zeros_like(ov))
    # emp: the uniform law's CDF at the edges above 0, the rest into the last bin
    cdf = torch.clamp((edges - ab[:, None]) / torch.where(keep, width, torch.ones_like(width))[:, None],
                      0.0, 1.0)
    cdf = torch.where(edges > 0.0, cdf, torch.zeros_like(cdf))
    q = cdf[:, 1:] - cdf[:, :-1]
    q[:, -1] += 1.0 - cdf[:, -1]
    q = torch.where(emp[:, None], q, torch.zeros_like(q))
    return p, q, emp


def bin_sites(age_begin, age_end, w_shared, w_notshared, block, num_blocks: int,
              device="cpu", chunk: int = 1 << 18, dtype=torch.float64):
    """(shared, notshared, shared_emp, notshared_emp) of the sites, each a
    float64 numpy array [num_blocks, 185], or [P, num_blocks, 185] where the
    weights are [n, P] (P weightings of the same sites).  The inputs are
    numpy arrays or tensors; ``block`` is nondecreasing.  ``dtype`` is the
    working precision."""
    f64 = dtype
    as_t = lambda a: torch.as_tensor(a, device=device)
    ab, ae = as_t(age_begin).to(f64), as_t(age_end).to(f64)
    ws, wn = as_t(w_shared).to(f64), as_t(w_notshared).to(f64)
    one = ws.dim() == 1
    if one:
        ws, wn = ws[:, None], wn[:, None]
    blk = as_t(block).long()
    if blk.numel() and bool((blk[1:] < blk[:-1]).any()):
        raise ValueError("bin_sites: block ids must be nondecreasing")
    P = ws.shape[1]
    edges = torch.as_tensor(age_bin_edges(), dtype=f64, device=device)
    out = torch.zeros(4, num_blocks, P, NUM_AGE_BINS, dtype=f64, device=device)
    bounds = torch.searchsorted(blk, torch.arange(num_blocks + 1, device=device)).tolist()
    for b in range(num_blocks):
        for s in range(bounds[b], bounds[b + 1], chunk):
            e = min(s + chunk, bounds[b + 1])
            p, q, emp = _site_laws(ab[s:e], ae[s:e], edges)
            out[0, b] += ws[s:e].T @ p
            out[1, b] += wn[s:e].T @ (p + q)
            at = emp_bin(ae[s:e])
            zero = torch.zeros_like(ws[s:e])
            out[2, b] += torch.zeros(NUM_AGE_BINS, P, dtype=f64, device=device).index_add_(
                0, at, torch.where(emp[:, None], ws[s:e], zero)).T
            out[3, b] += torch.zeros(NUM_AGE_BINS, P, dtype=f64, device=device).index_add_(
                0, at, torch.where(emp[:, None], wn[s:e], zero)).T
    out = out.permute(0, 2, 1, 3).double().cpu().numpy()      # [4, P, num_blocks, 185]
    return tuple(h[0] if one else h for h in out)
