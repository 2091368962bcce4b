"""The EM kernel's operations and bytes, and the H100's peaks: a frozen copy
of chip_smoke.py's ``em_ops``, ``em_bound`` and ``bound_ms``.

Float32 operations of one EM iteration as csrc/em_step.cu computes it: an
FMA is two, an add, multiply, division, expf, expm1f or logf one; a bin
whose shared (notshared) count is 0 needs none of the shared (notshared)
terms.  Bytes: the counts read and the rates and the run's state read and
written once.
"""

from __future__ import annotations

import numpy as np

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
K = 8                   # iterations a convergence test
NUM_AGE_BINS = 185

EM_OPS_BIN = 2          # H_t = H_k + lam_k (t - epochs[k]), for either side
EM_OPS_BIN_S = 8        # em1_lo, P_k^-, T1_k^-, Z_s and 1/Z_s
EM_OPS_BIN_N = (8, 3)   # k < E-1, k = E-1: dH_hi, em1_hi, T1_k^+; 1/zrel, integ_lo
EM_OPS_S = 13           # shared, e <= k
EM_OPS_N_BELOW = 3      # notshared, e < k: the full-width exposure
EM_OPS_N_AT = 13        # notshared, e = k
EM_OPS_N_ABOVE = 18     # notshared, e > k: exp(-(H_e - H_t)) and its mass, the rest
EM_OPS_LOGL = (3, 4)    # per bin and K-iteration chunk: the shared, notshared logl term
EM_OPS_EPOCH = 11       # per replicate and epoch: its tables and its M-step


def bin_epochs(epochs) -> np.ndarray:
    """The epoch of each age bin's centre."""
    b = np.arange(1, NUM_AGE_BINS, dtype=np.float64)
    t = np.concatenate([[0.0], np.exp((b - 1.0) / 10.0) / 10.0])
    ep = np.asarray(epochs, np.float64)
    return np.clip(np.searchsorted(ep, t, side="right") - 1, 0, ep.shape[0] - 1)


def em_ops(k, E: int, sc, nc, iters) -> float:
    """Float32 operations of an EM at E epochs: replicate b runs iters[b]
    iterations over the bins, of epoch k[n] each, whose counts sc[b, n],
    nc[b, n] are not 0."""
    k = np.asarray(k, np.int64)
    ops_s = EM_OPS_BIN_S + EM_OPS_S * (k + 1) + EM_OPS_LOGL[0] / K
    ops_n = (np.where(k < E - 1, *EM_OPS_BIN_N) + EM_OPS_N_BELOW * k + EM_OPS_N_AT
             + EM_OPS_N_ABOVE * (E - 1 - k) + EM_OPS_LOGL[1] / K)
    has_s = (np.asarray(sc) != 0).astype(np.float64)
    has_n = (np.asarray(nc) != 0).astype(np.float64)
    either = np.maximum(has_s, has_n)
    per_iter = EM_OPS_BIN * either.sum(1) + has_s @ ops_s + has_n @ ops_n + EM_OPS_EPOCH * E
    return float(np.asarray(iters, np.float64) @ per_iter)


def em_bytes(B: int, E: int) -> float:
    return B * (2 * NUM_AGE_BINS + 2 * E) * 4 + B * 16


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
