"""The numbers that decide ``correct``.

The answer of a mode ``mut`` job is, per bootstrap replicate, its rates
after the iterations it ran (``MutResult.iterations``).  Colate's EM stops
on the log-likelihood's relative gain, and in the directions in which the
likelihood is flat the rates still drift from one iteration to the next
long after it stops; a float32 stopping test, which sums float32 terms,
stops some tens of iterations from where a float64 one does.  So the rates
are held against the reference's float64 EM after as many iterations as
the program ran, but never fewer than ``STOP_ALLOWANCE`` before the
reference's own stop:

    rate_gap = max over replicates b and epochs e of
               |program[b, e] - reference(b, m_b)[e]| / |reference(b, m_b)[e]|,
    m_b = max(iterations[b], reference's stop[b] - STOP_ALLOWANCE)

(0 where both are 0, infinite where only the reference's is), over the
epochs the counts identify: those in which the reference's answer expects
at least ``EVENT_SHARE`` of the replicate's counted sites to coalesce.
The others, such as the open last epoch beyond every age bin, hold rates
that the likelihood does not depend on, which rounding alone sets (a
float32 exp(-H) that underflows, a residue of 1e-10 in an empty bin, lets
the M-step carry the rate below into them).  A job that
stops far too early, a step that does not move, counts that differ, a rate
altered or an EM in a lower precision read far above the program's own
float32 rounding.  The count of accepted sites and of blocks is compared
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import em

STOP_ALLOWANCE = 64
EVENT_SHARE = 1e-6


def rate_gap(epochs, shared, notshared, rates, iterations, device="cpu") -> tuple[float, int]:
    """(rate_gap, the most iterations by which the answer stopped before the
    reference) of the rates [B, E] a program answered after ``iterations``
    [B], on the counts [B, 185]."""
    init = np.full(np.shape(epochs), em.INITIAL_RATE)
    iterations = np.asarray(iterations, np.int64)
    _, own, ref = em.run_em(epochs, init, shared, notshared, device=device, at=iterations)
    at = np.maximum(iterations, own - STOP_ALLOWANCE)
    late = np.flatnonzero(at > iterations)
    if late.size:
        ref[late] = em.run_em(epochs, init, shared[late], notshared[late], device=device,
                              at=at[late])[2]
    d = np.abs(np.asarray(rates, np.float64) - ref)
    den = np.abs(ref)
    rel = np.where(den > 0, d / np.where(den > 0, den, 1.0), np.where(d > 0, np.inf, 0.0))
    rel = np.where(identified(epochs, ref, shared, notshared, device), rel, 0.0)
    return float(rel.max()), int((own - iterations).max())


def identified(epochs, rates, shared, notshared, device="cpu") -> np.ndarray:
    """[B, E]: whether the rates' expected coalescences in an epoch reach
    EVENT_SHARE of the replicate's counts."""
    ep = np.asarray(epochs, np.float64)
    t64 = em.age_bin_centers()
    k = np.clip(np.searchsorted(ep, t64, side="right") - 1, 0, ep.shape[0] - 1)
    as64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    sc, nc = as64(shared), as64(notshared)
    num_s, _, num_n, _, _, _ = em.e_step(as64(ep), as64(rates), as64(t64),
                                          torch.as_tensor(k, device=device))
    events = torch.einsum("bn,bne->be", sc, num_s) + torch.einsum("bn,bne->be", nc, num_n)
    total = sc.sum(1, keepdim=True) + nc.sum(1, keepdim=True)
    return (events >= EVENT_SHARE * total).cpu().numpy()


def read_coal(path: str) -> np.ndarray:
    """Rates [rows, printed epochs] of a mode ``mut`` ``.coal``."""
    return np.loadtxt(path, skiprows=2, ndmin=2)[:, 2:]


def program_rates(coal: np.ndarray, returned: np.ndarray, ep_null: int,
                  ancient: bool) -> np.ndarray:
    """The rates [B, E] a job answered: the ``.coal``'s, and, for an
    ancient target, whose file prints the epochs from ``ep_null`` on with
    the rates up to ``ep_null`` zeroed, the returned rates there."""
    B, E = returned.shape
    if not ancient:
        if coal.shape != (B, E):
            raise ValueError(f".coal holds {coal.shape}, the job {B} x {E} rates")
        return coal
    if coal.shape != (B, E - ep_null):
        raise ValueError(f".coal holds {coal.shape}, the job {B} x {E} rates from epoch {ep_null}")
    out = np.array(returned, np.float64)
    out[:, ep_null + 1:] = coal[:, 1:]
    return out
