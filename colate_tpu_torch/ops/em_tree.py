"""Tree-conditioned EM E-step on the age-bin grid (legacy estimator).

Re-derivation of the reference's ``coal_EM_tree`` (coal/coal_EM_old.hpp:14-66,
coal_EM_old.cpp:61-520): the coalescence hazard over the 185-bin log-age
grid is per-bin inhomogeneous, ``h_i = rates[ep(i)] * num_lins[i]`` —
the epoch rate scaled by the marginal tree's lineage count in that bin —
and each bin carries a derived-allele-frequency weight ``DAF[i]``.  The
E-step returns per-epoch (num, denom) sufficient statistics for the
shared / not-shared observation of one mutation with age interval
[age_begin, age_end], plus the log normalising constant.

This class pair is dormant in the reference — no current mode calls it
(mode ``mut`` uses the unconditioned ``coal_EM``, SURVEY §2.6) — so this
is an API-parity component, implemented in plain f64 numpy with the
reference's exact regime structure and stable ``expm1`` forms instead of
guarded log-space chains.  Like the reference, age_begin/age_end are
assumed to lie on the bin grid (the only way the reference's regime
split is exhaustive: a bin straddling age_begin stops processing).

Semantics notes mirrored from the reference:
- epoch index per bin is quantised to the grid via the right bin edge
  (coal_EM_old.hpp:46-57, with its single-step ``if`` advance);
- shared processing stops at the first bin at/above age_end and at the
  first epoch whose leading bin has DAF == 0 (coal_EM_old.cpp:195);
- the final fold adds each *full* epoch's lineage-weighted width times
  the remaining (weighted) tail mass — epoch exposure for coalescences
  in later epochs (coal_EM_old.cpp:105-141 equivalent fold);
- the last epoch is normalised without that fold.
"""

from __future__ import annotations

import numpy as np

from colate_tpu_torch.config import AGE_BIN_C, NUM_AGE_BINS


def grid_and_epoch_index(epochs: np.ndarray, C: float = AGE_BIN_C):
    """(t_int [nb], ep_index [nb]) exactly as coal_EM_old.hpp:38-57.

    ep_index[i] is the epoch of interval [t_int[i], t_int[i+1]),
    advanced (by at most one epoch per bin, like the reference's ``if``)
    when the interval's right edge passes the next epoch boundary."""
    nb = NUM_AGE_BINS
    t = np.zeros(nb)
    ep = np.zeros(nb, np.int64)
    E = epochs.shape[0]
    e = 0
    for b in range(1, nb):
        t[b] = np.exp((b - 1.0) / C) / 10.0
        if e < E - 1 and t[b] > epochs[e + 1]:
            e += 1
        ep[b - 1] = e
    return t, ep


def _bin_tables(t, ep, rates, num_lins):
    """Per-bin hazards and unnormalised masses for the inhomogeneous
    piecewise-constant model (UpdateTree, coal_EM_old.cpp:61-67)."""
    nb = t.shape[0]
    dt = t[1:] - t[:-1]  # [nb-1]
    h = rates[ep[: nb - 1]] * np.asarray(num_lins[: nb - 1], np.float64)
    dH = h * dt
    H = np.concatenate([[0.0], np.cumsum(dH)])  # [nb]
    S = np.exp(-H)
    with np.errstate(divide="ignore"):
        inv = np.where(h > 0, 1.0 / np.where(h > 0, h, 1.0), np.inf)
    em1 = -np.expm1(-dH)
    mass = S[:-1] * em1  # P(T in bin i)
    # the reference's "(t0+1/h) - (t1+1/h) e^{-dH}" bracket minus
    # t0*mass, i.e. E[(T - t0) 1{T in bin}]: S_i ((dt+1/h) em1 - dt)
    brack = np.where(h > 0, S[:-1] * ((dt + inv) * em1 - dt), 0.0)
    return dt, h, H, S, inv, em1, mass, brack


def _fold(num_u, den_u, Z, dt, num_lins, ep, E):
    """Normalise and add full-epoch lineage-weighted exposure for
    coalescences in later epochs (the factor*integ fold,
    coal_EM_old.cpp:105-141); the last epoch carries no such fold."""
    num = np.zeros(E)
    den = np.zeros(E)
    if Z <= 0:
        return num, den
    factor = np.zeros(E)
    np.add.at(
        factor, ep[: dt.shape[0]],
        dt * np.asarray(num_lins[: dt.shape[0]], np.float64),
    )
    integ = 1.0
    for e in range(E):
        num[e] = num_u[e] / Z
        den[e] = den_u[e] / Z
        integ = max(integ - num[e], 0.0)
        if e < E - 1:
            den[e] += factor[e] * integ
        if den[e] < 0.0:
            den[e] = 0.0
    return num, den


def em_tree_shared(epochs, rates, num_lins, daf, age_begin, age_end,
                   C: float = AGE_BIN_C):
    """Shared-mutation E-step (coal_EM_tree::EM_shared).

    Returns (num [E], den [E], log_norm).  num[e] = posterior weight of
    coalescence in epoch e; den[e] = expected lineage-weighted branch
    exposure in epoch e; log_norm = log of the DAF-weighted mass."""
    epochs = np.asarray(epochs, np.float64)
    rates = np.asarray(rates, np.float64)
    E = epochs.shape[0]
    t, ep = grid_and_epoch_index(epochs, C)
    dt, h, H, S, inv, em1, mass, brack = _bin_tables(t, ep, rates, num_lins)
    daf = np.asarray(daf, np.float64)
    k = np.asarray(num_lins, np.float64)

    num_u = np.zeros(E)
    den_u = np.zeros(E)
    nb = t.shape[0]
    ident = age_begin == age_end
    cumsum_bl = 0.0
    cur_e = ep[0]
    i = 0
    while i < nb - 1:
        if ep[i] != cur_e:
            # epoch boundary: stop once the leading bin has DAF == 0
            if daf[i] == 0:
                break
            cur_e = ep[i]
            cumsum_bl = 0.0
        e = ep[i]
        t0, t1 = t[i], t[i + 1]
        if t1 <= age_begin:
            # constant regime: mutation definitely older than this bin
            m = daf[i] * mass[i]
            expos = daf[i] * brack[i]
            num_u[e] += m
            den_u[e] += expos * k[i] + cumsum_bl * m
        elif t0 >= age_begin and t1 <= age_end and not ident:
            # linear regime: uniform mutation-age weight (b - s)/(b - a)
            b = age_end
            w = daf[i] / (b - age_begin)
            m = w * S[i] * (
                (b - t0 - inv[i]) + (t1 - b + inv[i]) * np.exp(-h[i] * dt[i])
            )
            num_u[e] += m
            x0, x1 = t0 / b, t1 / b
            term1 = x0 * (b - t0) * h[i] + 1.0 - 2.0 * (x0 + inv[i] / b)
            term2 = -x1 * (b - t1) * h[i] - 1.0 + 2.0 * (x1 + inv[i] / b)
            tmp = term1 + np.exp(-h[i] * dt[i]) * term2
            # tmp is >= 0 analytically; negatives are fp noise (the
            # reference zeroes the epoch there; we skip the bin)
            if tmp >= 0.0:
                expos = w * b * inv[i] * S[i] * tmp - t0 * m
                den_u[e] += expos * k[i] + cumsum_bl * m
        else:
            break
        cumsum_bl += dt[i] * k[i]
        i += 1
    Z = num_u.sum()
    num, den = _fold(num_u, den_u, Z, dt, num_lins, ep, E)
    return num, den, float(np.log(Z)) if Z > 0 else -np.inf


def em_tree_notshared(epochs, rates, num_lins, daf, age_begin, age_end,
                      C: float = AGE_BIN_C):
    """Not-shared E-step (coal_EM_tree::EM_notshared): below age_begin
    the not-shared weight is 1-DAF; inside [age_begin, age_end] it mixes
    DAF * (s - age_begin)/(age_end - age_begin) with 1-DAF; bins with
    DAF == 0 (above the mutation) carry full mass."""
    epochs = np.asarray(epochs, np.float64)
    rates = np.asarray(rates, np.float64)
    E = epochs.shape[0]
    t, ep = grid_and_epoch_index(epochs, C)
    dt, h, H, S, inv, em1, mass, brack = _bin_tables(t, ep, rates, num_lins)
    daf = np.asarray(daf, np.float64)
    k = np.asarray(num_lins, np.float64)

    num_u = np.zeros(E)
    den_u = np.zeros(E)
    nb = t.shape[0]
    ident = age_begin == age_end
    cumsum_bl = 0.0
    cur_e = ep[0]
    i = 0
    while i < nb - 1:
        if ep[i] != cur_e:
            cur_e = ep[i]
            cumsum_bl = 0.0
        e = ep[i]
        t0, t1 = t[i], t[i + 1]
        m = None
        if t1 <= age_begin and daf[i] < 1.0:
            m = (1.0 - daf[i]) * mass[i]
            expos = (1.0 - daf[i]) * brack[i]
        elif t0 >= age_begin and t1 <= age_end and not ident:
            a, b = age_begin, age_end
            w = daf[i] / (b - a)
            m_lin = w * S[i] * (
                (t0 - a + inv[i]) + (a - t1 - inv[i]) * np.exp(-h[i] * dt[i])
            )
            x0, x1, xa = t0 / b, t1 / b, a / b
            term1 = x0 * (t0 - a) * h[i] + 2.0 * (x0 + inv[i] / b) - xa
            term2 = -x1 * (t1 - a) * h[i] - 2.0 * (x1 + inv[i] / b) + xa
            tmp = term1 + np.exp(-h[i] * dt[i]) * term2
            expos_lin = (
                w * b * inv[i] * S[i] * tmp if tmp >= 0.0 else -np.inf
            )
            m = m_lin + (1.0 - daf[i]) * mass[i]
            expos = (
                (expos_lin if np.isfinite(expos_lin) else 0.0)
                + (1.0 - daf[i]) * (brack[i] + t0 * mass[i])
            ) - t0 * m
        elif daf[i] == 0:
            m = mass[i]
            expos = brack[i]
        if m is not None:
            num_u[e] += m
            den_u[e] += expos * k[i] + cumsum_bl * m
        cumsum_bl += dt[i] * k[i]
        i += 1
    Z = num_u.sum()
    num, den = _fold(num_u, den_u, Z, dt, num_lins, ep, E)
    return num, den, float(np.log(Z)) if Z > 0 else -np.inf
