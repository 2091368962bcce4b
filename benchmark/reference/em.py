"""The EM of Colate's mode ``mut`` in plain torch: the maximum-likelihood
piecewise-constant coalescence rates of each bootstrap replicate.

Written from the model, not from the program under test.  A site whose
mutation has the point age ``t`` (an age-bin centre) counts as *shared*
when the pair coalesced before it (T < t) and *notshared* otherwise.  With
rates ``lam[e]`` on the epochs ``[epochs[e], epochs[e+1])`` (the last one
open) the survival is ``S(s) = exp(-H(s))``, ``H`` the integrated hazard.
One iteration is:

- E-step, for every age bin and replicate: the posterior mass of T in each
  epoch and the expected time spent in it (its exposure), given T < t or
  T > t;
- the count-weighted sums over the 185 bins of both sides, ``num`` and
  ``den``;
- M-step: ``num / den`` floored at 5e-9; an epoch with no exposure keeps
  its rate; an epoch with no mass takes the rate of the nearest epoch
  below that has some (0 when none has), as Colate's update does
  (coal/coal.cpp:3798-3811).

The log-likelihood of the iteration's input rates, summed in float64,
decides when a replicate stops: after more than 1000 iterations, at the
first whose ratio to the previous one exceeds 1 - 1e-7
(coal/coal.cpp:3822-3825), at most 100,000.  The rates returned are those
of the M-step of that iteration.

``dtype`` is the working precision.  ``tf32=True`` rounds the operands of
the two contractions over the bins to TF32 (10 explicit mantissa bits,
round to nearest), as a tensor-core matrix product takes them: the
control, the reference one step of precision below the float32 that the
configuration states.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUM_AGE_BINS = 185
RATE_FLOOR = 5e-9
MIN_ITER = 1000
MAX_ITER = 100_000
STOP_RATIO = 1.0 - 1e-7
INITIAL_RATE = 1.0 / 20000.0


def age_bin_centers() -> np.ndarray:
    """The point age of each of the 185 bins: 0, then exp((b-1)/10)/10."""
    b = np.arange(1, NUM_AGE_BINS, dtype=np.float64)
    return np.concatenate([[0.0], np.exp((b - 1.0) / 10.0) / 10.0])


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) with its mantissa rounded to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _g_over(lam, x):
    """(1 - (1 + x) e^-x) / lam, by its series below x = 0.5; 0 where lam is 0."""
    small = x < 0.5
    xs = torch.where(small, x, torch.zeros_like(x))
    series = xs * xs * (0.5 + xs * (-1 / 3 + xs * (1 / 8 + xs * (-1 / 30 + xs * (
        1 / 144 + xs * (-1 / 840 + xs * (1 / 5760)))))))
    xb = torch.where(small, torch.ones_like(x), x)
    closed = -torch.expm1(-xb) - xb * torch.exp(-xb)
    g = torch.where(small, series, closed)
    pos = lam > 0
    return torch.where(pos, g / torch.where(pos, lam, torch.ones_like(lam)), torch.zeros_like(g))


def _safe_div(a, b):
    pos = b > 0
    return torch.where(pos, a / torch.where(pos, b, torch.ones_like(b)), torch.zeros_like(a))


def e_step(epochs, lam, t, k):
    """Posterior epoch masses and exposures of both sides.

    epochs [E], lam [B, E], t [N] point ages, k [N] their epochs.  Returns
    num_s, den_s, num_n, den_n [B, N, E] and ll_s, ll_n [B, N]."""
    B, E = lam.shape
    N = t.shape[0]
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    dt = epochs[1:] - epochs[:-1]                          # [E-1]
    x = lam[:, :-1] * dt                                   # hazard of each closed epoch
    H = torch.cat([torch.zeros_like(lam[:, :1]), torch.cumsum(x, 1)], 1)   # at epoch starts
    S = torch.exp(-H)
    one_minus = -torch.expm1(-x)                           # P(T in epoch | T > its start)
    e = torch.arange(E, device=lam.device)
    below = e[None, :] < k[:, None]                        # [N, E]
    at = e[None, :] == k[:, None]
    above = e[None, :] > k[:, None]
    u = t - epochs[k]                                      # time from its epoch's start
    lam_k = lam[:, k]                                      # [B, N]
    H_t = H[:, k] + lam_k * u
    S_t = torch.exp(-H_t)

    # shared: T < t.  Epoch e < k: mass S_e (1 - e^-x_e); exposure
    # int_{e} (S(s) - S(t)) ds = S_e g(x_e)/lam_e + dt_e (S_{e+1} - S(t)).
    # Epoch k: mass S_k (1 - e^-(lam_k u)); exposure S_k g(lam_k u)/lam_k.
    last_closed = torch.cat([one_minus, torch.zeros_like(lam[:, :1])], 1)
    mass_full = S * last_closed                            # [B, E] (0 for the open epoch)
    g_full = torch.cat([S[:, :-1] * _g_over(lam[:, :-1], x), torch.zeros_like(lam[:, :1])], 1)
    S_next = torch.cat([S[:, 1:], torch.zeros_like(lam[:, :1])], 1)
    dt_full = torch.cat([dt, dt.new_zeros(1)])
    mass_k = S[:, k] * -torch.expm1(-lam_k * u)
    expo_k = S[:, k] * _g_over(lam_k, lam_k * u)
    mass_s = torch.where(below, mass_full[:, None, :], torch.where(at, mass_k[..., None], zero))
    expo_below = g_full[:, None, :] + dt_full * (S_next[:, None, :] - S_t[..., None])
    expo_s = torch.where(below, expo_below, torch.where(at, expo_k[..., None], zero))
    Z = -torch.expm1(-H_t)                                 # P(T < t)
    num_s = _safe_div(mass_s, Z[..., None])
    den_s = torch.clamp(_safe_div(expo_s, Z[..., None]), min=0.0)
    ll_s = torch.where(Z > 0, torch.log(torch.where(Z > 0, Z, torch.ones_like(Z))), zero)

    # notshared: T > t, relative to S(t).  Epoch e < k: exposure dt_e.
    # Epoch k: mass 1 - e^-y (y = lam_k (epochs[k+1] - t)), exposure
    # u + (1 - e^-y)/lam_k; open: mass 1, exposure u + 1/lam_k.  Epoch e > k:
    # mass S_e/S(t) (1 - e^-x_e), exposure S_e/S(t) (1 - e^-x_e)/lam_e
    # (dt_e where lam_e is 0); open: mass S_e/S(t), exposure S_e/S(t)/lam_e.
    closed_k = k < E - 1
    d = torch.where(closed_k, epochs[torch.clamp(k + 1, max=E - 1)] - t, torch.zeros_like(t))
    y = lam_k * d
    pos_k = lam_k > 0
    mass_at = torch.where(closed_k, -torch.expm1(-y), pos_k.to(lam.dtype))
    expo_at = torch.where(
        closed_k,
        u + torch.where(pos_k, _safe_div(-torch.expm1(-y), lam_k), d),
        torch.where(pos_k, u + _safe_div(torch.ones_like(lam_k), lam_k), zero),
    )
    rel = torch.exp(-torch.where(above, H[:, None, :] - H_t[..., None], zero))   # S_e / S(t)
    pos = lam > 0
    open_e = e == E - 1
    mass_e = torch.where(open_e, pos.to(lam.dtype), last_closed)
    expo_e = torch.where(open_e, _safe_div(torch.ones_like(lam), lam),
                         torch.where(pos, _safe_div(last_closed, lam), dt_full))
    mass_n = torch.where(above, rel * mass_e[:, None, :], torch.where(at, mass_at[..., None], zero))
    expo_n = torch.where(above, rel * expo_e[:, None, :], torch.where(at, expo_at[..., None], zero))
    zrel = mass_n.sum(-1)                                  # P(T > t) / S(t)
    num_n = _safe_div(mass_n, zrel[..., None])
    den_n = torch.where(below, dt_full.expand(B, N, E), _safe_div(expo_n, zrel[..., None]))
    den_n = torch.where((zrel > 0)[..., None], torch.clamp(den_n, min=0.0), zero)
    ll_n = torch.where(zrel > 0, torch.log(torch.where(zrel > 0, zrel, torch.ones_like(zrel))) - H_t,
                       zero)
    return num_s, den_s, num_n, den_n, ll_s, ll_n


def m_step(lam, num, den):
    """Colate's update of the rates [B, E] from the summed masses and exposures."""
    E = lam.shape[1]
    ratio = torch.clamp(_safe_div(num, den), min=RATE_FLOOR)
    chosen = torch.where(den > 0, ratio, lam)
    e = torch.arange(E, device=lam.device)
    src = torch.cummax(torch.where(num != 0, e, -1), 1).values
    return torch.where(src >= 0, torch.gather(chosen, 1, src.clamp(min=0)),
                       torch.zeros_like(chosen))


def iteration(epochs, lam, sc, nc, t, k, tf32: bool = False):
    """One EM iteration: (new rates [B, E], float64 log-likelihood [B] of lam)."""
    num_s, den_s, num_n, den_n, ll_s, ll_n = e_step(epochs, lam, t, k)
    if tf32:
        sc, nc = to_tf32(sc), to_tf32(nc)
        num_s, den_s, num_n, den_n = (to_tf32(a) for a in (num_s, den_s, num_n, den_n))
    num = torch.einsum("bn,bne->be", sc, num_s) + torch.einsum("bn,bne->be", nc, num_n)
    den = torch.einsum("bn,bne->be", sc, den_s) + torch.einsum("bn,bne->be", nc, den_n)
    ll = (sc.double() * ll_s.double()).sum(1) + (nc.double() * ll_n.double()).sum(1)
    return m_step(lam, num, den), ll


def run_em(epochs, init_rates, shared_counts, notshared_counts, device="cpu",
           dtype=torch.float64, tf32: bool = False, at=None):
    """Every replicate to its stop.  epochs, init_rates [E] and the counts
    [B, 185] are numpy arrays.  Returns (rates [B, E] float64 numpy at each
    replicate's stop, its iterations [B] numpy); with ``at`` [B], also the
    rates after ``at[b]`` iterations of replicate b, each running on to the
    later of the two."""
    ep64 = np.asarray(epochs, np.float64)
    E = ep64.shape[0]
    t64 = age_bin_centers()
    k = np.clip(np.searchsorted(ep64, t64, side="right") - 1, 0, E - 1)
    epochs_t = torch.as_tensor(ep64, dtype=dtype, device=device)
    t = torch.as_tensor(t64, dtype=dtype, device=device)
    k_t = torch.as_tensor(k, device=device)
    sc = torch.as_tensor(np.asarray(shared_counts, np.float64), device=device).to(dtype)
    nc = torch.as_tensor(np.asarray(notshared_counts, np.float64), device=device).to(dtype)
    B = sc.shape[0]
    lam = torch.as_tensor(np.asarray(init_rates, np.float64), device=device).to(dtype)
    lam = lam[None, :].expand(B, E).contiguous()
    stop_rates, at_rates = lam.clone(), lam.clone()
    ll_prev = torch.full((B,), -math.inf, dtype=torch.float64, device=device)
    iters = torch.zeros(B, dtype=torch.int64, device=device)
    at_t = torch.as_tensor(np.zeros(B) if at is None else np.asarray(at), device=device).long()
    todo = torch.arange(B, device=device)
    for it in range(MAX_ITER):
        new, ll = iteration(epochs_t, lam[todo], sc[todo], nc[todo], t, k_t, tf32)
        lam[todo] = new
        n = it + 1
        stop = (iters[todo] == 0) & (ll / ll_prev[todo] > STOP_RATIO) & (it > MIN_ITER)
        stop |= (iters[todo] == 0) & (n == MAX_ITER)
        ll_prev[todo] = ll
        iters[todo[stop]] = n
        stop_rates[todo[stop]] = new[stop]
        hit = at_t[todo] == n
        at_rates[todo[hit]] = new[hit]
        todo = todo[(iters[todo] == 0) | (at_t[todo] > n)]
        if todo.numel() == 0:
            break
    out = (stop_rates.double().cpu().numpy(), iters.cpu().numpy())
    return out if at is None else (*out, at_rates.double().cpu().numpy())
