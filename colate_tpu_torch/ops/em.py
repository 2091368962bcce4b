"""Batched EM for piecewise-constant coalescence rates, in plain torch.

Port of colate_tpu/ops/em.py (the point-age E-step, the M-step and the
K-chunked fixed-point loop with per-replicate freezing; the interval-age
E-step, host float64 numpy, copied; the Monte-Carlo E-step).  The bootstrap
batch is a leading dimension written out, where the JAX package vmaps.
The float64 branch follows the reference expression for expression: the
byte identity of ``--sampling mc_parity`` runs rests on it.  Also holds
the replicate-sequential EM of ``--devices`` (:func:`run_em_sequential`),
the checkpointed EM of ``--checkpoint`` (:func:`run_em_checkpointed`) and
the port's own ctypes wrapper of the native host EM (``cn_em_run``).

Inputs may be numpy arrays or tensors; results are tensors on ``device``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from colate_tpu_torch._torch import torch
from colate_tpu_torch.config import (
    COAL_RATE_FLOOR,
    EM_CONV_RATIO,
    EM_MAX_ITER,
    EM_MIN_ITER,
    age_bin_centers,
)

# float32 E-steps use the cancellation-free exposure identity (_gdiv), the
# reference's CPU default (colate_tpu/ops/em.py:_stable_den).  Its A/B was
# measured on a TPU and says nothing about CUDA; the H100 A/B is open work.
STABLE_DEN_F32 = True


def epoch_tables(epochs, rates):
    """Per-epoch survival tables; epochs [E], rates [B,E] -> dict of [B,E]
    (``dt`` is [E-1])."""
    lam = rates
    B = lam.shape[0]
    dt = torch.diff(epochs)
    dH = lam[:, :-1] * dt
    H = torch.cat([lam.new_zeros(B, 1), torch.cumsum(dH, 1)], 1)
    S = torch.exp(-H)
    em1 = -torch.expm1(-dH)
    pos = lam > 0
    inv_lam = torch.where(pos, 1.0 / torch.where(pos, lam, 1.0), 0.0)
    # the open last epoch carries mass only if its rate is positive
    P = torch.cat(
        [S[:, :-1] * em1, torch.where(lam[:, -1] > 0, S[:, -1], 0.0)[:, None]], 1
    )
    T1_body = S[:, :-1] * ((epochs[1:] + inv_lam[:, :-1]) * em1 - dt)
    T1_last = (epochs[-1] + inv_lam[:, -1]) * S[:, -1]
    T1 = torch.cat(
        [
            torch.where(lam[:, :-1] > 0, T1_body, 0.0),
            torch.where(lam[:, -1] > 0, T1_last, 0.0)[:, None],
        ],
        1,
    )
    return dict(lam=lam, dt=dt, H=H, S=S, P=P, T1=T1, inv_lam=inv_lam)


def _gdiv(lam, x):
    """g(x)/λ with g(x) = 1 − (1+x)e^{−x}, series below x=0.5
    (colate_tpu/ops/em.py:_gdiv)."""
    small = x < 0.5
    xs = torch.where(small, x, 0.0)
    g_small = xs * xs * (
        0.5
        + xs * (-1.0 / 3.0
                + xs * (0.125
                        + xs * (-1.0 / 30.0
                                + xs * (1.0 / 144.0
                                        + xs * (-1.0 / 840.0
                                                + xs * (1.0 / 5760.0))))))
    )
    xb = torch.where(small, 1.0, x)
    g_big = -torch.expm1(-xb) - xb * torch.exp(-xb)
    g = torch.where(small, g_small, g_big)
    return torch.where(lam > 0, g / torch.where(lam > 0, lam, 1.0), 0.0)


def _rsuffix(x):
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), -1), (-1,))


def e_step_all_bins(epochs, rates, t, k):
    """E-step for all age bins of every replicate.

    epochs [E], rates [B,E], t [nb] point ages, k [nb] epoch index of t.
    Returns (num_s, den_s, logl_s, num_n, den_n, logl_n): [B,nb,E] x2,
    [B,nb], [B,nb,E] x2, [B,nb] (colate_tpu/ops/em.py:_e_step_all_bins).
    """
    E = epochs.shape[0]
    dtype = epochs.dtype
    tab = epoch_tables(epochs, rates)
    lam_k = tab["lam"][:, k]  # [B, nb]
    inv_lam_k = tab["inv_lam"][:, k]
    H_k = tab["H"][:, k]
    S_k = tab["S"][:, k]
    t_k = epochs[k]
    dH_lo = lam_k * (t - t_k)
    H_t = H_k + dH_lo
    em1_lo = -torch.expm1(-dH_lo)

    e_idx = torch.arange(E, device=epochs.device)
    m_lt = e_idx[None, :] < k[:, None]  # [nb, E]
    m_eq = e_idx[None, :] == k[:, None]
    m_le = m_lt | m_eq
    m_gt = e_idx[None, :] > k[:, None]
    f_lt, f_eq, f_gt = (m.to(dtype) for m in (m_lt, m_eq, m_gt))

    dt_full = torch.cat([tab["dt"], epochs.new_zeros(1)])  # [E]
    stable = dtype == torch.float32 and STABLE_DEN_F32

    # ---------- shared: T < t ----------
    Pk_minus = S_k * em1_lo
    T1k_minus = torch.where(
        lam_k > 0, S_k * ((t + inv_lam_k) * em1_lo - (t - t_k)), 0.0
    )
    num_lin = tab["P"][:, None, :] * f_lt + Pk_minus[..., None] * f_eq
    T1v = tab["T1"][:, None, :] * f_lt + T1k_minus[..., None] * f_eq
    Z_s = -torch.expm1(-H_t)
    guard_s = Z_s > 0
    zinv = torch.where(guard_s, 1.0 / torch.where(guard_s, Z_s, 1.0), 0.0)
    post = num_lin * zinv[..., None]
    texp = T1v * zinv[..., None]
    # remaining conditional mass above epoch e as the SUFFIX sum of the
    # per-epoch masses, never as 1-cumsum (see the reference)
    srev = _rsuffix(num_lin)
    integ = (srev - num_lin) * zinv[..., None]
    if stable:
        lam = tab["lam"]
        D_body = tab["S"][:, :-1] * _gdiv(lam[:, :-1], lam[:, :-1] * tab["dt"])
        D_last = torch.where(lam[:, -1] > 0, tab["inv_lam"][:, -1] * tab["S"][:, -1], 0.0)
        D_full = torch.cat([D_body, D_last[:, None]], 1)  # [B, E]
        Dk_minus = S_k * _gdiv(lam_k, dH_lo)
        Dv = D_full[:, None, :] * f_lt + Dk_minus[..., None] * f_eq
        den = Dv * zinv[..., None] + dt_full * integ
    else:
        den = texp - epochs * post + dt_full * integ
    # epochs beyond k are untouched by the reference (stay 0)
    den = torch.where(m_le, den, 0.0)
    den = torch.clamp(den, min=0.0)
    num_s = torch.where(guard_s[..., None], post, 0.0)
    den_s = torch.where(guard_s[..., None], den, 0.0)
    logl_s = torch.where(guard_s, torch.log(torch.where(guard_s, Z_s, 1.0)), 0.0)

    # ---------- notshared: T > t, in hazard-relative space ----------
    lam_full = tab["lam"]
    k1 = torch.clamp(k + 1, max=E - 1)
    dH_hi = torch.where(k < E - 1, lam_k * (epochs[k1] - t), 0.0)
    em1_hi = -torch.expm1(-dH_hi)
    t_k1 = epochs[k1]
    G = tab["H"][:, None, :] - H_t[..., None]
    Srel = torch.exp(-torch.where(m_gt, G, 0.0))
    em1_full = torch.cat(
        [-torch.expm1(-lam_full[:, :-1] * tab["dt"]), lam_full.new_ones(lam_full.shape[0], 1)], 1
    )
    is_last = e_idx == E - 1
    P_rel = torch.where(
        is_last,
        torch.where(lam_full[:, None, :] > 0, Srel, 0.0),
        Srel * em1_full[:, None, :],
    )
    enext = torch.cat([epochs[1:], epochs.new_zeros(1)])
    T1_rel_body = Srel * (
        (enext + tab["inv_lam"][:, None, :]) * em1_full[:, None, :] - dt_full
    )
    T1_rel_last = (epochs[-1] + tab["inv_lam"][:, -1])[:, None, None] * Srel
    T1_rel = torch.where(is_last, T1_rel_last, T1_rel_body)
    T1_rel = torch.where(lam_full[:, None, :] > 0, T1_rel, 0.0)

    Pk_plus = torch.where(k < E - 1, em1_hi, (lam_k > 0).to(dtype))
    T1k_plus_body = torch.where(
        lam_k > 0, (t_k1 + inv_lam_k) * em1_hi - (t_k1 - t), 0.0
    )
    T1k_plus_last = torch.where(lam_k > 0, t + inv_lam_k, 0.0)
    T1k_plus = torch.where(k < E - 1, T1k_plus_body, T1k_plus_last)

    raw_n = Pk_plus[..., None] * f_eq + P_rel * f_gt
    raw_t = T1k_plus[..., None] * f_eq + T1_rel * f_gt
    # normalise by the total absorbed mass (the reference's logsumexp
    # constant); zrel == 0 zeroes everything
    zrel = torch.sum(raw_n, -1)
    guard_n = zrel > 0
    zrel_inv = torch.where(guard_n, 1.0 / torch.where(guard_n, zrel, 1.0), 0.0)
    post_n = raw_n * zrel_inv[..., None]
    texp_n = raw_t * zrel_inv[..., None]
    srev_n = _rsuffix(raw_n)
    integ_n = (srev_n - raw_n) * zrel_inv[..., None]
    if stable:
        D_rel_body = Srel * _gdiv(lam_full[:, None, :], lam_full[:, None, :] * dt_full)
        D_rel_last = torch.where(
            lam_full[:, -1, None, None] > 0, tab["inv_lam"][:, -1, None, None] * Srel, 0.0
        )
        D_rel = torch.where(is_last, D_rel_last, D_rel_body)
        Dk_plus_body = _gdiv(lam_k, dH_hi) + (t - t_k) * em1_hi
        Dk_plus_last = torch.where(lam_k > 0, (t - t_k) + inv_lam_k, 0.0)
        Dk_plus = torch.where(k < E - 1, Dk_plus_body, Dk_plus_last)
        Dv_n = Dk_plus[..., None] * f_eq + D_rel * f_gt
        den_n = Dv_n * zrel_inv[..., None] + dt_full * integ_n
    else:
        den_n = texp_n - epochs * post_n + dt_full * integ_n
    den_n = torch.clamp(den_n, min=0.0)
    num_n = torch.where(guard_n[..., None], post_n, 0.0)
    den_n = torch.where(guard_n[..., None], den_n, 0.0)
    # reference normalising constant = log(absorbed mass) = log(zrel) - H_t
    logl_n = torch.where(guard_n, torch.log(torch.where(guard_n, zrel, 1.0)) - H_t, 0.0)

    return num_s, den_s, logl_s, num_n, den_n, logl_n


def e_step_interval(epochs, rates, age_begin, age_end):
    """Analytic E-step for *interval* mutation ages t ~ U[a, b].

    The reference's ``EM_shared(age_begin, age_end, ...)`` /
    ``EM_notshared`` integrate the uniform age prior analytically
    (coal_EM.cpp:217-231); mode `mut` only ever calls the point-age case
    (a == b, handled by the vectorised ``e_step_all_bins``), so this
    host-side f64 implementation exists for API parity and is verified
    against the exact mpmath oracle (tests/helpers/em_oracle.py).

    epochs [E], rates [E] (all > 0), age_begin/age_end [nb] with
    age_begin <= age_end.  Returns (num_s, den_s, logl_s, num_n, den_n,
    logl_n): [nb, E] x2, [nb], [nb, E] x2, [nb] — num = posterior epoch
    mass, den = conditional epoch exposure E[(min(T,t_{e+1})-t_e)^+],
    logl = log P(event); all-zero rows where P(event) == 0.
    """
    epochs = np.asarray(epochs, np.float64)
    rates = np.asarray(rates, np.float64)
    a_arr = np.asarray(age_begin, np.float64)
    b_arr = np.asarray(age_end, np.float64)
    E = epochs.shape[0]
    nb = a_arr.shape[0]
    out = [np.zeros((nb, E)) for _ in range(4)]
    logl = [np.zeros(nb), np.zeros(nb)]

    def moments(lam, Hlo, lo, hi):
        """(I0, I1, I2) of ∫ T^k λ e^{-H(T)} dT over [lo, hi] (hi may be
        inf), expm1-stabilised like epoch_tables."""
        S = np.exp(-Hlo)
        inv = 1.0 / lam
        if np.isinf(hi):
            return (
                S,
                (lo + inv) * S,
                (lo * lo + 2 * lo * inv + 2 * inv * inv) * S,
            )
        d = hi - lo
        x = lam * d
        if x < 1e-4:
            # Taylor in λ: the closed forms cancel catastrophically here
            # (terms ~2/λ² against a result ~λd³); truncation O(x^3)
            i0 = S * lam * d * (1 - x / 2 + x * x / 6)
            i1 = S * lam * (
                lo * d + d * d / 2
                - lam * (lo * d * d / 2 + d**3 / 3)
                + lam * lam * (lo * d**3 / 6 + d**4 / 8)
            )
            i2 = S * lam * (
                (lo * lo * d + lo * d * d + d**3 / 3)
                - lam * (lo * lo * d * d / 2 + 2 * lo * d**3 / 3 + d**4 / 4)
                + lam * lam * (lo * lo * d**3 / 6 + lo * d**4 / 4 + d**5 / 10)
            )
            return i0, i1, i2
        edl = np.exp(-x)
        em1 = -np.expm1(-x)
        i0 = S * em1
        # (lo+inv)S(lo) - (hi+inv)S(hi), grouped so the small-λd
        # cancellation stays bounded (the x < 1e-4 branch covers the rest)
        i1 = S * ((lo + inv) * em1 - d * edl)
        i2 = S * (
            (lo * lo + 2 * lo * inv + 2 * inv * inv) * em1
            - d * (lo + hi + 2 * inv) * edl
        )
        return i0, i1, i2

    for i in range(nb):
        a, b = float(a_arr[i]), float(b_arr[i])
        point = a == b
        bounds = np.unique(np.concatenate([epochs, [a, b]]))
        pieces = []  # (lo, hi, epoch k)
        for j in range(bounds.shape[0] - 1):
            lo, hi = float(bounds[j]), float(bounds[j + 1])
            if hi <= lo:
                continue
            k = int(np.searchsorted(epochs, lo, side="right") - 1)
            pieces.append((lo, hi, k))
        pieces.append((float(bounds[-1]), np.inf, E - 1))

        H = 0.0
        prev, prev_k = 0.0, 0
        width = b - a
        Hs = []
        for lo, hi, k in pieces:
            H += rates[prev_k] * (lo - prev)
            Hs.append(H)
            prev, prev_k = lo, k

        # hazard at a: notshared mass lives above a, so factoring
        # e^{-H(a)} out keeps Z representable at extreme hazards (the
        # point-age path does the same in hazard-relative space; the
        # reference survives there via log space)
        H_a = 0.0
        for (lo, hi, k), Hlo in zip(pieces, Hs):
            if lo <= a:
                H_a = Hlo + rates[k] * (a - lo)

        for side, shared in ((0, True), (1, False)):
            Href = 0.0 if shared else H_a
            Z = 0.0
            mass = np.zeros(E)
            expo = np.zeros(E)
            for (lo, hi, k), Hlo_abs in zip(pieces, Hs):
                Hlo = Hlo_abs - Href
                # w(T) = c0 + c1 T on this piece
                if point:
                    inside = (hi <= a) if shared else (lo >= a)
                    if not inside:
                        continue
                    c0, c1 = 1.0, 0.0
                elif shared:
                    if lo >= b:
                        continue
                    c0, c1 = (1.0, 0.0) if hi <= a else (b / width, -1.0 / width)
                else:
                    if hi <= a:
                        continue
                    c0, c1 = (1.0, 0.0) if lo >= b else (-a / width, 1.0 / width)
                i0, i1, i2 = moments(rates[k], Hlo, lo, hi)
                m = c0 * i0 + c1 * i1
                Z += m
                mass[k] += m
                # exposure: epochs e < k get the full width, e == k the
                # in-epoch part (T - t_e), e > k nothing
                if k > 0:
                    expo[:k] += (epochs[1 : k + 1] - epochs[:k]) * m
                expo[k] += (c0 * i1 + c1 * i2) - epochs[k] * m
            if Z > 0:
                out[2 * side][i] = mass / Z
                out[2 * side + 1][i] = np.maximum(expo, 0.0) / Z
                logl[side][i] = np.log(Z) - Href

    return out[0], out[1], logl[0], out[2], out[3], logl[1]


def e_step_sampled(epochs, rates, generator, age_begin, age_end):
    """Monte-Carlo E-step: one uniform age draw per bin, then the
    point-age E-step (:func:`e_step_all_bins`) at the sampled age
    (colate_tpu/ops/em.py:e_step_sampled).

    The reference defines this as ``EM_shared_sampled`` /
    ``EM_notshared_sampled`` (coal/coal_EM.cpp:470-770, max_iter=1) but
    never calls it from mode `mut`; it is provided for API parity and
    for MC cross-checks of the analytic binning.  epochs [E], rates [E],
    age_begin/age_end [nb]: tensors on one device, where it runs; the
    draws come from ``generator``, a ``torch.Generator`` on that device.
    Returns the six-tuple of :func:`e_step_all_bins` for one replicate
    ([nb, E] x2, [nb], [nb, E] x2, [nb]) plus the sampled ages [nb].
    """
    u = torch.rand(age_begin.shape, generator=generator, dtype=epochs.dtype,
                   device=epochs.device)
    t = age_begin + u * (age_end - age_begin)
    k = torch.clamp(torch.searchsorted(epochs, t, right=True) - 1, 0, epochs.shape[0] - 1)
    return tuple(x[0] for x in e_step_all_bins(epochs, rates[None], t, k)) + (t,)


def m_step(rates_old, num_tot, den_tot):
    """Reference rate update (colate_tpu/ops/em.py:_m_step), all [B,E]:
    num==0 copies the previous epoch's new rate (0 for epoch 0), den==0
    keeps the old rate, otherwise num/den floored at COAL_RATE_FLOOR.  The
    fill-forward is a running max of the last index with num != 0."""
    E = rates_old.shape[-1]
    ratio = torch.where(den_tot > 0, num_tot / torch.where(den_tot > 0, den_tot, 1.0), 0.0)
    ratio = torch.clamp(ratio, min=COAL_RATE_FLOOR)
    chosen = torch.where(den_tot == 0, rates_old, ratio)
    has = num_tot != 0
    e_idx = torch.arange(E, device=rates_old.device)
    idx = torch.cummax(torch.where(has, e_idx, -1), -1).values
    return torch.where(idx >= 0, torch.gather(chosen, -1, idx.clamp(min=0)), 0.0)


def conv_ratio(K: int) -> float:
    """The per-chunk stopping ratio: K iterations of improvement each below
    (1-EM_CONV_RATIO) compound to at most K*(1-EM_CONV_RATIO)."""
    return 1.0 - K * (1.0 - EM_CONV_RATIO)


def _tensor(x, device):
    """A tensor on ``device`` from a tensor or anything numpy can read."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(device)


def run_em(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    max_iter: int = EM_MAX_ITER,
    min_iter: int = EM_MIN_ITER,
    dtype: str | None = None,
    check_every: int | None = None,
    resume_state=None,
    return_state: bool = False,
    device="cuda",
    step=None,
):
    """EM to convergence for all bootstrap replicates
    (colate_tpu/ops/em.py:run_em).

    epochs [E]; init_rates [E]; shared/notshared_counts [B, nbins].
    ``dtype`` is the E-step precision, "float64" (default) or "float32";
    the log-likelihood of the stopping rule always accumulates in f64.
    ``check_every`` K (default 1 in f64, 8 in f32) runs K iterations per
    convergence test at the per-chunk ratio 1-K*(1-EM_CONV_RATIO).
    Replicates freeze once converged.  ``resume_state`` continues from a
    ``return_state=True`` tuple (it, rates, ll, conv, iters).
    ``step(rates, K) -> (rates', ll)`` replaces the torch iterations of a
    chunk: K EM iterations of the [B,E] rates and the f64 log-likelihood
    [B] of the K-th E-step (ops/em_kernel.py passes the fused kernel).

    Returns (rates [B,E] in epochs' dtype, logl [B] f64, iters [B] i32),
    or the loop state with ``return_state``.
    """
    f64 = torch.float64
    wdt = f64 if dtype in (None, "float64") else torch.float32
    epochs_t = _tensor(epochs, device)
    out_dtype = epochs_t.dtype
    E = epochs_t.shape[0]
    # epoch assignment of the age-bin centres stays f64 (bin boundaries)
    t64 = torch.as_tensor(age_bin_centers(), dtype=epochs_t.dtype, device=device)
    k = torch.clamp(torch.searchsorted(epochs_t, t64, right=True) - 1, 0, E - 1)
    t = t64.to(wdt)
    epochs_w = epochs_t.to(wdt)
    sc = _tensor(shared_counts, device).to(wdt)
    nc = _tensor(notshared_counts, device).to(wdt)
    B = sc.shape[0]

    def iteration(rates):
        num_s, den_s, logl_s, num_n, den_n, logl_n = e_step_all_bins(epochs_w, rates, t, k)
        num_tot = torch.einsum("bn,bne->be", sc, num_s) + torch.einsum("bn,bne->be", nc, num_n)
        den_tot = torch.einsum("bn,bne->be", sc, den_s) + torch.einsum("bn,bne->be", nc, den_n)
        ll = torch.einsum("bn,bn->b", sc.to(f64), logl_s.to(f64)) + torch.einsum(
            "bn,bn->b", nc.to(f64), logl_n.to(f64)
        )
        return m_step(rates, num_tot, den_tot), ll

    if step is None:
        def step(rates, K):
            for _ in range(K - 1):
                rates, _ = iteration(rates)
            return iteration(rates)

    K = check_every
    if K is None:
        K = 1 if wdt == f64 else 8
    ratio_min = conv_ratio(K)

    if resume_state is None:
        it = 0
        rates = _tensor(init_rates, device).to(wdt)[None, :].expand(B, E)
        ll_prev = torch.full((B,), -torch.inf, dtype=f64, device=device)
        conv = torch.zeros(B, dtype=torch.bool, device=device)
        iters = torch.zeros(B, dtype=torch.int32, device=device)
    else:
        r_it, r_rates, r_ll, r_conv, r_iters = resume_state
        it = int(r_it)
        rates = _tensor(r_rates, device).to(wdt)
        ll_prev = _tensor(r_ll, device).to(f64)
        conv = _tensor(r_conv, device).to(torch.bool)
        iters = _tensor(r_iters, device).to(torch.int32)

    while it < max_iter and not bool(conv.all()):
        new_rates, ll = step(rates, K)
        ratio = ll / ll_prev  # both negative; -inf prev -> ratio <= 0
        newly = (ratio > ratio_min) & (it + K - 1 > min_iter)
        rates = torch.where(conv[:, None], rates, new_rates)
        ll_prev = torch.where(conv, ll_prev, ll)
        iters = torch.where(conv, iters, torch.full_like(iters, it + K))
        conv = conv | newly
        it += K
    if return_state:
        return it, rates, ll_prev, conv, iters
    return rates.to(out_dtype), ll_prev, iters


def run_em_sequential(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    max_iter: int = EM_MAX_ITER,
    min_iter: int = EM_MIN_ITER,
    dtype: str | None = None,
    device="cuda",
):
    """Replicate-sequential EM: a B=1 :func:`run_em` per replicate
    (colate_tpu/ops/em.py:run_em_sequential).

    Every replicate runs the same B=1 program however many replicates
    share its device, so any split of the replicates over devices is
    bitwise transparent (parallel/mesh.py:sharded_run_em, backend
    "float64").  Results as :func:`run_em`."""
    sc = _tensor(shared_counts, device)
    nc = _tensor(notshared_counts, device)
    # range(max(B, 1)): B=0 runs once on the empty slice, giving empty results
    parts = [
        run_em(epochs, init_rates, sc[b : b + 1], nc[b : b + 1], max_iter=max_iter,
               min_iter=min_iter, dtype=dtype, device=device)
        for b in range(max(sc.shape[0], 1))
    ]
    return tuple(torch.cat(x) for x in zip(*parts))


def run_em_checkpointed(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    ckpt_path: str,
    fingerprint: str,
    dtype: str | None = None,
    device="cuda",
    chunk: int = 4096,
):
    """The EM with its loop state (it, rates, logl, conv, iters) saved to
    ``ckpt_path`` after every ``chunk`` iterations
    (colate_tpu/ops/em.py:run_em_checkpointed).  A killed run resumes from
    the saved state, so it returns what an uninterrupted run returns: the
    chunk only caps ``max_iter`` of each call.  The file is written to a
    temporary name and renamed, and removed when the run finishes; a state
    whose fingerprint or dtype differs is not resumed.

    One driver over two EMs on ``device``: ``dtype`` "float64" (default)
    the torch EM (:func:`run_em`), "float32" the EM kernel
    (ops/em_kernel.py:run_em_kernel): one launch of the CUDA kernel per
    chunk on a card, its plain version on the CPU.

    ``COLATE_EM_DIE_AFTER_CHUNKS=<k>`` exits the process (code 17) after
    the k-th write, and ``COLATE_EM_CKPT_CHUNK`` overrides ``chunk``: the
    hooks of the kill-and-resume tests.

    Returns numpy (rates [B,E] f64, logl [B] f64, iters [B] i32)."""
    import os
    import zipfile

    wdt_name = "float64" if dtype in (None, "float64") else "float32"
    if wdt_name == "float32":
        from colate_tpu_torch.ops.em_kernel import run_em_kernel

        sc = _tensor(shared_counts, device).to(torch.float32)
        nc = _tensor(notshared_counts, device).to(torch.float32)

        def run(bound, state):
            return run_em_kernel(epochs, init_rates, sc, nc, max_iter=bound,
                                 resume_state=state, return_state=True)
    else:
        sc = _tensor(shared_counts, device)
        nc = _tensor(notshared_counts, device)

        def run(bound, state):
            return run_em(epochs, init_rates, sc, nc, max_iter=bound, dtype="float64",
                          resume_state=state, return_state=True, device=device)

    state = None
    if os.path.exists(ckpt_path):
        try:
            with np.load(ckpt_path, allow_pickle=False) as z:
                if str(z["fingerprint"]) == fingerprint and str(z["dtype"]) == wdt_name:
                    state = tuple(z[k] for k in ("it", "rates", "ll", "conv", "iters"))
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            state = None

    die_after = int(os.environ.get("COLATE_EM_DIE_AFTER_CHUNKS", "0"))
    chunk = int(os.environ.get("COLATE_EM_CKPT_CHUNK", str(chunk)))
    chunks_done = 0
    while True:
        it0 = 0 if state is None else int(state[0])
        out = run(min(it0 + chunk, EM_MAX_ITER), state)
        state = (np.int64(out[0]), *(x.cpu().numpy() for x in out[1:]))
        done = bool(state[3].all()) or int(state[0]) >= EM_MAX_ITER
        tmp = ckpt_path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, fingerprint=fingerprint, dtype=wdt_name, it=state[0], rates=state[1],
                     ll=state[2], conv=state[3], iters=state[4])
        os.replace(tmp, ckpt_path)
        chunks_done += 1
        if die_after and chunks_done >= die_after and not done:
            os._exit(17)
        if done:
            break
    os.remove(ckpt_path)
    return state[1].astype(np.asarray(epochs).dtype), state[2], state[4]


def state_from_jax(state):
    """colate_tpu's ``run_em(..., return_state=True)`` tuple (arrays that
    numpy can read) -> a ``resume_state`` for :func:`run_em`."""
    it, rates, ll, conv, iters = (np.asarray(s) for s in state)
    return (
        int(it),
        torch.from_numpy(np.array(rates)),
        torch.from_numpy(np.array(ll, np.float64)),
        torch.from_numpy(np.array(conv, bool)),
        torch.from_numpy(np.array(iters, np.int32)),
    )


def run_em_native(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    max_iter: int = EM_MAX_ITER,
    min_iter: int = EM_MIN_ITER,
):
    """Host (C++) f64 EM, native/em.cpp:cn_em_run — the same fixed point
    and stopping rule as :func:`run_em` with K=1.  Takes and returns numpy:
    (rates [B,E], logl [B], iters [B] i32).  Raises if the native library
    cannot be built or loaded."""
    from colate_tpu_torch import native

    lib = native.load()
    epochs = np.ascontiguousarray(epochs, np.float64)
    E = epochs.shape[0]
    sc = np.ascontiguousarray(shared_counts, np.float64)
    nc = np.ascontiguousarray(notshared_counts, np.float64)
    B, nbins = sc.shape
    t = np.ascontiguousarray(age_bin_centers(), np.float64)
    k = np.clip(np.searchsorted(epochs, t, side="right") - 1, 0, E - 1).astype(np.int32)
    init = np.ascontiguousarray(init_rates, np.float64)
    out_r = np.zeros((B, E), np.float64)
    out_l = np.zeros(B, np.float64)
    out_i = np.zeros(B, np.int32)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_em_run(
        p(epochs), E, p(init), p(sc), p(nc), B, nbins, p(t), p(k),
        int(max_iter), int(min_iter), float(EM_CONV_RATIO), float(COAL_RATE_FLOOR),
        p(out_r), p(out_l), p(out_i),
    )
    return out_r, out_l, out_i
