"""Batched EM for piecewise-constant coalescence rates, in plain torch.

Port of colate_tpu/ops/em.py (the point-age E-step, the M-step and the
K-chunked fixed-point loop with per-replicate freezing).  The bootstrap
batch is a leading dimension written out, where the JAX package vmaps.
The float64 branch follows the reference expression for expression: the
byte identity of ``--sampling mc_parity`` runs rests on it.  Also holds
the port's own ctypes wrapper of the native host EM (``cn_em_run``).

Inputs may be numpy arrays or tensors; results are tensors on ``device``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from colate_tpu.config import (
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
    device="cpu",
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
    # K iterations of improvement each below (1-EM_CONV_RATIO) compound to
    # at most K*(1-EM_CONV_RATIO)
    conv_ratio = 1.0 - K * (1.0 - EM_CONV_RATIO)

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
        newly = (ratio > conv_ratio) & (it + K - 1 > min_iter)
        rates = torch.where(conv[:, None], rates, new_rates)
        ll_prev = torch.where(conv, ll_prev, ll)
        iters = torch.where(conv, iters, torch.full_like(iters, it + K))
        conv = conv | newly
        it += K
    if return_state:
        return it, rates, ll_prev, conv, iters
    return rates.to(out_dtype), ll_prev, iters


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
    from colate_tpu import native

    lib = native.load()
    if lib is None:
        raise RuntimeError("the native library (colate_tpu/native) is unavailable")
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
