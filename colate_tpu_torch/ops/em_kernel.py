"""The fused float32 EM step: CUDA kernel, its plain torch twin, and the
convergence loop around them.

Port of colate_tpu/ops/em_pallas.py.  One call of :func:`em_chunk` runs
K whole EM iterations (E-step over the 185 age bins, count-weighted
reduction, M-step) for every bootstrap replicate and returns the per-bin
log-likelihood terms of the K-th E-step.  On a CUDA tensor it launches
the hand-written kernel ``csrc/em_step.cu``; on a CPU tensor it runs
:func:`em_chunk_reference`, plain torch that computes what the kernel
computes.  :func:`run_em_kernel` drives the chunks to convergence
through the loop of ops/em.py:run_em.

The public layout is the JAX package's: rates ``[B, E]``, counts
``[B, 185]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from colate_tpu.config import (
    COAL_RATE_FLOOR,
    EM_MAX_ITER,
    EM_MIN_ITER,
    NUM_AGE_BINS,
    age_bin_centers,
)
from colate_tpu_torch.ops.em import _rsuffix, run_em

# kernel launches made by em_chunk (read by chip_smoke.py to show that a
# run went through the kernel)
launches = 0


@functools.cache
def kernel_library():
    """The built ``em_step`` library (compiled at first use)."""
    from colate_tpu_torch._build import build

    b = build("em_step.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    b.lib.em_step_f32.restype = I
    b.lib.em_step_f32.argtypes = [P] * 12 + [I, I, I, I, ctypes.c_float, P]
    b.lib.em_step_max_epochs.restype = I
    b.lib.em_step_max_epochs.argtypes = []
    b.lib.em_step_error_string.restype = ctypes.c_char_p
    b.lib.em_step_error_string.argtypes = [I]
    return b


def bin_constants(epochs) -> dict:
    """Rate-independent constants of the step (em_pallas.py:_bin_constants).

    ``k``, ``t - epochs[k]`` and ``epochs[min(k+1, E-1)]`` are computed in
    float64 on the host and only then cast to float32, as the TPU kernel's
    constants are.  Returns numpy arrays: per bin ``t``, ``tmk``, ``tk1``
    (f32) and ``k`` (i32); per epoch ``epochs``, ``dt`` (0 for the open
    last epoch) and ``enext`` (0 for the last epoch), all f32.
    """
    epochs = np.asarray(epochs, np.float64)
    E = epochs.shape[0]
    t = age_bin_centers()
    k = np.clip(np.searchsorted(epochs, t, side="right") - 1, 0, E - 1)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return dict(
        t=f32(t),
        tmk=f32(t - epochs[k]),
        tk1=f32(epochs[np.minimum(k + 1, E - 1)]),
        k=np.ascontiguousarray(k, np.int32),
        epochs=f32(epochs),
        dt=f32(np.append(np.diff(epochs), 0.0)),
        enext=f32(np.append(epochs[1:], 0.0)),
    )


@functools.lru_cache(maxsize=8)
def _device_constants(epochs_key: bytes, device: str) -> dict:
    c = bin_constants(np.frombuffer(epochs_key, np.float64))
    return {name: torch.as_tensor(a, device=device) for name, a in c.items()}


def _constants(epochs, device: torch.device) -> dict:
    key = np.ascontiguousarray(epochs, np.float64).tobytes()
    return _device_constants(key, str(device))


def _iteration_reference(c: dict, lam, sc, nc):
    """One EM iteration of the kernel in plain torch: rates [B,E] ->
    (rates' [B,E], per-bin logl terms [B,N])."""
    B, E = lam.shape
    ep, dt, en = c["epochs"], c["dt"], c["enext"]
    e_idx = torch.arange(E, device=lam.device)
    last = e_idx == E - 1
    zero = lam.new_zeros(())
    one = lam.new_ones(())

    # epoch tables (em_pallas.py:_epoch_tables_t), sequential hazard prefix
    dH = lam * dt
    H = torch.cat([lam.new_zeros(B, 1), torch.cumsum(dH[:, :-1], 1)], 1)
    S = torch.exp(-H)
    em1 = -torch.expm1(-dH)
    pos = lam > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, lam, one), zero)
    P = torch.where(last, torch.where(pos, S, zero), S * em1)
    T1 = torch.where(last, (ep + inv) * S, S * ((en + inv) * em1 - dt))
    T1 = torch.where(pos, T1, zero)
    em1_full = torch.where(last, one, em1)

    k = c["k"].long()
    t, tmk, tk1 = c["t"], c["tmk"], c["tk1"]
    klt = k < E - 1
    m_lt = e_idx[None, :] < k[:, None]  # [N, E]
    m_eq = e_idx[None, :] == k[:, None]
    m_le = m_lt | m_eq
    m_gt = e_idx[None, :] > k[:, None]
    lam_k, H_k, S_k, inv_k = lam[:, k], H[:, k], S[:, k], inv[:, k]  # [B, N]
    lam_k_pos = lam_k > 0

    # shared: T < t
    dH_lo = lam_k * tmk
    H_t = H_k + dH_lo
    em1_lo = -torch.expm1(-dH_lo)
    Pk_minus = S_k * em1_lo
    T1k_minus = torch.where(lam_k_pos, S_k * ((t + inv_k) * em1_lo - tmk), zero)
    num_lin = torch.where(m_lt, P[:, None, :], torch.where(m_eq, Pk_minus[..., None], zero))
    T1v = torch.where(m_lt, T1[:, None, :], torch.where(m_eq, T1k_minus[..., None], zero))
    Z_s = -torch.expm1(-H_t)
    guard_s = Z_s > 0
    zinv = torch.where(guard_s, 1.0 / torch.where(guard_s, Z_s, one), zero)[..., None]
    post = num_lin * zinv
    integ = (_rsuffix(num_lin) - num_lin) * zinv
    den = T1v * zinv - ep * post + dt * integ
    den = torch.clamp(torch.where(m_le, den, zero), min=0.0)
    num_s = torch.where(guard_s[..., None], post, zero)
    den_s = torch.where(guard_s[..., None], den, zero)

    # notshared: T > t, hazard-relative
    dH_hi = torch.where(klt, lam_k * (tk1 - t), zero)
    em1_hi = -torch.expm1(-dH_hi)
    Srel = torch.exp(-torch.where(m_gt, H[:, None, :] - H_t[..., None], zero))
    pos3 = pos[:, None, :]
    P_rel = torch.where(last, torch.where(pos3, Srel, zero), Srel * em1_full[:, None, :])
    T1_rel = torch.where(
        last,
        (ep + inv[:, None, :]) * Srel,
        Srel * ((en + inv[:, None, :]) * em1_full[:, None, :] - dt),
    )
    T1_rel = torch.where(pos3, T1_rel, zero)
    Pk_plus = torch.where(klt, em1_hi, torch.where(lam_k_pos, one, zero))
    T1k_plus = torch.where(
        klt,
        torch.where(lam_k_pos, (tk1 + inv_k) * em1_hi - (tk1 - t), zero),
        torch.where(lam_k_pos, t + inv_k, zero),
    )
    raw_n = torch.where(m_eq, Pk_plus[..., None], torch.where(m_gt, P_rel, zero))
    raw_t = torch.where(m_eq, T1k_plus[..., None], torch.where(m_gt, T1_rel, zero))
    zrel = raw_n.sum(-1)
    guard_n = zrel > 0
    zrel_inv = torch.where(guard_n, 1.0 / torch.where(guard_n, zrel, one), zero)[..., None]
    post_n = raw_n * zrel_inv
    integ_n = (_rsuffix(raw_n) - raw_n) * zrel_inv
    den_n = torch.clamp(raw_t * zrel_inv - ep * post_n + dt * integ_n, min=0.0)
    num_n = torch.where(guard_n[..., None], post_n, zero)
    den_n = torch.where(guard_n[..., None], den_n, zero)

    # count-weighted reduction over bins
    sc3, nc3 = sc[..., None], nc[..., None]
    num_tot = (sc3 * num_s + nc3 * num_n).sum(1)
    den_tot = (sc3 * den_s + nc3 * den_n).sum(1)
    logl_s = torch.where(guard_s, torch.log(torch.where(guard_s, Z_s, one)), zero)
    logl_n = torch.where(guard_n, torch.log(torch.where(guard_n, zrel, one)) - H_t, zero)
    wsum = sc * logl_s + nc * logl_n

    # M-step (em_pallas.py kernel m_step): floor, keep-old, fill-forward
    den_pos = den_tot > 0
    ratio = torch.where(den_pos, num_tot / torch.where(den_pos, den_tot, one), zero)
    ratio = torch.clamp(ratio, min=COAL_RATE_FLOOR)
    chosen = torch.where(den_pos, ratio, lam)
    idx = torch.cummax(torch.where(num_tot != 0, e_idx, -1), 1).values
    new = torch.where(idx >= 0, torch.gather(chosen, 1, idx.clamp(min=0)), zero)
    return new, wsum


def em_chunk_reference(epochs, rates, sc, nc, K: int):
    """K EM iterations in plain torch, computing what the CUDA kernel
    computes (the difference form of the exposure, ``-expm1(-x)`` for
    ``1-exp(-x)``).

    epochs: [E] float64 (numpy); rates [B,E], sc/nc [B,185] float32
    tensors on one device.  Returns (rates after K iterations [B,E] f32,
    per-bin logl terms of the K-th E-step [B,185] f32)."""
    c = _constants(epochs, rates.device)
    wsum = None
    for _ in range(int(K)):
        rates, wsum = _iteration_reference(c, rates, sc, nc)
    return rates, wsum


def _check(rates, sc, nc, E: int):
    for name, x in (("rates", rates), ("shared_counts", sc), ("notshared_counts", nc)):
        if x.dtype != torch.float32:
            raise TypeError(f"em_chunk: {name} must be float32, got {x.dtype}")
        if x.device != rates.device:
            raise ValueError(f"em_chunk: {name} is on {x.device}, rates on {rates.device}")
        if not x.is_contiguous():
            raise ValueError(f"em_chunk: {name} must be contiguous")
    B = rates.shape[0]
    if rates.shape != (B, E):
        raise ValueError(f"em_chunk: rates {tuple(rates.shape)} != ({B}, {E})")
    for name, x in (("shared_counts", sc), ("notshared_counts", nc)):
        if x.shape != (B, NUM_AGE_BINS):
            raise ValueError(f"em_chunk: {name} {tuple(x.shape)} != ({B}, {NUM_AGE_BINS})")


def em_chunk(epochs, rates, sc, nc, K: int):
    """K fused EM iterations: the CUDA kernel for CUDA tensors, the plain
    torch twin for CPU tensors; any other device raises.  Arguments and
    results as :func:`em_chunk_reference`."""
    global launches
    epochs = np.asarray(epochs, np.float64)
    E = epochs.shape[0]
    _check(rates, sc, nc, E)
    if rates.device.type == "cpu":
        return em_chunk_reference(epochs, rates, sc, nc, K)
    if rates.device.type != "cuda":
        raise ValueError(f"em_chunk: no kernel for device {rates.device}")
    lib = kernel_library().lib
    if E > lib.em_step_max_epochs():
        raise ValueError(
            f"em_chunk: {E} epochs exceed the kernel's {lib.em_step_max_epochs()}"
        )
    B = rates.shape[0]
    N = sc.shape[1]
    out = torch.empty_like(rates)
    wsum = torch.empty_like(sc)
    if B == 0:
        return out, wsum
    c = _constants(epochs, rates.device)
    p = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(rates.device):
        err = lib.em_step_f32(
            p(rates), p(sc), p(nc), p(c["t"]), p(c["tmk"]), p(c["tk1"]),
            p(c["k"]), p(c["epochs"]), p(c["dt"]), p(c["enext"]),
            p(out), p(wsum), B, E, N, int(K), COAL_RATE_FLOOR,
            ctypes.c_void_p(torch.cuda.current_stream(rates.device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(
            f"em_step_f32 launch failed: {lib.em_step_error_string(err).decode()}"
        )
    launches += 1
    return out, wsum


def run_em_kernel(
    epochs,
    init_rates,
    shared_counts,
    notshared_counts,
    max_iter: int = EM_MAX_ITER,
    min_iter: int = EM_MIN_ITER,
    check_every: int = 8,
):
    """EM to convergence with the fused f32 step (em_pallas.py:run_em_pallas).

    epochs [E] and init_rates [E]: numpy float64; shared/notshared_counts:
    [B,185] tensors, whose device picks the kernel (CUDA) or the twin
    (CPU).  The loop is ops/em.py:run_em's with K=check_every, each chunk
    one :func:`em_chunk` whose per-bin logl terms are summed in f64; the
    host reads the convergence flags once per chunk.

    Returns (rates [B,E] f64, logl [B] f64, iters [B] i32) on the counts'
    device."""
    epochs = np.asarray(epochs, np.float64)
    sc = shared_counts.to(torch.float32).contiguous()
    nc = notshared_counts.to(torch.float32).contiguous()

    def chunk(rates, K):
        new_rates, wsum = em_chunk(epochs, rates.contiguous(), sc, nc, K)
        return new_rates, wsum.to(torch.float64).sum(1)

    return run_em(
        epochs, init_rates, sc, nc, max_iter, min_iter, dtype="float32",
        check_every=check_every, device=sc.device, step=chunk,
    )
