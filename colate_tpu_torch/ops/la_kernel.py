"""The local-ancestry accumulation (coal_LA) as a torch program.

Port of colate_tpu/ops/la_kernel.py: ``la_accumulate_device`` runs its
XLA program ``_la_fn`` (la_kernel.py:53-131) in plain torch ops on the
``device`` it is given, a card or the CPU; ``pair_keys``,
``la_accumulate_native`` (the C++ twin, native/la.cpp) and
``la_accumulate_host`` (the numpy twin, :254-359) are copies.

The reference walks every unordered leaf pair per coalescence event per
tree (coal_tree.cpp:447-527).  Here a slab of (tree, segment) items is one
batched program over [S, K] tensors (K = N-1 internal nodes):

- subtree leaf-group counts come from one ascending-index pass over the
  parent vector: M-1 ``index_add_`` calls, each adding a column's [S, G]
  counts into the parents' rows.  Within a column every row has one
  parent, so a call adds into each target once: on a card its atomic
  adds never meet, and the counts are exact and the same from run to
  run;
- per internal node u the unordered pair count into sorted group key
  (p >= q) is ``n1[p]n2[q] + n1[q]n2[p]`` (off-diagonal) / ``n1[p]n2[p]``
  (diagonal) with n1, n2 the children's count vectors: P = G(G+1)/2 keys;
- the per-epoch pair exposure ``H(t) = sum_u cnt_u min(age_u, t)`` is
  piecewise linear with breakpoints at the sorted node ages: two cumsums
  give its values there, and ``torch.searchsorted`` on the sorted ages
  finds the last one at or below each epoch edge (the reference's
  compare-and-count without its [S, K, E] tensor);
  ``den[e] = H(ep[e+1]) - H(ep[e])``, the last (open) epoch 0;
- event counts per epoch are differences of the cumulative
  count-weighted mass at the inner edges (ages at exactly an edge fall in
  the lower epoch; everything above the last edge lands in the open
  epoch).

Everything is float64.  Slabs bound memory only (``SLAB`` items); the
per-item rows of all slabs are summed into blocks by one fixed-order
reduction (ops/tree_kernel.py:block_sums), so the sums do not depend on
the slab size and two runs give bitwise equal sums.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from colate_tpu_torch._torch import torch
from colate_tpu_torch.ops.tree_kernel import block_sums

SLAB = 1 << 16  # items a program run takes at most (bounds memory only)

# program runs (one a slab), for callers that check which route ran
program_runs = 0


def pair_keys(G: int) -> list[tuple[int, int]]:
    """Sorted group keys (p >= q) in a fixed order shared host/device."""
    return [(p, q) for p in range(G) for q in range(p + 1)]


def _la_rows(parent, ages, lab, c1, c2, w, epochs, N: int, G: int):
    """Weighted [num | den] rows [S, 2 E P] of ``_la_fn`` for one slab:
    parent [S, M] int32; ages [S, K] float64 internal-node ages; lab
    [S, N] int32 leaf groups; c1/c2 [S, K] int32 children; w [S] float64."""
    S, M = parent.shape
    K = N - 1
    E = epochs.shape[0]
    keys = pair_keys(G)
    P = len(keys)
    dev = parent.device
    f64 = torch.float64
    # group counts per node, [S, M+1, G] flat; column M takes the root's
    # (absent) parent, so the pass needs no mask
    C = torch.zeros((S * (M + 1), G), dtype=f64, device=dev)
    C3 = C.view(S, M + 1, G)
    C3[:, :N, :] = torch.nn.functional.one_hot(lab.long(), G).to(f64)
    par = torch.where(parent >= 0, parent.long(), M)
    tgt = (torch.arange(S, device=dev)[:, None] * (M + 1) + par).t().contiguous()  # [M, S]
    for j in range(M - 1):
        C.index_add_(0, tgt[j], C3[:, j, :])
    C3 = C3[:, :M]
    n1 = torch.gather(C3, 1, c1.long()[:, :, None].expand(S, K, G))  # [S, K, G]
    n2 = torch.gather(C3, 1, c2.long()[:, :, None].expand(S, K, G))
    cols = []
    for p, q in keys:
        if p == q:
            cols.append(n1[:, :, p] * n2[:, :, p])
        else:
            cols.append(n1[:, :, p] * n2[:, :, q] + n1[:, :, q] * n2[:, :, p])
    cnt = torch.stack(cols, dim=2)  # [S, K, P]

    sa, order = torch.sort(ages.contiguous(), dim=1, stable=True)  # [S, K]
    scnt = torch.gather(cnt, 1, order[:, :, None].expand(S, K, P))
    ccnt = torch.cumsum(scnt, dim=1)  # [S, K, P]
    cA = torch.cumsum(scnt * sa[:, :, None], dim=1)
    total = ccnt[:, -1, :]  # [S, P]

    if E == 1:
        # single-epoch grid: the one (open) epoch collects every event
        # and accrues no exposure (the reference sweep stops at the last
        # edge)
        num = total[:, None, :]
        den = torch.zeros((S, 1, P), dtype=f64, device=dev)
    else:
        # mass of ages <= each epoch edge
        le = torch.searchsorted(sa, epochs.expand(S, E).contiguous(), right=True)  # [S, E]
        idx = (le - 1).clamp(0, K - 1)[:, :, None].expand(S, E, P)
        has = (le > 0)[:, :, None]
        cnt_at = torch.where(has, torch.gather(ccnt, 1, idx), 0.0)
        A_at = torch.where(has, torch.gather(cA, 1, idx), 0.0)
        # H(t) = sum cnt min(age, t)  ->  den[e] = H(ep[e+1]) - H(ep[e])
        H = A_at + epochs[None, :, None] * (total[:, None, :] - cnt_at)
        den = torch.cat(
            [H[:, 1:, :] - H[:, :-1, :], torch.zeros((S, 1, P), dtype=f64, device=dev)], dim=1
        )  # [S, E, P]; open epoch contributes 0 (reference sweep stops)
        m = cnt_at[:, 1:, :]  # cumulative event mass at epochs[1..E-1]
        num = torch.cat(
            [m[:, :1, :], m[:, 1:, :] - m[:, :-1, :], total[:, None, :] - m[:, -1:, :]],
            dim=1,
        )  # [S, E, P]
    wnum = (num * w[:, None, None]).reshape(S, E * P)
    wden = (den * w[:, None, None]).reshape(S, E * P)
    return torch.cat([wnum, wden], dim=1)


def la_accumulate_device(
    parent, ages, lab, c1, c2, w, blocks, epochs, num_groups: int, num_blocks: int, device,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched coal_LA accumulation on ``device`` (a card or the CPU).

    parent: [S, 2N-1] int32; ages: [S, N-1] float64 internal-node ages;
    lab: [S, N] int32 leaf groups; c1/c2: [S, N-1] int32 children of each
    internal node; w: [S] float64 item weights (span*frac/1e9); blocks:
    [S] block ids in [0, num_blocks).  Arrays are numpy, or tensors
    already on ``device``.  Returns ([nb, E, P], [nb, E, P]) float64 numpy
    with P = G(G+1)/2 keys in ``pair_keys`` order."""
    global program_runs
    device = torch.device(device)
    Sn, M = parent.shape
    N = (M + 1) // 2
    E = int(epochs.shape[0])
    G = int(num_groups)
    P = len(pair_keys(G))
    nseg = max(int(num_blocks), 1)
    if Sn == 0:
        return np.zeros((nseg, E, P)), np.zeros((nseg, E, P))
    ep = torch.as_tensor(np.asarray(epochs, np.float64), device=device)
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    rows = torch.empty((Sn, 2 * E * P), dtype=torch.float64, device=device)
    for i in range(0, Sn, SLAB):
        sl = slice(i, i + SLAB)
        rows[sl] = _la_rows(
            on(parent[sl], torch.int32), on(ages[sl], torch.float64), on(lab[sl], torch.int32),
            on(c1[sl], torch.int32), on(c2[sl], torch.int32), on(w[sl], torch.float64), ep, N, G,
        )
        program_runs += 1
    sums = block_sums(rows, torch.as_tensor(blocks, device=device), nseg).cpu().numpy()
    return sums[:, : E * P].reshape(nseg, E, P), sums[:, E * P :].reshape(nseg, E, P)


def la_accumulate_native(
    parent, ages, lab, c1, c2, w, blocks, epochs, num_groups: int, num_blocks: int,
) -> tuple[np.ndarray, np.ndarray]:
    """C++ twin (native/la.cpp): no multi-MB temporaries, threaded over
    items; the host route of ``--torch_device cpu``.  Raises if the
    library cannot be built or loaded.

    ``COLATE_LA_THREADS=<n>`` pins the thread count (the per-thread
    partials are merged in thread order, so a fixed count fixes the f64
    reduction order: byte-reproducible outputs across machines with
    different core counts)."""
    from colate_tpu_torch import native

    lib = native.load()
    try:
        nthreads = int(os.environ.get("COLATE_LA_THREADS", "0"))
    except ValueError:
        nthreads = 0

    S, M = parent.shape
    N = (M + 1) // 2
    E = epochs.shape[0]
    Pk = len(pair_keys(num_groups))
    nseg = max(int(num_blocks), 1)
    num = np.zeros((nseg, E, Pk), np.float64)
    den = np.zeros((nseg, E, Pk), np.float64)
    if S == 0:
        return num, den
    c = np.ascontiguousarray
    pp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    pa = c(parent, dtype=np.int32)
    ag = c(ages, dtype=np.float64)
    lb = c(lab, dtype=np.int32)
    cc1 = c(c1, dtype=np.int32)
    cc2 = c(c2, dtype=np.int32)
    ww = c(w, dtype=np.float64)
    bb = c(blocks, dtype=np.int32)
    ep = c(epochs, dtype=np.float64)
    lib.cn_la_accumulate(
        S, M, N, num_groups, E, pp(pa), pp(ag), pp(lb), pp(cc1), pp(cc2),
        pp(ww), pp(bb), pp(ep), nseg, nthreads, pp(num), pp(den),
    )
    return num, den


def la_accumulate_host(
    parent, ages, lab, c1, c2, w, blocks, epochs, num_groups: int, num_blocks: int,
) -> tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`la_accumulate_device` (same math, same
    [nb, E, P] layout): the plain version the program is held to.

    Items stream through bounded chunks (~1<<24 scratch elements) so
    peak memory stays flat regardless of chromosome length."""
    Sn, M = parent.shape
    N = (M + 1) // 2
    K = N - 1
    E = epochs.shape[0]
    G = num_groups
    keys = pair_keys(G)
    P = len(keys)
    nseg = max(int(num_blocks), 1)
    num = np.zeros((nseg, E, P), np.float64)
    den = np.zeros((nseg, E, P), np.float64)
    if Sn == 0:
        return num, den
    # the largest per-item temporaries are [S, M, G] and [S, K, E·P]
    chunk = max(1, (1 << 24) // max(M * G, K * max(E * P, G * 2), 1))

    for i0 in range(0, Sn, chunk):
        sl = slice(i0, min(i0 + chunk, Sn))
        par_c, ages_c, lab_c = parent[sl], ages[sl], lab[sl]
        c1_c, c2_c, w_c, blk_c = c1[sl], c2[sl], w[sl], blocks[sl]
        S = par_c.shape[0]

        C = np.zeros((S, M, G), np.float64)
        C[np.arange(S)[:, None], np.arange(N)[None, :], lab_c] = 1.0
        rows = np.arange(S)
        for j in range(M - 1):
            p = par_c[:, j]
            v = p >= 0
            # one write per row per level (parents are unique within a
            # row), so plain fancy-index += is safe and much faster
            # than add.at
            C[rows[v], p[v]] += C[v, j]
        n1 = C[rows[:, None], c1_c]  # [S, K, G]
        n2 = C[rows[:, None], c2_c]
        cnt = np.empty((S, K, P), np.float64)
        for ki, (p, q) in enumerate(keys):
            if p == q:
                cnt[:, :, ki] = n1[:, :, p] * n2[:, :, p]
            else:
                cnt[:, :, ki] = (
                    n1[:, :, p] * n2[:, :, q] + n1[:, :, q] * n2[:, :, p]
                )

        order = np.argsort(ages_c, axis=1, kind="stable")
        sa = np.take_along_axis(ages_c, order, axis=1)
        scnt = np.take_along_axis(cnt, order[:, :, None], axis=1)
        ccnt = np.cumsum(scnt, axis=1)
        cA = np.cumsum(scnt * sa[:, :, None], axis=1)
        total = ccnt[:, -1, :]

        if E == 1:
            # single (open) epoch: all events, no exposure
            num_i = total[:, None, :]
            den_i = np.zeros((S, 1, P))
        else:
            le = (sa[:, :, None] <= epochs[None, None, :]).sum(axis=1)
            idx = np.clip(le - 1, 0, K - 1)[:, :, None]
            has = (le > 0)[:, :, None]
            cnt_at = np.where(
                has, np.take_along_axis(ccnt, idx, axis=1), 0.0
            )
            A_at = np.where(has, np.take_along_axis(cA, idx, axis=1), 0.0)
            H = A_at + epochs[None, :, None] * (total[:, None, :] - cnt_at)
            den_i = np.concatenate(
                [H[:, 1:, :] - H[:, :-1, :], np.zeros((S, 1, P))], axis=1
            )
            m = cnt_at[:, 1:, :]
            num_i = np.concatenate(
                [m[:, :1, :], m[:, 1:, :] - m[:, :-1, :],
                 total[:, None, :] - m[:, -1:, :]],
                axis=1,
            )
        wnum = (num_i * w_c[:, None, None]).reshape(S, E * P)
        wden = (den_i * w_c[:, None, None]).reshape(S, E * P)
        if np.all(blk_c[1:] >= blk_c[:-1]):
            # blocks follow tree order (nondecreasing): one reduceat pass
            present = np.unique(blk_c)
            starts = np.searchsorted(blk_c, present, side="left")
            num[present] += np.add.reduceat(wnum, starts, axis=0).reshape(
                present.size, E, P
            )
            den[present] += np.add.reduceat(wden, starts, axis=0).reshape(
                present.size, E, P
            )
        else:
            np.add.at(num, blk_c, wnum.reshape(S, E, P))
            np.add.at(den, blk_c, wden.reshape(S, E, P))
    return num, den
