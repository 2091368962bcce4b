"""The tree-mode populate (coal_tree::populate) as a torch program.

Port of colate_tpu/ops/tree_kernel.py: ``populate_device`` is the general
form of its XLA program ``_populate_fn`` (tree_kernel.py:47-101), for any
leaf ages; ``populate_device_sorted`` the leaf-zero form, from
``_populate_sorted_fn`` (:104-162), which sorts the [S, N-1] internal ages
on the device where the XLA form needs them sorted already, as the C++
walk ``populate_sorted_native`` (native/em.cpp) sorts them on the host.
Both leaf-zero routes share one gate, ``leaf_zero_applicable`` (a copy).
The programs run in plain torch ops on the ``device`` they are given, a
card or the CPU.

The reference walks each marginal tree sequentially: sort the 2N-1 node
ages, sweep the lineage count k(t), and accumulate per-epoch coalescence
counts and pair exposure (coal_tree.cpp:100-174).  Here a slab of trees
is one batched program over [S, M] tensors:

- sort every row (stable, so ties keep node-index order like the
  reference's pre-sorted coordinate/index pairs);
- the cumulative pair exposure ``G(t) = int_0^t C(k(s),2) ds`` is
  piecewise linear with breakpoints at the sorted node ages: one cumsum
  gives its values there, and it is evaluated at the E epoch edges;
- the last breakpoint at or below each edge comes from
  ``torch.searchsorted(sc, epochs, right=True)`` on the sorted rows: the
  same integers as the reference's compare-and-count, without its
  [S, M, E] comparison tensor;
- coalescence counts per epoch are differences of the cumulative
  internal-node count at the same edges (an event at exactly
  ``epochs[e+1]`` belongs to epoch ``e``; epoch 0 also keeps the events
  at or below ``epochs[0]``; events past the final edge drop,
  coal_tree.cpp:148-158);
- per-tree [E] rows are weighted by span/1e9 (a division, for bit parity
  with the host) and summed into the 5000-tree bootstrap blocks.

Everything is float64 on the device; the coordinates travel as float32
and widen after the sort, as in the XLA program.  Slabs bound memory
only (``SLAB`` rows); the per-tree rows of all slabs are summed into
blocks by one fixed-order reduction (:func:`block_sums`), so the sums do
not depend on the slab size and two runs give bitwise equal sums: no
atomics anywhere.
"""

from __future__ import annotations

import ctypes

import numpy as np

from colate_tpu_torch._torch import torch

SLAB = 1 << 16  # trees a program run takes at most (bounds memory only)

# program runs (one a slab), for callers that check which route ran
program_runs = 0


def block_sums(rows: torch.Tensor, blocks: torch.Tensor, nseg: int) -> torch.Tensor:
    """Sum the rows [S, C] into [nseg, C] by block id, in a fixed order.

    The rows of one block keep their given order (a stable sort of the
    ids), sit in a zero-padded [blocks present, width, C] tensor, and one
    ``torch.sum`` over the width adds them: no atomics, so equal inputs
    give bitwise equal sums on the CPU and on a card.  This stands for
    the XLA programs' ``jax.ops.segment_sum``."""
    S, C = rows.shape
    out = rows.new_zeros((nseg, C))
    if S == 0:
        return out
    blocks = blocks.to(device=rows.device, dtype=torch.int64)
    lo, hi = (int(x) for x in torch.aminmax(blocks))
    if lo < 0 or hi >= nseg:
        raise ValueError(f"block ids in [{lo}, {hi}] outside [0, {nseg})")
    sb, perm = torch.sort(blocks, stable=True)
    present, counts = torch.unique_consecutive(sb, return_counts=True)
    slot = torch.repeat_interleave(torch.arange(present.numel(), device=rows.device), counts)
    pos = torch.arange(S, device=rows.device) - (torch.cumsum(counts, 0) - counts)[slot]
    pad = rows.new_zeros((present.numel(), int(counts.max()), C))
    pad[slot, pos] = rows[perm]
    out[present] = pad.sum(1)
    return out


def _rows_at_edges(sc, cumG, slope, ccnt, epochs, spans, last: int):
    """Per-tree weighted [num | den] rows [S, 2(E-1)] from a tree's
    breakpoints ``sc`` (sorted rows, float64), the exposure ``cumG`` and
    its ``slope`` after each breakpoint, and the coalescences ``ccnt`` up
    to each (None: the breakpoint's index, the sorted form's count)."""
    S = sc.shape[0]
    E = epochs.shape[0]
    le = torch.searchsorted(sc, epochs.expand(S, E).contiguous(), right=True)
    idx = le - 1  # last breakpoint <= edge
    valid = idx >= 0
    idxc = idx.clamp(0, last)
    take = lambda a: torch.gather(a, 1, idxc)
    slope_at = slope[idxc] if slope.dim() == 1 else take(slope)
    g_at = torch.where(valid, take(cumG) + slope_at * (epochs[None, :] - take(sc)), 0.0)
    c_at = torch.where(valid, idx if ccnt is None else take(ccnt), 0).to(torch.float64)
    w = (spans / 1e9)[:, None]  # divide, not *1e-9: bit parity with host
    num_t = torch.diff(c_at, dim=1)  # [S, E-1]: epochs 0..E-2
    # epoch 0 collects every event with age <= epochs[1], those at or
    # below epochs[0] included (zero-branch-length trees coalesce at
    # exactly 0), as the host oracle and the reference sweep count them
    num_t[:, 0] = c_at[:, 1]
    return torch.cat([num_t * w, torch.diff(g_at, dim=1) * w], dim=1)


def _general_rows(coords, spans, epochs, N: int):
    """Rows of ``_populate_fn``: coords [S, M] float32, any node order."""
    S, M = coords.shape
    sc32, order = torch.sort(coords, dim=1, stable=True)
    sc = sc32.to(torch.float64)
    is_leaf = order < N
    k = torch.cumsum(torch.where(is_leaf, 1, -1), dim=1)  # lineage count [S, M]
    kf = k[:, :-1].to(torch.float64)
    pairs = kf * (kf - 1.0) * 0.5  # C(k,2) on [sc[j], sc[j+1]]  [S, M-1]
    zero = sc.new_zeros((S, 1))
    # G at breakpoint sc[j]; slope after sc[j] is pairs[j] (0 past root)
    cumG = torch.cat([zero, torch.cumsum(pairs * (sc[:, 1:] - sc[:, :-1]), dim=1)], dim=1)
    slope = torch.cat([pairs, zero], dim=1)
    ccnt = torch.cumsum(~is_leaf, dim=1, dtype=torch.float64)
    return _rows_at_edges(sc, cumG, slope, ccnt, epochs, spans, M - 1)


def _sorted_rows(ia, spans, epochs, N: int):
    """Rows of ``_populate_sorted_fn``: ia [S, K] float32 internal ages in
    any order, leaves at 0.  Sorted, the internal ages follow all N
    leaves in the general form's stable order, so the lineage count after
    internal event i is N-i and the sweep is one cumsum over the K=N-1
    internal ages."""
    ia = torch.sort(ia, dim=1).values
    S, K = ia.shape
    kk = N - torch.arange(K + 1, dtype=torch.float64, device=ia.device)
    slope = kk * (kk - 1.0) * 0.5  # [K+1]: slope after breakpoint i
    zero = torch.zeros((S, 1), dtype=torch.float64, device=ia.device)
    sc0 = torch.cat([zero, ia.to(torch.float64)], dim=1)  # [S, K+1] breakpoints
    cumG = torch.cat([zero, torch.cumsum(slope[None, :-1] * torch.diff(sc0, dim=1), dim=1)], dim=1)
    return _rows_at_edges(sc0, cumG, slope, None, epochs, spans, K)


def _populate(rows_fn, coords, spans, blocks, epochs, n_hap: int, num_blocks: int, device):
    """Runs rows_fn over slabs of ``coords`` on ``device``, then one
    fixed-order block reduction; ([nseg, E], [nseg, E]) float64 numpy,
    the final epoch zero (the reference sweep stops at the last edge)."""
    global program_runs
    device = torch.device(device)
    T = coords.shape[0]
    E = int(epochs.shape[0])
    nseg = max(int(num_blocks), 1)
    num = np.zeros((nseg, E), np.float64)
    den = np.zeros((nseg, E), np.float64)
    if T == 0 or E < 2:
        return num, den
    ep = torch.as_tensor(np.asarray(epochs, np.float64), device=device)
    sp = torch.as_tensor(spans, dtype=torch.float64, device=device)
    rows = torch.empty((T, 2 * (E - 1)), dtype=torch.float64, device=device)
    for i in range(0, T, SLAB):
        c = torch.as_tensor(coords[i : i + SLAB], dtype=torch.float32, device=device)
        rows[i : i + SLAB] = rows_fn(c, sp[i : i + SLAB], ep, int(n_hap))
        program_runs += 1
    sums = block_sums(rows, torch.as_tensor(blocks, device=device), nseg).cpu().numpy()
    num[:, :-1] = sums[:, : E - 1]
    den[:, :-1] = sums[:, E - 1 :]
    return num, den


def populate_device(coords, spans, blocks, epochs, n_hap: int, num_blocks: int, device):
    """Batched coal_tree::populate on ``device`` (a card or the CPU).

    coords: [T, 2N-1] float32 node ages (numpy, or a tensor already on
    ``device``); spans: [T] float64 genome span per tree; blocks: [T]
    block index of each tree; epochs: [E] float64.  Returns
    ([num_blocks, E], [num_blocks, E]) float64 num/denom sums."""
    return _populate(_general_rows, coords, spans, blocks, epochs, n_hap, num_blocks, device)


def populate_device_sorted(coords, spans, blocks, epochs, n_hap: int, num_blocks: int, device):
    """The leaf-zero populate on ``device``; the caller must have checked
    :func:`leaf_zero_applicable`.  Arguments and result as
    :func:`populate_device`; only the internal ages ``coords[:, N:]``
    travel to the device, where a sort of each row replaces the general
    form's sort of all 2N-1 ages."""
    return _populate(_sorted_rows, coords[:, n_hap:], spans, blocks, epochs, n_hap,
                     num_blocks, device)


def leaf_zero_applicable(coords: np.ndarray, n_hap: int) -> bool:
    """True when every leaf age is 0 (contemporaneous samples): the
    leaf-zero forms apply, :func:`populate_device_sorted` on a device and
    :func:`populate_sorted_native` on the host, both of which sort the
    internal ages themselves (ages recomputed from a parsed ``.anc``'s
    5-decimal branch lengths carry small inversions)."""
    N = n_hap
    leaf = coords[:, :N]
    return leaf.size > 0 and coords.shape[1] > N and bool((leaf == 0.0).all())


def populate_sorted_native(coords, spans, blocks, epochs, n_hap: int, num_blocks: int):
    """C++ twin of the leaf-zero form (native/em.cpp:cn_tree_populate_sorted):
    one monotone walk per tree, threaded over contiguous tree ranges; the
    host route of ``--torch_device cpu``.  Needs leaf ages all 0
    (:func:`leaf_zero_applicable`); raises if the library cannot be built
    or loaded."""
    from colate_tpu_torch import native

    lib = native.load()
    T, M = coords.shape
    N = int(n_hap)
    K = N - 1
    E = epochs.shape[0]
    nseg = max(int(num_blocks), 1)
    num = np.zeros((nseg, E), np.float64)
    den = np.zeros((nseg, E), np.float64)
    if T == 0:
        return num, den
    ia = np.ascontiguousarray(coords[:, N:], np.float32)
    sp = np.ascontiguousarray(spans, np.float64)
    bl = np.ascontiguousarray(blocks, np.int32)
    ep = np.ascontiguousarray(epochs, np.float64)
    pp = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_tree_populate_sorted(
        T, K, N, pp(ia), pp(sp), pp(bl), pp(ep), E, nseg, 0, pp(num), pp(den),
    )
    return num, den
