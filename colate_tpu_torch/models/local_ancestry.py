"""CoalRate mode ``local_ancestry``: group-pair coalescence rates.

Port of colate_tpu/models/local_ancestry.py.  The host code (the span
splitting across ancestry segments, the ancient-sample path, the dump,
the poplabels reader, the run loop) is copied; the accumulation of modern
samples dispatches as the port does (:class:`CoalLA`).

Reference: ``coal_localancestry`` (coal/coal.cpp:206-590) +
``coal_LA`` (coal_tree.cpp:302-654).  Per marginal tree and ancestry
segment, every unordered leaf pair (m1, m2) that coalesces at internal
node u contributes, into the (sorted) group pair of its members:

    num[g1,g2, epoch(age_u)]  += span/1e9
    denom[g1,g2, e]           += span/1e9 * |[pair_age, age_u] & epoch_e|

where pair_age = max sample age of the two leaves (0 for modern data).

Instead of the reference's per-pair nested loops (O(N^2) per
coalescence), pairs are counted by group: with subtree group-count
vectors n1, n2 of the coalescing children, the unordered pair count into
sorted key (p>=q) is n1[p]n2[q]+n1[q]n2[p] (p>q) / n1[p]n2[p] (p==q), an
outer product per internal node, batched over all trees of a chromosome
(ops/la_kernel.py).  Per-pair ages only arise with ancient samples,
handled by a grouped numpy path, as in the reference.

Quirks of coal_localancestry replicated: span splitting across
ancestry-segment boundaries (coal.cpp:513-564) including the
final-fragment `frac` that is NOT scaled by the tree span (a reference bug, coal.cpp:561); tree
bp ranges from mut-row midpoints with int truncation; bootstrap seeded
with the fixed value 1 and proper [0, num_blocks-1] draws
(coal_tree.cpp:532).  For the last tree of a chromosome the reference
reads past the mut array (bp_end is heap garbage, coal.cpp:503-507); in
practice that memory holds 0 so the tree never splits: the whole span
goes to the current segment.
"""

from __future__ import annotations

import ctypes
import sys
import time
from typing import TYPE_CHECKING

import numpy as np

from colate_tpu_torch.formats.anc import AncFile, node_ages
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.formats.sample import Sample
from colate_tpu_torch.hostrng import MT19937
from colate_tpu_torch.models.tree_coal import BLOCK_SIZE_TREES, epochs_from_bins_tree, tree_spans
from colate_tpu_torch.utils.progress import log_event

if TYPE_CHECKING:
    import torch


def _tree_bp_ranges(anc: AncFile, mut: MutTable):
    """Per tree: (bp_start, bp_end) midpoint ranges.

    bp_start = pos of first row, averaged (int-truncated) with previous
    row's pos when one exists; bp_end likewise with the row after the
    tree.  The last tree with rows gets bp_end=0 (reference UB, see
    module docstring).  Treeless trees get the NEXT tree's bp_start and
    span 0."""
    T = anc.num_trees
    n = len(mut)
    if n == 0 or T == 0:
        return np.zeros(T, np.int64), np.zeros(T, np.int64)
    tree_of_row = mut.tree
    pos = mut.pos.astype(np.int64)
    # rows are grouped by nondecreasing tree index: per-tree row ranges
    # are two searchsorteds (no cursor loop over T)
    row_lo = np.searchsorted(tree_of_row, np.arange(T), side="left")
    row_hi = np.searchsorted(tree_of_row, np.arange(T), side="right")
    i0 = np.minimum(row_lo, n - 1)
    bs = pos[i0]
    bs = np.where(i0 > 0, (bs + pos[np.maximum(i0 - 1, 0)]) // 2, bs)
    has = row_lo < row_hi
    i1 = np.minimum(np.maximum(row_hi - 1, 0), n - 1)
    be = np.where(
        i1 + 1 < n,
        (pos[np.minimum(i1 + 1, n - 1)] + pos[i1]) // 2,
        0,  # reference reads past the array; heap holds 0 in practice
    )
    be = np.where(be == bs, be + 1, be)
    bp_start = np.where(row_lo >= n, 0, bs)
    # treeless tree: the reference still computes from the next tree's rows;
    # span==0 anyway (bp_end==bp_start -> ++)
    bp_end = np.where(row_lo >= n, 0, np.where(has, be, bs + 1))
    return bp_start.astype(np.int64), bp_end.astype(np.int64)


def _group_counts(parent: np.ndarray, n_hap: int, group: np.ndarray,
                  num_groups: int):
    """[T, M, G] leaf-group counts per subtree (ascending-index pass).

    ``parent`` may be a row subset of the chromosome's parent matrix:
    segment handlers pass only their own trees so the cost is
    O(trees_in_segment * M * G), not O(all_trees * M * G) per segment."""
    T, M = parent.shape
    N = n_hap
    C = np.zeros((T, M, num_groups), np.float64)
    C[:, np.arange(N), group[np.arange(N)]] = 1.0
    rows = np.arange(T)
    for j in range(M - 1):
        p = parent[:, j]
        valid = p >= 0
        np.add.at(C, (rows[valid], p[valid]), C[valid, j])
    return C


def _children(anc: AncFile):
    """[T, M, 2] child indices (-1 for leaves), matching ReadTree's
    left-then-right fill order (anc.cpp:25-32): the native threaded pass
    (em.cpp:cn_children); raises if the library cannot be built or
    loaded."""
    from colate_tpu_torch import native

    lib = native.load()
    T, M = anc.parent.shape
    par = np.ascontiguousarray(anc.parent, np.int32)
    ch = np.empty((T, M, 2), np.int32)
    lib.cn_children(T, M, ctypes.c_void_p(par.ctypes.data), ctypes.c_void_p(ch.ctypes.data))
    return ch


class CoalLA:
    """The local-ancestry accumulators [blocks, G, G, E] of one run.

    ``backend`` picks how modern samples accumulate:

    - "auto": on a card the torch program there; on the CPU the C++ twin;
    - "device": the torch program on ``device``;
    - "native": the C++ twin; "numpy": the numpy twin.

    Ancient samples take the grouped numpy path whatever the backend, as
    in the reference.  Nothing falls back: a failed native call or
    program raises."""

    def __init__(self, epochs: np.ndarray, num_groups: int, max_blocks: int = 256,
                 backend: str = "auto", device: str | torch.device = "cuda"):
        from colate_tpu_torch._torch import torch

        self.epochs = epochs
        self.G = num_groups
        self.E = epochs.shape[0]
        self.num = np.zeros((max_blocks, num_groups, num_groups, self.E))
        self.denom = np.zeros((max_blocks, num_groups, num_groups, self.E))
        self.num_blocks = 0
        self.device = torch.device(device)
        if backend == "auto":
            backend = "device" if self.device.type == "cuda" else "native"
        if backend not in ("device", "native", "numpy"):
            raise ValueError(f"unknown local-ancestry backend {backend!r}")
        self.backend = backend
        self.routes: list[str] = []
        self.timings: dict = {}

    def _ensure_blocks(self, needed: int) -> None:
        """Grow the block accumulators on demand (no fixed cap)."""
        if needed <= self.num.shape[0]:
            return
        grow = max(needed, 2 * self.num.shape[0])
        pad = grow - self.num.shape[0]
        tail = np.zeros((pad,) + self.num.shape[1:])
        self.num = np.concatenate([self.num, tail])
        self.denom = np.concatenate([self.denom, tail.copy()])

    def _items(self, anc: AncFile, mut: MutTable, segments, is_global_tail: bool):
        """Each tree's (possibly several) (segment, weight) items: arrays
        (trees, weights span*frac/1e9, segments) in tree order.

        bp ranges are nondecreasing in tree order, so trees wholly inside
        the current segment form runs found by searchsorted; the Python
        loop only touches the ~#segments boundary-crossing trees
        (coal.cpp:513-564 cursor semantics preserved exactly)."""
        T = anc.num_trees
        spans = np.float32(tree_spans(anc, mut)).astype(np.float64)
        bp_start, bp_end = _tree_bp_ranges(anc, mut)
        seg_bp = np.array([s[0] for s in segments], np.int64)
        item_t: list = []
        item_w: list = []
        item_s: list = []
        li = 0
        nseg = len(segments)
        t = 0
        while t < T:
            bs = int(bp_start[t])
            while li < nseg - 1 and bs >= seg_bp[li + 1]:
                li += 1
            if li >= nseg - 1:
                item_t.append(np.arange(t, T))
                item_w.append(spans[t:T].copy())
                item_s.append(np.full(T - t, li, np.int64))
                break
            bound = int(seg_bp[li + 1])
            hi = int(np.searchsorted(bp_end, bound, side="right"))
            if hi > t:
                # run [t, hi): every tree ends at or before the boundary
                item_t.append(np.arange(t, hi))
                item_w.append(spans[t:hi].copy())
                item_s.append(np.full(hi - t, li, np.int64))
                t = hi
                continue
            # tree t crosses segment boundaries (coal.cpp:513-564)
            be = int(bp_end[t])
            sp = float(spans[t])
            width = float(be - bs)
            fr = [sp * (seg_bp[li + 1] - bs) / width]
            sg = [li]
            li += 1
            aborted = False
            if li + 1 == nseg and is_global_tail:
                # the reference `break`s the TREE loop when the GLOBAL
                # poplabels row count is reached (coal.cpp:530-533): all
                # remaining trees of the last chromosome are dropped
                aborted = True
            else:
                while li < nseg - 1 and be > seg_bp[li + 1]:
                    fr.append(sp * (seg_bp[li + 1] - seg_bp[li]) / width)
                    sg.append(li)
                    li += 1
                    if li == nseg:
                        li -= 1
                        break
                # final fragment: the reference forgets the span factor
                # here (coal.cpp:561), replicated faithfully
                fr.append((be - seg_bp[li]) / width)
                sg.append(li)
            item_t.append(np.full(len(fr), t, np.int64))
            item_w.append(np.array(fr))
            item_s.append(np.array(sg, np.int64))
            if aborted:
                break
            t += 1

        trees_all = np.concatenate(item_t) if item_t else np.zeros(0, np.int64)
        ws_all = (np.concatenate(item_w) if item_w else np.zeros(0)) / 1e9
        segs_all = np.concatenate(item_s) if item_s else np.zeros(0, np.int64)
        return trees_all, ws_all, segs_all

    def modern_inputs(self, anc: AncFile, mut: MutTable, segments,
                      is_global_tail: bool = False):
        """The accumulation's arguments for a chromosome of modern samples:
        (parent, ages, lab, c1, c2, w, blocks, epochs, G, blocks used),
        blocks counted from the chromosome's first."""
        N = anc.n_hap
        trees_all, ws_all, segs_all = self._items(anc, mut, segments, is_global_tail)
        # the internal columns are taken per tree before the per-item gathers
        ages = node_ages(anc)[:, N:].astype(np.float64)  # [T, N-1]
        ch = _children(anc)[:, N:]  # [T, N-1, 2]
        seg_labs = np.stack([np.asarray(grp[:N], np.int32) for (_, grp) in segments])
        return (
            np.asarray(anc.parent, np.int32)[trees_all],
            ages[trees_all],
            seg_labs[segs_all],
            np.ascontiguousarray(ch[:, :, 0])[trees_all],
            np.ascontiguousarray(ch[:, :, 1])[trees_all],
            ws_all,
            np.asarray(trees_all // BLOCK_SIZE_TREES, np.int32),
            self.epochs,
            self.G,
            anc.num_trees // BLOCK_SIZE_TREES + 1,
        )

    def add_chromosome(
        self,
        anc: AncFile,
        mut: MutTable,
        segments: list[tuple[int, np.ndarray]],
        is_global_tail: bool = False,
    ) -> None:
        """segments: [(start_bp, group_per_hap)] for this chromosome, sorted.

        is_global_tail: True when these are the last rows of the whole
        poplabels file; only then does crossing into the final segment
        abort the tree loop (the reference's break tests the GLOBAL row
        count, coal.cpp:530-533)."""
        t0 = time.perf_counter()
        T = anc.num_trees
        N = anc.n_hap
        self._ensure_blocks(self.num_blocks + T // BLOCK_SIZE_TREES + 1)
        block0 = self.num_blocks
        sample_ages = (
            np.zeros(N)
            if anc.sample_ages is None
            else np.asarray(anc.sample_ages, np.float64)
        )
        if np.any(sample_ages > 0):
            # the age-truncated denominator keeps its per-segment label
            # machinery, on the host as in the reference
            trees_all, ws_all, segs_all = self._items(anc, mut, segments, is_global_tail)
            blks_all = block0 + trees_all // BLOCK_SIZE_TREES
            coords = node_ages(anc).astype(np.float64)  # [T, M]
            ch = _children(anc)
            internal = np.arange(N, 2 * N - 1)
            seg_onehots = np.zeros((len(segments), N, self.G))
            for si, (_, grp) in enumerate(segments):
                seg_onehots[si, np.arange(N), grp[:N]] = 1.0
            t1 = time.perf_counter()
            for li2 in np.unique(segs_all):
                sel = segs_all == li2
                self._accumulate_items(
                    anc, coords, ch, internal, segments[int(li2)][1],
                    seg_onehots[int(li2)], trees_all[sel], ws_all[sel],
                    blks_all[sel], sample_ages, ancient=True,
                )
            route = "numpy-ancient"
        else:
            from colate_tpu_torch.ops.la_kernel import (
                la_accumulate_device,
                la_accumulate_host,
                la_accumulate_native,
                pair_keys,
            )

            kargs = self.modern_inputs(anc, mut, segments, is_global_tail)
            t1 = time.perf_counter()
            if self.backend == "device":
                num_b, den_b = la_accumulate_device(*kargs, device=self.device)
                route = f"device:{self.device.type}"
            elif self.backend == "native":
                num_b, den_b = la_accumulate_native(*kargs)
                route = "native"
            else:
                num_b, den_b = la_accumulate_host(*kargs)
                route = "numpy"
            sl = slice(block0, block0 + kargs[-1])
            for ki, (p, q) in enumerate(pair_keys(self.G)):
                self.num[sl, p, q, :] += num_b[:, :, ki]
                self.denom[sl, p, q, :] += den_b[:, :, ki]
        self.num_blocks = block0 + T // BLOCK_SIZE_TREES + 1
        self.routes.append(route)
        t2 = time.perf_counter()
        self.timings["prepare"] = self.timings.get("prepare", 0.0) + (t1 - t0)
        self.timings["accumulate"] = self.timings.get("accumulate", 0.0) + (t2 - t1)

    def _accumulate_items(
        self, anc, coords, ch, internal, group, init_onehot, trees, ws, blks,
        sample_ages, ancient: bool,
    ) -> None:
        """Accumulate one batch of (tree, weight, block) items whose leaf
        one-hots are ``init_onehot`` ([S, N, G], per item)."""
        if trees.size == 0:
            return
        N = anc.n_hap
        E = self.E
        G = self.G
        M = 2 * N - 1
        epochs = self.epochs
        S = trees.shape[0]
        # subtree group counts for every item in one ascending-index pass
        C = np.zeros((S, M, G))
        C[:, :N] = init_onehot if init_onehot.ndim == 3 else init_onehot[None]
        par = anc.parent[trees]
        rows_i = np.arange(S)
        for j in range(M - 1):
            p = par[:, j]
            v = p >= 0
            np.add.at(C, (rows_i[v], p[v]), C[v, j])
        c1 = ch[trees][:, internal, 0]
        c2 = ch[trees][:, internal, 1]
        tsel = rows_i[:, None]
        n1 = C[tsel, c1]  # [S, N-1, G]
        n2 = C[tsel, c2]
        X = np.einsum("sig,sih->sigh", n1, n2)  # ordered outer product
        cnt = X + np.swapaxes(X, 2, 3)
        diag = np.arange(G)
        cnt[:, :, diag, diag] = X[:, :, diag, diag]
        cnt = np.tril(cnt)  # keep sorted keys (g1 >= g2)

        a_u = coords[trees][:, internal]  # [S, N-1]
        ep_idx = np.clip(
            np.searchsorted(epochs[1:], a_u.ravel(), side="left"), 0, E - 1
        ).reshape(a_u.shape)
        ov = np.clip(
            np.minimum(a_u[:, :, None], epochs[None, None, 1:])
            - epochs[None, None, :-1],
            0.0,
            None,
        )
        ov = np.concatenate([ov, np.zeros(ov.shape[:2] + (1,))], axis=2)

        # num: scatter per (tree, node) into [blk, g1, g2, ep]
        K = a_u.shape[1]
        num_te = np.zeros((S, G, G, E))
        s_idx = np.broadcast_to(rows_i[:, None], (S, K))
        np.add.at(
            num_te.transpose(0, 3, 1, 2),
            (s_idx.ravel(), ep_idx.ravel()),
            cnt.reshape(S * K, G, G),
        )
        if not ancient:
            den_te = np.einsum("sigh,sie->sghe", cnt, ov)
        else:
            den_te = self._den_ancient(
                anc, group, sample_ages, trees, internal, ch, ov
            )
        w_num = num_te * ws[:, None, None, None]
        w_den = den_te * ws[:, None, None, None]
        np.add.at(self.num, blks, w_num)
        np.add.at(self.denom, blks, w_den)

    def _den_ancient(self, anc, group, sample_ages, trees, internal, ch, ov):
        """Denominator with the per-pair sample-age truncation
        (coal_tree.cpp:505-517): a pair with age A = max(sample ages)
        contributes its epoch exposure only in epochs whose upper
        boundary exceeds A, and the first such epoch loses
        (A - epoch_start)*span/1e9.

        Leaves are bucketed into (group, sample_age) labels; per label
        pair the age class k = max(age1, age2) selects a boolean epoch
        mask M_k and a one-hot subtraction sub_k, so the whole reduction
        stays batched over [trees, nodes]."""
        epochs = self.epochs
        E = self.E
        G = self.G
        # labels: unique (group, age) combinations
        combo = np.stack([group.astype(np.float64), sample_ages], axis=1)
        uniq, lab_of_hap = np.unique(combo, axis=0, return_inverse=True)
        lab_of_hap = np.asarray(lab_of_hap).ravel()
        L = uniq.shape[0]
        lab_group = uniq[:, 0].astype(np.int64)
        lab_age = uniq[:, 1]

        CL = _group_counts(
            anc.parent[trees], anc.n_hap, lab_of_hap.astype(np.int64), L
        )  # [S, M, L]
        c1 = ch[trees][:, internal, 0]
        c2 = ch[trees][:, internal, 1]
        tsel = np.arange(trees.size)[:, None]
        n1 = CL[tsel, c1]  # [S, K, L]
        n2 = CL[tsel, c2]
        X = np.einsum("sil,sim->silm", n1, n2)  # child1-label x child2-label

        # per label pair: age class + sorted group key
        A_pair = np.maximum(lab_age[:, None], lab_age[None, :])  # [L, L]
        uniq_A, k_of_pair = np.unique(A_pair, return_inverse=True)
        k_of_pair = k_of_pair.reshape(L, L)
        nk = uniq_A.shape[0]
        g1 = np.maximum(lab_group[:, None], lab_group[None, :])
        g2 = np.minimum(lab_group[:, None], lab_group[None, :])
        # map [L*L] pairs -> flattened (g1, g2, k) bins
        flat = (g1 * G + g2) * nk + k_of_pair  # [L, L]
        Mmap = np.zeros((L * L, G * G * nk))
        Mmap[np.arange(L * L), flat.ravel()] = 1.0
        S, K = X.shape[0], X.shape[1]
        cnt_gk = (X.reshape(S, K, L * L) @ Mmap).reshape(S, K, G, G, nk)

        # epoch mask and one-hot subtraction per age class
        # (epochs[e+1] > A; the last, open-ended epoch always qualifies:
        # the reference's loop always breaks before reading past the
        # epoch vector for realistic grids)
        Mk = np.zeros((nk, E))
        subk = np.zeros((nk, E))
        for k, A in enumerate(uniq_A):
            m = np.zeros(E, bool)
            m[:-1] = epochs[1:] > A
            m[-1] = True
            Mk[k] = m
            f = int(np.searchsorted(epochs[1:], A, side="right"))
            subk[k, f] = A - epochs[f]
        # masked exposure + one-hot subtraction, reduced over nodes
        pairs = cnt_gk.reshape(S, K, G * G, nk)
        den = np.einsum("sipx,sie,xe->spe", pairs, ov, Mk)
        den -= np.einsum("sipx,xe->spe", pairs, subk)
        return den.reshape(S, G, G, E)

    def rates(self, num_bootstrap: int) -> np.ndarray:
        """[B, G, G, E] bootstrap rates (num/denom over the sorted key;
        division by 0 gives the reference's nan/inf).  Draws: seed 1
        (hardcoded in the reference, coal_tree.cpp:532), [0, nb-1]."""
        rng = MT19937(1)
        nb = self.num_blocks
        w = np.zeros((num_bootstrap, nb))
        for i in range(num_bootstrap):
            np.add.at(w[i], rng.uniform_int(0, nb - 1, nb), 1.0)
        num_b = np.einsum("bk,kghe->bghe", w, self.num[:nb])
        den_b = np.einsum("bk,kghe->bghe", w, self.denom[:nb])
        out = np.empty((num_bootstrap, self.G, self.G, self.E))
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(self.G):
                for j in range(self.G):
                    hi, lo = (i, j) if i > j else (j, i)
                    out[:, i, j] = num_b[:, hi, lo] / den_b[:, hi, lo]
        return out

    def dump(self, path: str, unique_groups: list[str], num_bootstrap: int) -> None:
        rates = self.rates(num_bootstrap)

        def fmt(x: float) -> str:
            if np.isnan(x):
                return "-nan" if np.signbit(x) else "nan"
            return f"{x:g}"

        with open(path, "w") as fh:
            fh.write(" ".join(unique_groups) + " \n")
            fh.write(" ".join(f"{e:g}" for e in self.epochs) + " \n")
            for b in range(num_bootstrap):
                for i in range(self.G):
                    for j in range(self.G):
                        fh.write(
                            f"{i} {j} " + " ".join(fmt(r) for r in rates[b, i, j]) + " \n"
                        )


def _read_la_poplabels(path: str):
    """Either 4-column poplabels or the segment format (coal.cpp:364-461).

    Returns (unique_groups, rows) where rows = [(chrom, bp, group_array)].
    4-column files return rows=None (the run loop synthesises the sentinel pair
    per chromosome)."""
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    c1 = len(lines[0].split())
    c2 = len(lines[1].split()) if len(lines) > 1 else 0
    if c1 == 4 and c2 == 4:
        return None, None
    unique_groups = lines[0].split()
    rows = []
    prev_groups: np.ndarray | None = None
    for ln in lines[1:]:
        parts = ln.split()
        chrom = parts[0]
        bp = int(parts[1])
        vals = np.array([int(x) for x in parts[2:]], np.int32)
        if prev_groups is not None and vals.size < prev_groups.size:
            # the reference reuses the previous row's tail when a row is
            # short (it overwrites group_tmp in place, coal.cpp:454-456)
            merged = prev_groups.copy()
            merged[: vals.size] = vals
            vals = merged
        rows.append((chrom, bp, vals))
        prev_groups = vals
    return unique_groups, rows


def local_ancestry_estimate(args, backend: str = "auto"):
    """Mode local_ancestry up to the accumulators: (CoalLA, unique group
    names, parse seconds).  ``backend`` as :class:`CoalLA`'s; the device
    is ``args.torch_device``, else the card."""
    ypg = float(np.float32(args.years_per_gen)) if args.years_per_gen else 28.0
    if args.coal:
        with open(args.coal) as fh:
            lines = fh.read().splitlines()
        epochs = np.array([float(np.float32(x)) for x in lines[1].split()])
    else:
        epochs = epochs_from_bins_tree(args.bins, ypg)

    chroms = ["NA"]
    files = [args.input]
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]
        files = [f"{args.input}_chr{c}" for c in chroms]

    t_parse = 0.0
    t0 = time.perf_counter()
    unique_groups, seg_rows = _read_la_poplabels(args.poplabels)
    device = getattr(args, "torch_device", "cuda")

    def read(f):
        t = time.perf_counter()
        anc = AncFile.read(f + ".anc", columns="tree")
        mut = MutTable.read(f + ".mut")
        return anc, mut, time.perf_counter() - t

    if unique_groups is None:
        sample = Sample.read(args.poplabels)
        unique_groups = sample.groups
        t_parse += time.perf_counter() - t0
        est = CoalLA(epochs, len(unique_groups), backend=backend, device=device)
        for ci, (c, f) in enumerate(zip(chroms, files)):
            anc, mut, dt = read(f)
            t_parse += dt
            segs = [
                (0, sample.group_of_haplotype),
                (int(mut.pos[-1] + 1e6), sample.group_of_haplotype),
            ]
            est.add_chromosome(anc, mut, segs, is_global_tail=(ci == len(chroms) - 1))
    else:
        t_parse += time.perf_counter() - t0
        est = CoalLA(epochs, len(unique_groups), backend=backend, device=device)
        tail_chrom = seg_rows[-1][0]
        for c, f in zip(chroms, files):
            anc, mut, dt = read(f)
            t_parse += dt
            segs = [
                (bp, grp) for (ch, bp, grp) in seg_rows if ch == c or c == "NA"
            ]
            if not segs:
                raise ValueError(f"chromosome {c} not found in poplabels")
            est.add_chromosome(
                anc, mut, segs, is_global_tail=(c == tail_chrom or c == "NA")
            )
    return est, unique_groups, t_parse


def run_local_ancestry(args) -> int:
    """Mode local_ancestry end to end, on ``args.torch_device`` (default
    the card)."""
    if not (args.input and args.output and args.poplabels and args.bins):
        print("Needed: input, output, poplabels, bins.", file=sys.stderr)
        return 2
    est, unique_groups, t_parse = local_ancestry_estimate(args)
    B = args.num_bootstraps or 1
    t0 = time.perf_counter()
    est.dump(args.output + ".coal", unique_groups, B)
    timings = {"parse": t_parse, **est.timings, "bootstrap_write": time.perf_counter() - t0}
    print(f"local_ancestry: {est.num_blocks} blocks -> {args.output}.coal",
          file=sys.stderr)
    log_event("la_done", blocks=est.num_blocks, bootstraps=B, out=args.output + ".coal",
              route=",".join(sorted(set(est.routes))), timings=timings)
    return 0
