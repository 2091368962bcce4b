"""Cross-tree branch association (relate_lib's AncesTree surface).

Reimplements ``AncesTree::BranchAssociation`` /
``AssociateEquivalentBranches`` (reference include/src/anc.cpp:1231-1492)
over the columnar :class:`~colate_tpu_torch.formats.anc.AncFile`: for every
pair of adjacent marginal trees, each branch of the later tree is mapped
to its "equivalent" branch in the earlier tree — exactly matching
subtrees first (leaf-set Pearson ≥ 0.9999 for both the branch and its
parent), then a greedy best-score pairing of the leftovers above the
0.95 threshold, with candidate branches pre-filtered by the leaf-count
compatibility bound.  The association then carries mutation-count /
SNP-range information across equivalent branches in a forward pass
(``num_events`` accumulates, ``SNP_begin`` propagates forward) and a
backward pass (``num_events`` and ``SNP_end`` propagate back) — the
same two sweeps the reference runs.

No Colate/CoalRate *mode* calls this (it is Relate-tooling surface);
it exists for relate_lib parity and is unit-tested against
hand-constructed tree chains.
"""

from __future__ import annotations

import numpy as np

from colate_tpu_torch.formats.anc import AncFile

THRESHOLD_BRANCHEQ = 0.95  # anc.cpp:1406


def _leaf_sets(parent_row: np.ndarray, N: int) -> list[np.ndarray]:
    """Sorted descendant-leaf ids per node (FindAllLeaves,
    anc.cpp:205-277).  Post-order traversal — internal nodes may carry
    ARBITRARY labels (ARGweaver/Rent imports do not number children
    below parents)."""
    M = parent_row.shape[0]
    sets: list = [None] * M
    for i in range(N):
        sets[i] = np.array([i], np.int64)
    ch: list[list[int]] = [[] for _ in range(M)]
    roots: list[int] = []
    for j in range(M):
        p = int(parent_row[j])
        if p >= 0:
            ch[p].append(j)
        else:
            roots.append(j)
    stack = list(roots)
    while stack:
        j = stack.pop()
        if sets[j] is not None:
            continue
        kids = ch[j]
        if all(sets[c] is not None for c in kids):
            if len(kids) == 2:
                merged = np.concatenate([sets[kids[0]], sets[kids[1]]])
                merged.sort()
                sets[j] = merged
            else:
                sets[j] = np.zeros(0, np.int64)
        else:
            stack.append(j)
            for c in kids:
                if sets[c] is None:
                    stack.append(c)
    for j in range(M):
        if sets[j] is None:  # disconnected (malformed input)
            sets[j] = np.zeros(0, np.int64)
    return sets


def _pearson(s1: np.ndarray, s2: np.ndarray, N: int) -> float:
    """Correlation::Pearson (anc.cpp:711-746), float32 arithmetic."""
    n1, n2 = s1.size, s2.size
    if n1 == N or n2 == N:
        return 1.0 if n1 == n2 else 0.0
    prod = np.float32(np.intersect1d(s1, s2, assume_unique=True).size)
    if prod == n1 and prod == n2:
        return 1.0
    Nf = np.float32(N)
    r = prod - np.float32(n1) * (np.float32(n2) / Nf)
    if r <= 0.0:
        return 0.0
    r = r / np.float32(
        np.sqrt(
            (np.float32(n1) / Nf)
            * (Nf - np.float32(n1))
            * (np.float32(n2) / Nf)
            * (Nf - np.float32(n2))
        )
    )
    return float(r)


def _children_row(parent_row: np.ndarray, M: int) -> np.ndarray:
    ch = np.full((M, 2), -1, np.int64)
    filled = np.zeros(M, np.int64)
    for j in range(M):
        p = int(parent_row[j])
        if p >= 0 and filled[p] < 2:
            ch[p, filled[p]] = j
            filled[p] += 1
    return ch


def potential_branch_counts(N: int, threshold: float = THRESHOLD_BRANCHEQ):
    """potential_branches (anc.cpp:1404-1419): for a branch with i
    leaves, the leaf counts a candidate equivalent branch may have."""
    pot: list[list[int]] = [[] for _ in range(N)]
    tinv = 1.0 / (threshold * threshold)
    Nf = float(N)
    for i in range(1, N + 1):
        pot[i - 1].append(i)
        for j in range(i + 1, N + 1):
            if Nf - j <= 0:
                continue
            if tinv >= (j / (Nf - j)) * ((Nf - i) / i):
                pot[i - 1].append(j)
                pot[j - 1].append(i)
    return pot


def branch_association(
    ref_parent: np.ndarray,
    parent: np.ndarray,
    N: int,
    potential: list[list[int]] | None = None,
    threshold: float = THRESHOLD_BRANCHEQ,
) -> np.ndarray:
    """equivalent_branches[M]: for each branch of `parent`'s tree, its
    equivalent branch in `ref_parent`'s tree, or -1
    (AncesTree::BranchAssociation, anc.cpp:1231-1392)."""
    M = parent.shape[0]
    if potential is None:
        potential = potential_branch_counts(N, threshold)
    eq = np.full(M, -1, np.int64)
    eq_ref = np.full(M, -1, np.int64)

    tr = _leaf_sets(parent, N)
    rtr = _leaf_sets(ref_parent, N)
    ch = _children_row(parent, M)
    rch = _children_row(ref_parent, M)

    # ref branches sorted by leaf count; [index[c-1], index[c]) = count c
    counts = np.array([s.size for s in rtr], np.int64)
    order = np.argsort(counts[: M], kind="stable")
    index = np.zeros(N, np.int64)
    for s in rtr[:-1]:
        index[min(s.size, N - 1)] += 1
    index = np.cumsum(index)

    def rng_for(c: int):
        lo = int(index[c - 1]) if c >= 1 else 0
        hi = int(index[c]) if c < N else M
        return order[lo:hi]

    # leaves (anc.cpp:1274-1327)
    for i in range(N):
        if eq[i] != -1:
            continue
        p = int(parent[i])
        rp = int(ref_parent[i])
        if p < 0 or rp < 0:
            continue
        sib = int(ch[p, 1]) if int(ch[p, 0]) == i else int(ch[p, 0])
        if sib < N:
            if sib in (int(rch[rp, 0]), int(rch[rp, 1])):
                eq[i] = i
                eq_ref[i] = i
                eq[sib] = sib
                eq_ref[sib] = sib
        else:
            if _pearson(tr[p], rtr[rp], N) >= threshold:
                eq[i] = i
                eq_ref[i] = i

    unpaired: list[int] = []
    for i in range(N, M - 1):
        pi = int(parent[i])
        rpi = int(ref_parent[i])
        if (
            pi >= 0
            and rpi >= 0
            and _pearson(tr[i], rtr[i], N) >= 0.9999
            and _pearson(tr[pi], rtr[rpi], N) >= 0.9999
        ):
            eq[i] = i
            eq_ref[i] = i
        if eq[i] == -1:
            c = tr[i].size
            for cand in rng_for(c):
                cand = int(cand)
                rpc = int(ref_parent[cand])
                if rpc < 0 or pi < 0:
                    continue
                if (
                    _pearson(tr[i], rtr[cand], N) >= 0.9999
                    and _pearson(tr[pi], rtr[rpc], N) >= 0.9999
                ):
                    eq[i] = cand
                    eq_ref[cand] = i
                    break
        if eq[i] == -1:
            unpaired.append(i)

    # approximate pairing above the threshold, best score first
    pairs: list[tuple[float, int, int]] = []
    for i in unpaired:
        c = tr[i].size
        pi = int(parent[i])
        for ck in potential[c - 1]:
            for cand in rng_for(int(ck)):
                cand = int(cand)
                if eq_ref[cand] != -1:
                    continue
                rpc = int(ref_parent[cand])
                if rpc < 0 or pi < 0:
                    continue
                score = _pearson(tr[i], rtr[cand], N)
                if (
                    score >= threshold
                    and _pearson(tr[pi], rtr[rpc], N) >= threshold
                ):
                    pairs.append((score, i, cand))
    pairs.sort(key=lambda t: t[0], reverse=True)
    for score, i, cand in pairs:
        if eq[i] == -1 and eq_ref[cand] == -1:
            eq[i] = cand
            eq_ref[cand] = i
    return eq


def associate_equivalent_branches(
    anc: AncFile, threshold: float = THRESHOLD_BRANCHEQ
) -> list[np.ndarray]:
    """AssociateEquivalentBranches (anc.cpp:1394-1492): compute the
    per-adjacent-pair equivalence maps and carry num_events / SNP_begin
    forward and num_events / SNP_end backward across them, mutating
    `anc` in place.  Returns the T-1 equivalence maps."""
    T = anc.num_trees
    N = anc.n_hap
    if T < 2:
        return []
    pot = potential_branch_counts(N, threshold)
    eqs = [
        branch_association(anc.parent[t - 1], anc.parent[t], N, pot, threshold)
        for t in range(1, T)
    ]
    nev = anc.num_events
    sb = anc.snp_begin
    se = anc.snp_end
    # forward: accumulate events, inherit SNP_begin (anc.cpp:1445-1462)
    for t in range(1, T):
        eq = eqs[t - 1]
        m = eq != -1
        idx = eq[m]
        nev[t, m] = nev[t, m] + nev[t - 1, idx]
        sb[t, m] = sb[t - 1, idx]
    # backward: propagate totals and SNP_end (anc.cpp:1466-1487)
    for t in range(T - 2, -1, -1):
        eq = eqs[t]  # maps tree t+1 branches -> tree t branches
        m = eq != -1
        idx = eq[m]
        nev[t, idx] = nev[t + 1, m]
        se[t, idx] = se[t + 1, m]
    return eqs
