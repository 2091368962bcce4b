"""CoalRate mode ``tree``: genome-wide coalescence rates from Relate trees.

Port of colate_tpu/models/tree_coal.py.  The host code (spans, the numpy
oracle, the bootstrap, the epoch grid, the writer, the run loop) is
copied; the populate dispatch is the port's own (:func:`accumulate_tree_stats`).

Reference: ``coal()`` (coal/coal.cpp:21-204) + ``coal_tree``
(coal_tree.cpp:1-300).  Per marginal tree, the estimator needs the sorted
node ages, the lineage count per inter-event interval, and their overlap
with the epoch grid; every tree is a row of dense [num_trees, 2N-1]
arrays and a chromosome reduces with one batched program:

    num[block, e]   = sum_trees span * #{coalescences in epoch e} / 1e9
    denom[block, e] = sum_trees span * sum_j C(k_j,2) |interval_j & epoch e| / 1e9

Span semantics (AncMutIterators::NextTree, mutations.cpp:616-692): a
tree with mut rows [i0..i1] persists for sum dist[i0..i1] plus half the
preceding dist minus half of dist[i1] (when neighbours exist); trees
without mutations contribute 0.  ``coal()`` narrows the span to float32
(coal.cpp:146), replicated.

Bootstrap quirks replicated from coal_tree.cpp:180-211: rng is ALWAYS
mt19937 seeded with 1 (the --seed flag is ignored), and the uniform_int
upper bound is num_blocks INCLUSIVE: draws equal to num_blocks fall
outside the count array and are silently dropped.
"""

from __future__ import annotations

import sys
import time
from typing import TYPE_CHECKING

import numpy as np

from colate_tpu_torch.formats.anc import AncFile, node_ages
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.hostrng import MT19937
from colate_tpu_torch.utils.progress import log_event

if TYPE_CHECKING:
    import torch

BLOCK_SIZE_TREES = 5000  # coal.cpp:140
_INITIAL_BLOCKS = 256  # starting accumulator size; grows on demand


def tree_spans(anc: AncFile, mut: MutTable) -> np.ndarray:
    """[num_trees] float64 genome span per tree (NextTree semantics)."""
    T = anc.num_trees
    spans = np.zeros(T, np.float64)
    tree_of_row = mut.tree
    n = len(mut)
    if n == 0:
        return spans
    # rows are grouped by tree index (nondecreasing)
    first = np.full(T, -1, np.int64)
    last = np.full(T, -1, np.int64)
    uniq, idx_first = np.unique(tree_of_row, return_index=True)
    m = (uniq >= 0) & (uniq < T)
    first[uniq[m]] = idx_first[m]
    # last occurrence
    uniq_r, idx_last_rev = np.unique(tree_of_row[::-1], return_index=True)
    m = (uniq_r >= 0) & (uniq_r < T)
    last[uniq_r[m]] = n - 1 - idx_last_rev[m]
    dist = mut.dist.astype(np.float64)
    csum = np.concatenate([[0.0], np.cumsum(dist)])
    has = first >= 0
    i0 = np.where(has, first, 0)
    i1 = np.where(has, last, 0)
    s = csum[i1 + 1] - csum[i0]
    s += np.where(i0 > 0, dist[np.maximum(i0 - 1, 0)] / 2.0, 0.0)
    s -= np.where(i1 < n - 1, dist[i1] / 2.0, 0.0)
    spans[has] = s[has]
    return spans


def tree_spans_dist(anc: AncFile, mut: MutTable, dist_path: str) -> np.ndarray:
    """[num_trees] float64 spans from a separate ``.dist`` file: the
    AncMutIterators (anc, mut, dist) constructor + NextTree semantics
    (mutations.cpp:399-465, 616-668): the file holds (pos, dist) rows
    (header skipped); the cursor skips file entries below a tree's
    first mutation position, takes the half-dist of the file entry
    preceding it, sums the file dists aligned 1:1 with the tree's
    mutation rows (positions must match; the reference asserts), and
    subtracts half of the last consumed dist when the file continues."""
    with open(dist_path) as fh:
        lines = fh.read().split()
    # header = 2 tokens; rows follow as pos dist pairs
    vals = np.array(lines[2:], np.float64)
    fpos = vals[0::2].astype(np.int64)
    fdist = vals[1::2]

    T = anc.num_trees
    spans = np.zeros(T, np.float64)
    n = len(mut)
    if n == 0 or fpos.size == 0:
        return spans
    tree_of_row = mut.tree
    pos = mut.pos.astype(np.int64)
    # per-row file index; the reference walks the cursor forward and
    # asserts *it_pos == row pos for every row of a tree
    j = np.searchsorted(fpos, pos, side="left")
    if np.any(j >= fpos.size) or np.any(fpos[np.minimum(j, fpos.size - 1)] != pos):
        bad = int(np.nonzero(
            (j >= fpos.size)
            | (fpos[np.minimum(j, fpos.size - 1)] != pos)
        )[0][0])
        raise ValueError(
            f"{dist_path}: no entry for .mut position {int(pos[bad])} "
            "(the reference asserts file/mut position alignment)"
        )
    uniq, first = np.unique(tree_of_row, return_index=True)
    m = (uniq >= 0) & (uniq < T)
    uniq, first = uniq[m], first[m]
    uniq_r, last_rev = np.unique(tree_of_row[::-1], return_index=True)
    mr = (uniq_r >= 0) & (uniq_r < T)
    last = (n - 1 - last_rev[mr])[np.argsort(uniq_r[mr])]
    j0 = j[first]
    j1 = j[last]
    csum = np.concatenate([[0.0], np.cumsum(fdist)])
    s = csum[j1 + 1] - csum[j0]
    s += np.where(j0 > 0, fdist[np.maximum(j0 - 1, 0)] / 2.0, 0.0)
    s -= np.where(j1 + 1 < fpos.size, fdist[j1] / 2.0, 0.0)
    spans[uniq] = s
    return spans


def _populate_numpy_chunk(coords, spans, epochs, N):
    """Per-tree [E] num/denom for one chunk of trees: the host oracle of
    the populate programs (ops/tree_kernel.py), kept in the reference's
    direct interval-overlap form."""
    T, M = coords.shape
    E = epochs.shape[0]
    # stable sort by (coord, node_index): argsort of f32 with index tiebreak
    order = np.argsort(coords, axis=1, kind="stable")  # ties keep index order
    sc = np.take_along_axis(coords.astype(np.float64), order, axis=1)  # [T, M]
    is_leaf = order < N
    lins = np.cumsum(np.where(is_leaf, 1, -1), axis=1)  # [T, M]

    # intervals j=1..M-1: [sc[j-1], sc[j]], k = lins[:, j-1]
    lo = sc[:, :-1]
    hi = sc[:, 1:]
    k = lins[:, :-1].astype(np.float64)
    pairs = k * (k - 1.0) / 2.0  # [T, M-1]

    # epoch overlap of every interval: [T, M-1, E]; epochs bound the sweep;
    # exposure above the last boundary is dropped (coal_tree.cpp:160-174)
    edge_lo = epochs[None, None, :]
    edge_hi = np.concatenate([epochs[1:], [epochs[-1]]])[None, None, :]
    ov = np.clip(
        np.minimum(hi[:, :, None], edge_hi) - np.maximum(lo[:, :, None], edge_lo),
        0.0,
        None,
    )
    ov[:, :, -1] = 0.0  # last epoch: sweep stops at the final boundary
    denom_tree = np.einsum("tm,tme->te", pairs, ov)  # [T, E]

    # coalescence events: internal nodes, assigned to the epoch whose upper
    # boundary first reaches the age (<=); ages above the last boundary drop
    coal_age = sc[:, 1:]
    is_coal = ~is_leaf[:, 1:]
    ep_idx = np.searchsorted(epochs[1:], coal_age.ravel(), side="left").reshape(
        coal_age.shape
    )
    keep = is_coal & (ep_idx <= E - 2)  # events beyond epochs[-1] dropped
    num_tree = np.zeros((T, E), np.float64)
    t_idx = np.broadcast_to(np.arange(T)[:, None], coal_age.shape)
    np.add.at(num_tree, (t_idx[keep], ep_idx[keep]), 1.0)
    w = spans / 1e9
    return num_tree * w[:, None], denom_tree * w[:, None]


def accumulate_tree_stats(
    anc: AncFile,
    mut: MutTable,
    epochs: np.ndarray,
    num_blocks_offset: int,
    num: np.ndarray,
    denom: np.ndarray,
    backend: str = "auto",
    dist_file: str | None = None,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple[int, str]:
    """Add one chromosome's per-block [E] num/denom; returns (#blocks
    used, the route that ran).

    num/denom: [max_blocks, E] accumulators (modified in place).
    backend:

    - "auto": on a card, the populate program there; on the CPU, the
      native sorted walk when leaf ages are all 0, else the program on
      the CPU;
    - "device": the program on ``device``: the leaf-zero form when
      :func:`leaf_zero_applicable` holds, else the general form;
    - "numpy": the host oracle.

    Nothing falls back: a failed native call or program raises.
    ``timings`` (if given) gains ``prepare`` (spans and node ages) and
    ``populate`` seconds.
    """
    # the device routes need torch; the host functions above do not
    from colate_tpu_torch._torch import torch
    from colate_tpu_torch.ops.tree_kernel import (
        leaf_zero_applicable,
        populate_device,
        populate_device_sorted,
        populate_sorted_native,
    )

    device = torch.device(device)
    t0 = time.perf_counter()
    N = anc.n_hap
    T = anc.num_trees
    spans_f64 = (
        tree_spans_dist(anc, mut, dist_file)
        if dist_file
        else tree_spans(anc, mut)
    )
    spans = np.float32(spans_f64).astype(np.float64)  # coal()'s float span
    coords = node_ages(anc)  # [T, M] f32
    M = coords.shape[1]
    E = epochs.shape[0]
    nb_local = T // BLOCK_SIZE_TREES + 1
    blocks_local = (np.arange(T) // BLOCK_SIZE_TREES).astype(np.int32)
    t1 = time.perf_counter()

    leaf_zero = leaf_zero_applicable(coords, N)
    if backend == "auto":
        backend = "native" if device.type == "cpu" and leaf_zero else "device"
    if backend == "native":
        out = populate_sorted_native(coords, spans, blocks_local, epochs, N, nb_local)
        route = "native"
    elif backend == "device":
        if leaf_zero:
            # contemporaneous samples, the common Relate case: only the
            # internal ages are sorted
            out = populate_device_sorted(coords, spans, blocks_local, epochs, N, nb_local, device)
            route = f"device-sorted:{device.type}"
        else:
            out = populate_device(coords, spans, blocks_local, epochs, N, nb_local, device)
            route = f"device:{device.type}"
    elif backend == "numpy":
        out = (np.zeros((nb_local, E)), np.zeros((nb_local, E)))
        # chunk the [t, M, E] overlap tensor to bounded memory
        chunk = max(1, (1 << 24) // max(M * E, 1))
        for i in range(0, T, chunk):
            nt, dt = _populate_numpy_chunk(
                coords[i : i + chunk], spans[i : i + chunk], epochs, N
            )
            np.add.at(out[0], blocks_local[i : i + chunk], nt)
            np.add.at(out[1], blocks_local[i : i + chunk], dt)
        route = "numpy"
    else:
        raise ValueError(f"unknown tree backend {backend!r}")
    sl = slice(num_blocks_offset, num_blocks_offset + nb_local)
    num[sl] += out[0]
    denom[sl] += out[1]
    if timings is not None:
        timings["prepare"] = timings.get("prepare", 0.0) + (t1 - t0)
        timings["populate"] = timings.get("populate", 0.0) + (time.perf_counter() - t1)
    return nb_local, route


def bootstrap_block_weights_tree(num_bootstrap: int, num_blocks: int) -> np.ndarray:
    """coal_tree::init_bootstrap (coal_tree.cpp:180-211): seed fixed at 1,
    inclusive-upper-bound draws, out-of-range draws dropped."""
    rng = MT19937(1)
    w = np.zeros((num_bootstrap, num_blocks), np.float64)
    for i in range(num_bootstrap):
        draws = rng.uniform_int(0, num_blocks, num_blocks)  # [0, num_blocks]!
        draws = draws[draws < num_blocks]
        np.add.at(w[i], draws, 1.0)
    return w


def epochs_from_bins_tree(bins: str, years_per_gen: float) -> np.ndarray:
    """coal() epoch grid (coal.cpp:120-135): 0, 10^lower..<upper step, 10^upper,
    cap; no age splicing, no duplicate-zero quirk."""
    parts = bins.split(",")
    lower = float(np.float32(parts[0]))
    upper = float(np.float32(parts[1]))
    step = float(np.float32(parts[2]))
    log10 = np.log(10.0)
    epochs = [0.0]
    b = lower
    while b < upper:
        epochs.append(np.exp(log10 * b) / years_per_gen)
        b += step
    epochs.append(np.exp(log10 * upper) / years_per_gen)
    epochs.append(max(1e8, 10.0 * epochs[-1]) / years_per_gen)
    return np.array(epochs, np.float64)


def write_tree_coal(path: str, epochs, rates, num_bootstrap: int) -> None:
    """coal_tree::Dump layout (coal_tree.cpp:256-295)."""

    def fmt(x: float) -> str:
        if np.isnan(x):
            return "-nan" if np.signbit(x) else "nan"
        return f"{x:g}"

    with open(path, "w") as fh:
        fh.write(" ".join(str(i) for i in range(num_bootstrap)) + " \n")
        fh.write(" ".join(f"{e:g}" for e in epochs) + " \n")
        for i in range(rates.shape[0]):
            fh.write(f"0 {i} " + " ".join(fmt(r) for r in rates[i]) + " \n")


def tree_rates(args, backend: str = "auto"):
    """Mode tree up to the rates: (epochs [E], rates [B, E], blocks,
    routes, timings).  ``args`` carries the CLI's fields (input, bins,
    coal, chr_file, years_per_gen, num_bootstraps, dist, torch_device:
    the card when absent)."""
    device = getattr(args, "torch_device", "cuda")
    timings: dict = {}
    ypg = float(np.float32(args.years_per_gen)) if args.years_per_gen else 28.0
    epochs = (
        _epochs_from_coal(args.coal) if args.coal else epochs_from_bins_tree(args.bins, ypg)
    )
    E = epochs.shape[0]
    chroms = ["1"]
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]

    # block accumulators grow on demand (no fixed cap: a chromosome adds
    # T // BLOCK_SIZE_TREES + 1 blocks, unbounded in principle)
    num = np.zeros((_INITIAL_BLOCKS, E), np.float64)
    denom = np.zeros((_INITIAL_BLOCKS, E), np.float64)
    nb = 0
    routes = []
    for c in chroms:
        t0 = time.perf_counter()
        anc = AncFile.read(f"{args.input}_chr{c}.anc", columns="tree")
        mut = MutTable.read(f"{args.input}_chr{c}.mut")
        timings["parse"] = timings.get("parse", 0.0) + (time.perf_counter() - t0)
        dist_file = None
        if getattr(args, "dist", None):
            # engine extension: spans from a separate .dist file (the
            # relate_lib AncMutIterators 3-arg ctor, mutations.cpp:399-465)
            dist_file = f"{args.dist}_chr{c}.dist"
        need = nb + anc.num_trees // BLOCK_SIZE_TREES + 1
        if need > num.shape[0]:
            grow = max(need, 2 * num.shape[0])
            num = np.concatenate([num, np.zeros((grow - num.shape[0], E))])
            denom = np.concatenate(
                [denom, np.zeros((grow - denom.shape[0], E))]
            )
        used, route = accumulate_tree_stats(anc, mut, epochs, nb, num, denom, backend=backend,
                                            dist_file=dist_file, device=device, timings=timings)
        nb += used
        routes.append(route)
        log_event("tree_chrom", chrom=c, trees=anc.num_trees, blocks=nb, route=route)
    t0 = time.perf_counter()
    B = args.num_bootstraps or 1
    w = bootstrap_block_weights_tree(B, nb)
    num_b = w @ num[:nb]
    den_b = w @ denom[:nb]
    with np.errstate(divide="ignore", invalid="ignore"):
        rates = num_b / den_b
    timings["bootstrap"] = time.perf_counter() - t0
    return epochs, rates, nb, routes, timings


def run_tree_mode(args) -> int:
    """Mode tree end to end, on ``args.torch_device`` (default the card)."""
    if not args.input or not args.bins:
        print("Needed: input, output, bins.", file=sys.stderr)
        return 2
    epochs, rates, nb, routes, timings = tree_rates(args)
    B = rates.shape[0]
    t0 = time.perf_counter()
    write_tree_coal(args.output + ".coal", epochs, rates, B)
    timings["write"] = time.perf_counter() - t0
    log_event("tree_done", blocks=nb, bootstraps=B, out=args.output + ".coal",
              route=",".join(sorted(set(routes))), timings=timings)
    return 0


def _epochs_from_coal(path: str) -> np.ndarray:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return np.array([float(np.float32(x)) for x in lines[1].split()], np.float64)
