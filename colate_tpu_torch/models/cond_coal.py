"""Mode ``CondCoalRates``: conditional pairwise coalescence rates.

Reference: coal/coal.cpp:5002-5582 + GetConditionalCoalescentRate
(coal.cpp:4785-4999).  For each focal haplotype f and conditional
haplotype c, with L = the first node on f's root path whose subtree
contains c (coal_age = age(L), binned on the focal-epoch grid), every
ancestor A strictly above L contributes for each leaf `other` in A's
non-path child subtree:

    num[ep_focal(coal_age)][epoch(age(A))][group(other)]  += factor
    denom[ep_focal(coal_age)][e][group(other)] += factor·|[coal_age, age(A)] ∩ e|

(the exposure restarts at coal_age for every ancestor — reference
semantics).  An empty conditional group uses c=-1: use-from-leaf with
coal_age=0.  Blocks are 30 Mb by the tree's first-SNP position.

Replicated reference quirks:
- the tree loop body runs once more after the iterator is exhausted,
  re-adding the last tree with factor = -1.0 (coal.cpp:5399-5416 loop
  structure: NextTree's -1.0 return value is used as the weight);
- the default --lineage_bin of 1e5 is treated as a log10 exponent, so
  epochs_focal[1] = exp(ln10·1e5)/ypg = inf (coal.cpp:5149-5156);
- epoch grids are float32; per-tree spans are float32.

Two execution modes (same dispatch shape as mode mut's --sampling):

- default (analytic): order-free f64 prefix-sum kernel
  (native/cond.cpp:cn_cond_chrom_fast) — exposures collapse to
  h_e(ancestor) − h_e(coal) differences accumulated once per ancestor
  via per-focal prefix sums, O(F·depth·E) per tree, threaded over
  fixed tree chunks with thread-count-independent results; rates agree
  with the reference to within its own f32 accumulation drift (~2e-4
  at 50k trees).
- --sampling mc_parity: bit-exact f32 replay of the reference's scalar
  add order (native/cond.cpp:cn_cond_chrom) — byte-identical output.

The sample-age-aware variant (coal.cpp:4885-4999) runs in the replay
(cn_cond_chrom with sample ages), whatever --sampling says.

Copied from colate_tpu/models/cond_coal.py with the imports rewritten and
without its Python fallback (``cond_rates_tree`` and
``_ancient_pair_accumulate``): both walks are the native library's, which
raises, naming its path, when it cannot be built or loaded.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.formats.anc import AncFile
from colate_tpu_torch.formats.fasta import read_fasta
from colate_tpu_torch.formats.gmap import RecombMap
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.formats.sample import Sample
from colate_tpu_torch.hostrng import MT19937
from colate_tpu_torch.models.tree_coal import tree_spans

BIN_SIZE = 30_000_000

# this mode declares `float log_10 = std::log(10)` (coal.cpp:5067) — the
# truncated constant shifts epoch values in the 6th digit
LOG10_F32 = float(np.float32(np.log(10.0)))


def default_epochs(years_per_gen: float) -> np.ndarray:
    """31 log-spaced epochs (coal.cpp:5138-5146), float32 grid."""
    E = 31
    ep = np.zeros(E, np.float64)
    ep[1] = 1e3 / years_per_gen
    for e in range(2, E - 1):
        ep[e] = np.exp(LOG10_F32 * (3.0 + 4.0 * (e - 1.0) / (E - 3.0))) / years_per_gen
    ep[E - 1] = 1e8 / years_per_gen
    return np.float32(ep).astype(np.float64)


def epochs_from_bins_cond(bins: str, years_per_gen: float) -> np.ndarray:
    parts = bins.split(",")
    lower = float(np.float32(parts[0]))
    upper = float(np.float32(parts[1]))
    step = float(np.float32(parts[2]))
    log10 = LOG10_F32
    ep = [0.0]
    b = lower
    while b < upper:
        ep.append(np.exp(log10 * b) / years_per_gen)
        b += step
    ep.append(np.exp(log10 * upper) / years_per_gen)
    ep.append(max(1e8, 10.0 * ep[-1]) / years_per_gen)
    return np.float32(np.array(ep)).astype(np.float64)


def _ep_init_of(coal_age, epochs):
    """largest ep with epochs[ep] < coal_age, or 0 (coal.cpp:4845-4851)."""
    if coal_age > epochs[0]:
        return int(np.searchsorted(epochs, coal_age, side="left")) - 1
    return 0


def _ep_focal_of(coal_age, epochs_focal):
    """largest ep with epochs_focal[ep] <= coal_age (coal.cpp:4813-4822)."""
    i = int(np.searchsorted(epochs_focal, coal_age, side="right")) - 1
    return max(i, 0)


def _map_recrates(ps_arr, pe_arr, has, gmap) -> np.ndarray:
    """Per-tree average recombination rate, reference cursor semantics
    (coal.cpp:5333-5385): one monotone segment index shared across the
    chromosome's trees; quirks replicated exactly — when the whole
    window sits inside one segment the rate is scaled by the distance to
    the segment END (not the window width), and a window crossing a full
    interior segment adds that segment's total gen-length unscaled."""
    bp = gmap.bp
    gp = gmap.gen_pos
    nseg = int(bp.size)
    index = 0
    out = np.full(ps_arr.shape[0], 1000.0)
    for t in range(ps_arr.shape[0]):
        if not has[t]:
            continue  # treeless: factor 0, value irrelevant
        pos_start = int(ps_arr[t])
        pos_end = int(pe_arr[t])
        recrate = 1000.0
        if index < nseg - 1:
            while index + 1 < nseg and pos_start > bp[index + 1]:
                index += 1
                if index + 2 == nseg:
                    break
            if index + 1 >= nseg:
                # the reference reads past recmap.bp here (UB,
                # coal.cpp:5358-5381); a map should cover the windows
                raise ValueError(
                    "recombination map ends before the tree windows "
                    f"(pos_start={pos_start} > last map point {bp[-1]})"
                )
            recrate = (gp[index + 1] - gp[index]) / (bp[index + 1] - bp[index]) * 1e6
            if index < nseg - 1:
                lower = pos_start
                recrate *= bp[index + 1] - lower
                while pos_end > bp[index + 1]:
                    index += 1
                    if index + 1 >= nseg:
                        raise ValueError(
                            "recombination map ends before the tree windows "
                            f"(pos_end={pos_end} > last map point {bp[-1]})"
                        )
                    lower = bp[index]
                    if pos_end > bp[index + 1]:
                        recrate += (gp[index + 1] - gp[index]) * 1e6
                    else:
                        recrate += (
                            (gp[index + 1] - gp[index])
                            / (bp[index + 1] - bp[index])
                            * 1e6
                            * (pos_end - lower)
                        )
                    if index + 2 == nseg:
                        break
                recrate /= pos_end - pos_start
        out[t] = recrate
    return out


def _cond_marshal(anc, spans, pass_frac, cutoff, tree_blocks, focal, cond,
                  cond_empty, goh):
    """Shared ctypes marshalling for the two native CondCoalRates
    kernels: masked f32 factors (NaN = mask/map filtered), contiguous
    tree arrays, and the focal/conditional/group id vectors."""
    factors = spans.astype(np.float32).copy()
    factors[pass_frac < cutoff] = np.nan
    parent = np.ascontiguousarray(anc.parent, np.int32)
    blen = np.ascontiguousarray(anc.branch_length, np.float64)
    tb = np.ascontiguousarray(tree_blocks, np.int32)
    fo = np.ascontiguousarray(focal, np.int32)
    co = np.ascontiguousarray(
        np.array([-1], np.int32) if cond_empty else cond.astype(np.int32)
    )
    gh = np.ascontiguousarray(goh, np.int32)
    return factors, parent, blen, tb, fo, co, gh


def _cond_chrom_native(
    anc, spans, pass_frac, cutoff, tree_blocks, chr_bin, focal, cond,
    cond_empty, goh, G, epochs, epochs_focal, blocks_num, blocks_denom,
    sample_ages,
) -> None:
    """Run one chromosome through native/cond.cpp:cn_cond_chrom, the f32
    replay; raises when the native library cannot be built or loaded.

    The stale-tree -1.0 extra pass (reference loop quirk) is appended as
    a (T+1)-th tree so its float32 adds land after all real trees, in
    reference order."""
    import ctypes

    from colate_tpu_torch import native

    lib = native.load()
    T = anc.num_trees
    N = anc.n_hap
    M = 2 * N - 1
    F_ep = epochs_focal.shape[0]
    E = epochs.shape[0]

    factors, parent, blen, tb, fo, co, gh = _cond_marshal(
        anc, spans, pass_frac, cutoff, tree_blocks, focal, cond, cond_empty,
        goh,
    )
    # reference loop quirk: one extra pass on the last tree, factor -1,
    # appended so its f32 adds land LAST (the replay preserves order)
    if not np.isnan(factors[T - 1]):
        factors = np.append(factors, np.float32(-1.0))
        parent = np.concatenate([parent, parent[T - 1 :]])
        blen = np.concatenate([blen, blen[T - 1 :]])
        tb = np.append(tb, tb[T - 1])
    nb = int(tree_blocks.max()) + 1
    buf_n = np.zeros((nb, F_ep, E, G), np.float32)
    buf_d = np.zeros_like(buf_n)
    ep32 = np.ascontiguousarray(np.float32(epochs))
    epf32 = np.ascontiguousarray(np.float32(epochs_focal))
    sa_p = None
    if sample_ages is not None:
        sa_arr = np.ascontiguousarray(sample_ages, np.float64)
        sa_p = sa_arr.ctypes.data
    p = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_cond_chrom(
        int(factors.shape[0]), M, N, p(parent), p(blen), p(factors), p(tb),
        p(fo), fo.size, p(co), co.size, p(gh), G, p(ep32), E, p(epf32), F_ep,
        ctypes.c_void_p(sa_p), p(buf_n), p(buf_d),
    )
    for k in range(chr_bin, nb):
        blocks_num[k] = buf_n[k]
        blocks_denom[k] = buf_d[k]


def _cond_chrom_fast_native(
    anc, spans, pass_frac, cutoff, tree_blocks, chr_bin, focal, cond,
    cond_empty, goh, G, epochs, epochs_focal, blocks_num, blocks_denom,
) -> None:
    """Analytic f64 CondCoalRates kernel (native/cond.cpp:
    cn_cond_chrom_fast) — the default mode.  Order-free prefix-sum
    accumulation, threaded over fixed tree chunks (results independent
    of the thread count); same semantics as the reference walk
    (coal.cpp:4785-4882) modulo f32 rounding/order, which the
    ``--sampling mc_parity`` replay preserves instead.  Raises when the
    native library cannot be built or loaded."""
    import ctypes

    from colate_tpu_torch import native

    lib = native.load()
    T = anc.num_trees
    N = anc.n_hap
    M = 2 * N - 1
    F_ep = epochs_focal.shape[0]
    E = epochs.shape[0]

    factors, parent, blen, tb, fo, co, gh = _cond_marshal(
        anc, spans, pass_frac, cutoff, tree_blocks, focal, cond, cond_empty,
        goh,
    )
    nb = int(tree_blocks.max()) + 1
    buf_n = np.zeros((nb, F_ep, E, G), np.float64)
    buf_d = np.zeros_like(buf_n)
    ep64 = np.ascontiguousarray(epochs, np.float64)
    epf64 = np.ascontiguousarray(epochs_focal, np.float64)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.cn_cond_chrom_fast(
        T, M, N, p(parent), p(blen), p(factors), p(tb),
        p(fo), fo.size, p(co), co.size, p(gh), G, p(ep64), E, p(epf64), F_ep,
        p(buf_n), p(buf_d),
    )
    # reference loop quirk: one extra pass on the last tree with factor
    # -1 — the f64 kernel is order-free, so run it as a second T=1 call
    # on views of the same arrays (no whole-chromosome copies)
    if not np.isnan(factors[T - 1]):
        neg = np.array([-1.0], np.float32)
        lib.cn_cond_chrom_fast(
            1, M, N, p(parent[T - 1 :]), p(blen[T - 1 :]), p(neg),
            p(tb[T - 1 :]), p(fo), fo.size, p(co), co.size, p(gh), G,
            p(ep64), E, p(epf64), F_ep, p(buf_n), p(buf_d),
        )
    for k in range(chr_bin, nb):
        blocks_num[k] = buf_n[k]
        blocks_denom[k] = buf_d[k]


def run_cond_coal(args) -> int:
    if not args.input or not args.output or not args.poplabels or not args.groups:
        print("Needed: input, output, poplabels, groups.", file=sys.stderr)
        return 2
    ypg = float(np.float32(args.years_per_gen)) if args.years_per_gen else 28.0
    epochs = (
        epochs_from_bins_cond(args.bins, ypg) if args.bins else default_epochs(ypg)
    )
    lineage_bin = float(np.float32(args.lineage_bin)) if args.lineage_bin else 1e5
    with np.errstate(over="ignore"):
        ef1 = np.float32(np.exp(LOG10_F32 * lineage_bin)) / np.float32(ypg)
    epochs_focal = np.array([0.0, float(ef1)], np.float64)

    seed = args.seed if args.seed is not None else 1
    rng = MT19937(seed)
    sample = Sample.read(args.poplabels)
    g1, g2 = (args.groups.split(",") + [""])[:2]
    goh = sample.group_of_haplotype
    names = np.array(sample.groups, dtype=object)
    focal = np.nonzero(names[goh] == g1)[0]
    cond = np.nonzero(names[goh] == g2)[0]
    if focal.size == 0:
        print("Error: groups not found", file=sys.stderr)
        return 1
    cond_empty = cond.size == 0
    G = len(sample.groups)
    E = epochs.shape[0]
    F_ep = epochs_focal.shape[0]

    chroms = ["NA"]
    if args.chr_file:
        with open(args.chr_file) as fh:
            chroms = [ln.strip() for ln in fh if ln.strip()]

    blocks_num: list[np.ndarray] = []
    blocks_denom: list[np.ndarray] = []
    chr_bin = 0
    used_fast = False  # any chromosome through the analytic f64 kernel
    # the reference parses --mask_cutoff but CondCoalRates reads the
    # never-registered "cutoff" option (coal.cpp:5237 vs Colate.cpp:30),
    # so the effective cutoff is ALWAYS the 0.9 default — replicated;
    # COLATE_TPU_MASK_CUTOFF overrides as an engine extension
    import os as _os

    cutoff = float(_os.environ.get("COLATE_TPU_MASK_CUTOFF", 0.9))
    for c in chroms:
        base = args.input if c == "NA" else f"{args.input}_chr{c}"
        anc = AncFile.read(base + ".anc", columns="tree")
        mut = MutTable.read(base + ".mut")
        mask = None
        if args.mask:
            mpath = args.mask if c == "NA" else f"{args.mask}_chr{c}.fa"
            mask = np.frombuffer(read_fasta(mpath).encode(), np.uint8)
        gmap = None
        if args.map:
            gpath = args.map if c == "NA" else f"{args.map}_chr{c}.txt"
            gmap = RecombMap.load(gpath)

        spans = np.float32(tree_spans(anc, mut)).astype(np.float64)
        T = anc.num_trees
        sample_ages = anc.sample_ages
        if sample_ages is not None and not np.any(np.asarray(sample_ages) > 0):
            sample_ages = None

        # tree -> 30Mb block by first-SNP position; mut.tree is
        # nondecreasing, so per-tree row ranges are two searchsorteds —
        # no per-tree rescans (O(T+rows) total)
        n = len(mut)
        tree_arr = mut.tree
        row_lo = np.searchsorted(tree_arr, np.arange(T), side="left")
        row_hi = np.searchsorted(tree_arr, np.arange(T), side="right")
        if n:
            first_pos = mut.pos[np.minimum(row_lo, n - 1)].astype(np.int64)
        else:
            first_pos = np.zeros(T, np.int64)
        tree_blocks = (first_pos // BIN_SIZE).astype(np.int64) + chr_bin
        max_blk = int(tree_blocks.max()) if T else chr_bin
        while len(blocks_num) <= max_blk:
            blocks_num.append(np.zeros((F_ep, E, G)))
            blocks_denom.append(np.zeros((F_ep, E, G)))

        # mask / recomb-map passing fraction for every tree in one pass.
        # Window semantics (coal.cpp:5296-5321): ps = first-row pos,
        # averaged with the previous row by C++ INTEGER division when one
        # exists; pe = (next tree's first-row pos + this tree's last-row
        # pos) // 2, or ((ps+1) + last-row pos) // 2 for the final tree.
        pass_frac = np.ones(T)
        if (mask is not None or gmap is not None) and n and T:
            has = row_lo < row_hi
            i0 = np.minimum(row_lo, n - 1)
            i1 = np.minimum(np.maximum(row_hi - 1, 0), n - 1)
            pos64 = mut.pos.astype(np.int64)
            ps = pos64[i0]
            ps = np.where(
                i0 > 0, (ps + pos64[np.maximum(i0 - 1, 0)]) // 2, ps
            )
            pe_raw = np.where(i1 + 1 < n, pos64[np.minimum(i1 + 1, n - 1)], ps + 1)
            pe = (pe_raw + pos64[i1]) // 2
            pe = np.maximum(pe, ps + 1)
            if mask is not None:
                pcum = np.concatenate([[0], np.cumsum(mask == ord("P"))])
                L = mask.shape[0]
                a = np.clip(ps, 0, L)
                b = np.clip(pe, 0, L)
                pass_frac = np.where(
                    has, (pcum[b] - pcum[a]) / (pe - ps), 1.0
                )
            if gmap is not None and gmap.bp.size > 1:
                rec = _map_recrates(ps, pe, has, gmap)
                pass_frac = np.where(has & (rec > 0.1), 0.0, pass_frac)

        # default (analytic) mode: order-free f64 prefix-sum kernel,
        # threaded (native/cond.cpp:cn_cond_chrom_fast).  --sampling
        # mc_parity (and the sample-age-aware variant) instead replays
        # the reference's f32 accumulation order bit-exactly
        # (cn_cond_chrom) — there the rounding pattern over millions of
        # adds is part of the observable output.
        parity = (getattr(args, "sampling", None) or "analytic") == "mc_parity"
        if T and not parity and sample_ages is None:
            _cond_chrom_fast_native(
                anc, spans, pass_frac, cutoff, tree_blocks, chr_bin, focal,
                cond, cond_empty, goh, G, epochs, epochs_focal,
                blocks_num, blocks_denom,
            )
            used_fast = True
        elif T:
            _cond_chrom_native(
                anc, spans, pass_frac, cutoff, tree_blocks, chr_bin, focal,
                cond, cond_empty, goh, G, epochs, epochs_focal,
                blocks_num, blocks_denom, sample_ages,
            )
        chr_bin = max_blk + 1

    num_blocks = len(blocks_num)
    B = args.num_bootstraps or 1
    with open(args.output, "w") as os_:
        os_.write("boot lineage_epoch epoch.start group rate\n")
        for it in range(B):
            if B == 1:
                w = np.ones(num_blocks)
            else:
                w = np.zeros(num_blocks)
                np.add.at(w, rng.uniform_int(0, num_blocks - 1, num_blocks), 1.0)
            # replay blocks: block reduce + divide in float32, sequential
            # block order — matching the reference's res_num accumulation
            # (coal.cpp:5540-5556, CollapsedMatrix<float>); the analytic
            # f64 kernel's blocks reduce in f64
            rdt = np.float64 if used_fast else np.float32
            res_num = np.zeros((F_ep, E, G), rdt)
            res_den = np.zeros((F_ep, E, G), rdt)
            for k in range(num_blocks):
                wk = rdt(w[k])
                res_num += wk * blocks_num[k].astype(rdt)
                res_den += wk * blocks_denom[k].astype(rdt)
            with np.errstate(divide="ignore", invalid="ignore"):
                rates = res_num / res_den
            for e1 in range(F_ep):
                for e2 in range(E):
                    for g in range(G):
                        r = rates[e1, e2, g]
                        rs = (
                            ("-nan" if np.signbit(r) else "nan")
                            if np.isnan(r)
                            else f"{r:g}"
                        )
                        os_.write(
                            f"{it} {epochs_focal[e1]:g} {epochs[e2]:g} "
                            f"{sample.groups[g]} {rs}\n"
                        )
    print(f"CondCoalRates -> {args.output}", file=sys.stderr)
    return 0
