"""Synthetic inputs made from a seed, for the tests and ``chip_smoke.py``:
no JAX, nothing of colate_tpu.

- :func:`make_fixture` writes a ``.mut`` per chromosome and a target and a
  reference ``.colate.in`` shaped like Relate output (sorted positions,
  age intervals from a crude coalescent-ish law, a mix of rows the join
  filters out), through the port's own formats.  The same seed writes the
  same bytes as the JAX package's test fixture (tests/helpers/synth.py).
- :func:`synthetic_sites`, :func:`beyond_table_sites` and
  :func:`bench_sites` make joined site streams for the analytic binning,
  and :func:`hist_rel` is the error measure the binning is held to.
- :func:`make_anc_mut` writes a Relate ``.anc``/``.mut`` pair of random
  coalescent trees (the bytes of the JAX package's test fixture,
  tests/helpers/synth_anc.py); :func:`random_trees` and
  :func:`tree_chromosome` make a chromosome of Kingman trees at a
  realistic scale in memory (tools/bench_tree.py's generator),
  :func:`write_anc` writes it fast, :func:`write_segment_poplabels`
  writes segment-format ancestry labels (tools/bench_aux.py's layout), and
  :func:`write_genealogy` writes trees in the formats of other inference
  tools (Newick, RENT+, ARGweaver SMC) for the importers of formats/anc.py.
- BCF and BAM inputs of mode ``mut``: copies of the JAX package's test
  generators (:func:`make_ref_genome`, :func:`make_vcf_for_mut`,
  :func:`vcf_text_to_bcf2`, :func:`make_bam`) and of
  tools/bench_bam_stream.py's :func:`gen_bam`, which write the same bytes;
  :func:`write_bcf` writes BCF2 from numpy at the north-star scale, and
  :func:`write_fixture_bcfs` and :func:`make_bam_fixture` build the
  BCF and BAM workloads of ``chip_smoke.py``.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np

from colate_tpu_torch.formats.anc import AncFile
from colate_tpu_torch.formats.colate_in import write_colate_in
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.pipeline.join import JoinedSites


def make_mut(
    path: str,
    n: int,
    seed: int,
    chrom_span: int = 70_000_000,
    dirty: bool = True,
    top_bin_frac: float = 0.0,
) -> MutTable:
    """Write a synthetic .mut with n rows; returns the table.

    ``top_bin_frac`` > 0 gives that fraction of rows age_begin == 0 and
    age_end inside the LAST age bin (bin 184: age in ~[8.44e6, 9.33e6)
    generations) so the emp-F redistribution carries mass in the top bin
    — the regime where the reference's width-scaling loop leaves
    F[num_age_bins-1] unscaled (coal.cpp:3420-3426).
    """
    g = np.random.default_rng(seed)
    pos = np.sort(g.choice(np.arange(1, chrom_span), size=n, replace=False))
    dist = np.diff(np.append(pos, chrom_span)).astype(np.int64)
    age_end = np.exp(g.uniform(np.log(10.0), np.log(3e5), n))
    frac = g.uniform(0.0, 0.9, n)
    age_begin = age_end * frac
    # ~20% of rows have age_begin == 0 (routes into the emp matrices)
    zero_mask = g.random(n) < 0.2
    age_begin[zero_mask] = 0.0
    if top_bin_frac > 0.0:
        top = g.random(n) < top_bin_frac
        age_end[top] = g.uniform(8.6e6, 9.2e6, int(top.sum()))
        age_begin[top] = 0.0
    bases = np.array(list("ACGT"))
    anc = bases[g.integers(0, 4, n)]
    shift = g.integers(1, 4, n)
    der = bases[(np.searchsorted(bases, anc) + shift) % 4]
    mtype = np.array([f"{a}/{d}" for a, d in zip(anc, der)], dtype=object)
    flipped = np.zeros(n, np.int64)
    nbr = np.ones(n, np.int64)
    if dirty:
        # filter-triggering rows: flipped, multi-branch, inverted ages, junk alleles
        flipped[g.random(n) < 0.03] = 1
        multi = g.random(n) < 0.03
        nbr[multi] = 2
        inv = g.random(n) < 0.03
        age_begin[inv], age_end[inv] = age_end[inv], age_begin[inv] * 1.5 + 1.0
        junk = g.random(n) < 0.02
        for i in np.nonzero(junk)[0]:
            mtype[i] = "N/A"
    branch = [[0] if k == 1 else [0, 1] for k in nbr]
    tbl = MutTable(
        header=(
            "snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;is_not_mapping;"
            "is_flipped;age_begin;age_end;ancestral_allele/alternative_allele;"
            "upstream_allele;downstream_allele;"
        ),
        snp_id=np.arange(n, dtype=np.int64),
        pos=pos.astype(np.int64),
        dist=dist,
        rs_id=np.array([f"rs{i}" for i in range(n)], dtype=object),
        tree=np.zeros(n, np.int64),
        branch=branch,
        num_branches=nbr,
        flipped=flipped,
        age_begin=np.float32(age_begin).astype(np.float64),
        age_end=np.float32(age_end).astype(np.float64),
        mutation_type=mtype,
        rest=np.array([""] * n, dtype=object),
    )
    tbl.write(path)
    return tbl


def make_stream(
    path: str,
    chroms: list[str],
    mut_tables: list[MutTable],
    seed: int,
    n_hap: int,
    p_present: float = 0.85,
    p_allele_mismatch: float = 0.03,
):
    """Write a .colate.in covering a random subset of the .mut sites."""
    g = np.random.default_rng(seed)
    all_chrom, all_bp, all_anc, all_der, all_aaf, all_daf = [], [], [], [], [], []
    for chrom, mt in zip(chroms, mut_tables):
        n = len(mt)
        present = g.random(n) < p_present
        idx = np.nonzero(present)[0]
        anc = mt.anc_allele[idx].copy()
        der = mt.der_allele[idx].copy()
        # some records carry mismatching alleles (join must reject them)
        bad = g.random(idx.size) < p_allele_mismatch
        for i in np.nonzero(bad)[0]:
            anc[i], der[i] = der[i], anc[i]
        daf = g.integers(0, n_hap + 1, idx.size)
        aaf = n_hap - daf
        ok = np.array([len(a) == 1 and len(d) == 1 for a, d in zip(anc, der)])
        idx, anc, der, daf, aaf = idx[ok], anc[ok], der[ok], daf[ok], aaf[ok]
        all_chrom.append(np.full(idx.size, chrom, dtype=object))
        all_bp.append(mt.pos[idx])
        all_anc.append(np.array([ord(a) for a in anc], np.uint8))
        all_der.append(np.array([ord(d) for d in der], np.uint8))
        all_aaf.append(aaf)
        all_daf.append(daf)
    write_colate_in(
        path,
        np.concatenate(all_chrom),
        np.concatenate(all_bp),
        np.concatenate(all_anc),
        np.concatenate(all_der),
        np.concatenate(all_aaf),
        np.concatenate(all_daf),
    )


def make_fixture(
    root: str,
    chroms=("1", "2"),
    n_per_chrom: int = 4000,
    seed: int = 7,
    n_hap_target: int = 2,
    n_hap_ref: int = 20,
    dirty: bool = True,
    top_bin_frac: float = 0.0,
):
    """Standard tmptmp fixture; returns dict of paths."""
    os.makedirs(root, exist_ok=True)
    muts = []
    for i, c in enumerate(chroms):
        muts.append(
            make_mut(
                os.path.join(root, f"synth_chr{c}.mut"),
                n_per_chrom,
                seed + 13 * i,
                dirty=dirty,
                top_bin_frac=top_bin_frac,
            )
        )
    tgt = os.path.join(root, "target.colate.in")
    ref = os.path.join(root, "ref.colate.in")
    make_stream(tgt, list(chroms), muts, seed + 101, n_hap_target)
    make_stream(ref, list(chroms), muts, seed + 202, n_hap_ref)
    chrfile = os.path.join(root, "chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("\n".join(chroms) + "\n")
    return dict(
        root=root,
        chroms=list(chroms),
        mut_prefix=os.path.join(root, "synth"),
        target=tgt,
        reference=ref,
        chrfile=chrfile,
        mut_tables=muts,
    )


def synthetic_sites(n=20000, nb=7, seed=0, age=0.0, sorted_blocks=True) -> JoinedSites:
    """tests/test_bin_pallas.py:_sites, with age_end kept above age_begin:
    at age > 0 its emp rows could end before they begin, and native
    ``cn_bin_analytic`` drops such sites while the device binnings keep
    them (ROADMAP queue 3).  At age 0 the sites are the same."""
    g = np.random.default_rng(seed)
    ab = np.exp(g.uniform(np.log(1e-1), np.log(1e4), n))
    ae = ab * np.exp(g.uniform(0.05, 2.0, n))
    emp = g.uniform(size=n) < 0.15
    ab[emp] = age  # emp rows: age_begin <= age
    ae = np.maximum(ae, ab + 1e-3)
    blocks = g.integers(0, nb, n)
    if sorted_blocks:
        blocks = np.sort(blocks)
    return JoinedSites(
        age_begin=ab, age_end=ae,
        w_shared=g.uniform(0, 2, n), w_notshared=g.uniform(0, 2, n),
        block_id=blocks.astype(np.int32), num_blocks=nb,
    )


def beyond_table_sites(n=2000, seed=9) -> JoinedSites:
    """Sites whose ages run past the last bin edge (~9.3e6 generations),
    30% of them emp, in 3 blocks."""
    g = np.random.default_rng(seed)
    ab = np.exp(g.uniform(np.log(1e5), np.log(5e7), n))
    ae = ab * np.exp(g.uniform(0.05, 2.0, n))
    ab[g.uniform(size=n) < 0.3] = 0.0
    return JoinedSites(
        age_begin=ab, age_end=ae, w_shared=g.uniform(0, 2, n), w_notshared=g.uniform(0, 2, n),
        block_id=np.sort(g.integers(0, 3, n)).astype(np.int32), num_blocks=3,
    )


def bench_sites(n: int, nb: int = 125) -> JoinedSites:
    """bench.py:344-356's binning input at n sites: a whole genome's 125
    blocks, 10% emp sites, sorted block ids."""
    g = np.random.default_rng(0)
    ab = np.exp(g.uniform(np.log(1e-1), np.log(1e4), n))
    ae = ab * np.exp(g.uniform(0.05, 2.0, n))
    emp = g.uniform(size=n) < 0.1
    ab[emp] = 0.0
    return JoinedSites(
        age_begin=ab, age_end=ae,
        w_shared=g.uniform(0, 2, n), w_notshared=g.uniform(0, 2, n),
        block_id=np.sort(g.integers(0, nb, n)).astype(np.int32),
        num_blocks=nb,
    )


def hist_rel(ours, ref) -> float:
    """Largest deviation over four float64 histograms, relative to each
    one's max; empty histograms count as no deviation."""
    if not len(ours) == len(ref) == 4:
        raise ValueError(f"expected four histograms, got {len(ours)} and {len(ref)}")
    worst = 0.0
    for a, b in zip(ours, ref):
        if a.shape != b.shape or a.dtype != np.float64 or b.dtype != np.float64:
            raise ValueError(f"histograms {a.shape} {a.dtype} and {b.shape} {b.dtype}")
        if b.size:
            worst = max(worst, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)))
    return worst


MUT_HEADER = (
    "snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;is_not_mapping;"
    "is_flipped;age_begin;age_end;ancestral_allele/alternative_allele;"
    "upstream_allele;downstream_allele;"
)


def random_tree(g, N: int, rate: float = 1e-4):
    """One Kingman-ish tree: returns (parent[2N-1], blen[2N-1], ages[2N-1]).

    Leaves 0..N-1 at age 0; internal nodes N..2N-2 in coalescence order
    (parents always numbered after children, like Relate output)."""
    M = 2 * N - 1
    parent = np.full(M, -1, np.int64)
    ages = np.zeros(M, np.float64)
    active = list(range(N))
    t = 0.0
    nxt = N
    while len(active) > 1:
        k = len(active)
        t += g.exponential(1.0 / (rate * k * (k - 1) / 2.0))
        i, j = g.choice(len(active), size=2, replace=False)
        a, b = active[i], active[j]
        parent[a] = nxt
        parent[b] = nxt
        ages[nxt] = t
        active = [x for x in active if x not in (a, b)] + [nxt]
        nxt += 1
    blen = np.zeros(M, np.float64)
    for u in range(M - 1):
        blen[u] = ages[parent[u]] - ages[u]
    return parent, blen, ages


def make_anc_mut(
    prefix: str,
    chrom: str,
    N: int = 10,
    num_trees: int = 37,
    snps_per_tree: int = 20,
    seed: int = 0,
    skip_trees: tuple = (),
    sample_ages=None,
):
    """Write <prefix>_chr<chrom>.anc/.mut; some trees can have no SNPs.
    Returns the (AncFile, MutTable) written."""
    g = np.random.default_rng(seed)
    M = 2 * N - 1
    parent = np.empty((num_trees, M), np.int32)
    blen = np.empty((num_trees, M), np.float64)
    start = np.zeros(num_trees, np.int64)
    snp = 0
    rows_tree, rows_pos = [], []
    bp = 100
    for t in range(num_trees):
        p, b, _ = random_tree(g, N)
        parent[t] = p
        blen[t] = b
        start[t] = snp
        if t not in skip_trees:
            for _ in range(int(g.integers(max(1, snps_per_tree // 2), snps_per_tree + 1))):
                rows_tree.append(t)
                rows_pos.append(bp)
                bp += int(g.integers(50, 3000))
                snp += 1
    anc = AncFile(
        n_hap=N,
        sample_ages=(
            None if sample_ages is None else np.asarray(sample_ages, np.float64)
        ),
        start_pos=start,
        parent=parent,
        branch_length=blen,
        num_events=np.ones((num_trees, M), np.float32),
        snp_begin=np.zeros((num_trees, M), np.int32),
        snp_end=np.zeros((num_trees, M), np.int32),
    )
    anc.write(f"{prefix}_chr{chrom}.anc")

    n = len(rows_tree)
    pos = np.array(rows_pos, np.int64)
    dist = np.diff(np.append(pos, pos[-1] + 1000)).astype(np.int64)
    bases = np.array(list("ACGT"))
    anc_al = bases[g.integers(0, 4, n)]
    der_al = bases[(np.searchsorted(bases, anc_al) + g.integers(1, 4, n)) % 4]
    tbl = MutTable(
        header=MUT_HEADER,
        snp_id=np.arange(n, dtype=np.int64),
        pos=pos,
        dist=dist,
        rs_id=np.array([f"rs{i}" for i in range(n)], dtype=object),
        tree=np.array(rows_tree, np.int64),
        branch=[[int(g.integers(0, M - 1))] for _ in range(n)],
        num_branches=np.ones(n, np.int64),
        flipped=np.zeros(n, np.int64),
        age_begin=np.zeros(n, np.float64),
        age_end=np.full(n, 100.0, np.float64),
        mutation_type=np.array([f"{a}/{d}" for a, d in zip(anc_al, der_al)], object),
        rest=np.array([""] * n, dtype=object),
    )
    tbl.write(f"{prefix}_chr{chrom}.mut")
    return anc, tbl


def random_trees(g, T: int, N: int, rate: float = 1e-4):
    """Vectorised Kingman topologies: parent [T, 2N-1] + node ages [T, 2N-1].

    All T trees advance one coalescence per step (N-1 steps of O(T)
    vector work), so 60,000 trees of 200 haplotypes take seconds; leaves
    at age 0, internal nodes numbered in coalescence (age) order."""
    M = 2 * N - 1
    parent = np.full((T, M), -1, np.int64)
    ages = np.zeros((T, M), np.float64)
    rows = np.arange(T)
    act = np.tile(np.arange(N), (T, 1))  # active lineage ids per slot
    t = np.zeros(T, np.float64)
    for s in range(N - 1):
        k = N - s
        t += g.exponential(1.0 / (rate * k * (k - 1) / 2.0), T)
        i = g.integers(0, k, T)
        j = g.integers(0, k - 1, T)
        j += j >= i
        a, b = act[rows, i], act[rows, j]
        new = N + s
        parent[rows, a] = new
        parent[rows, b] = new
        ages[:, new] = t
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        act[rows, lo] = new
        act[rows, hi] = act[:, k - 1]
    return parent, ages


def tree_chromosome(T: int, N: int, seed: int):
    """A chromosome of T Kingman trees of N haplotypes in memory, laid out
    as tools/bench_tree.py writes it: (AncFile, MutTable, node ages
    [T, 2N-1] float64), two .mut rows a tree at gaps of 50-3000 bp."""
    g = np.random.default_rng(seed)
    M = 2 * N - 1
    parent, ages = random_trees(g, T, N)
    blen = np.where(parent >= 0, np.take_along_axis(ages, np.maximum(parent, 0), 1) - ages, 0.0)
    spt = 2
    n = T * spt
    pos = 100 + np.cumsum(g.integers(50, 3000, n))
    anc = AncFile(
        n_hap=N,
        sample_ages=None,
        start_pos=np.arange(T, dtype=np.int64) * spt,
        parent=parent.astype(np.int32),
        branch_length=blen,
        num_events=np.ones((T, M), np.float32),
        snp_begin=np.zeros((T, M), np.int32),
        snp_end=np.zeros((T, M), np.int32),
    )
    mut = MutTable(
        header=MUT_HEADER,
        snp_id=np.arange(n, dtype=np.int64),
        pos=pos.astype(np.int64),
        dist=np.diff(np.append(pos, pos[-1] + 1000)).astype(np.int64),
        rs_id=np.array([f"rs{i}" for i in range(n)], dtype=object),
        tree=np.repeat(np.arange(T, dtype=np.int64), spt),
        branch=[[int(b)] for b in g.integers(0, M - 1, n)],
        num_branches=np.ones(n, np.int64),
        flipped=np.zeros(n, np.int64),
        age_begin=np.zeros(n, np.float64),
        age_end=np.full(n, 100.0, np.float64),
        mutation_type=np.full(n, "A/C", dtype=object),
        rest=np.array([""] * n, dtype=object),
    )
    return anc, mut, ages


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    """[..., width] ASCII digits of the nonnegative integers x, right
    aligned, leading zeros as byte 0 (the units digit always kept)."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    lead = (x[..., None] < p) & (p > 1)
    return np.where(lead, 0, (x[..., None] // p) % 10 + 48).astype(np.uint8)


def write_anc(path: str, anc: AncFile, trees_per_pass: int = 2000) -> None:
    """Write ``anc`` in the layout of :meth:`AncFile.write`, built as bytes
    with numpy: a branch length is its float64 product by 1e5 rounded half
    to even, printed with 5 decimals (%.5f rounds the exact binary value:
    the two differ only on a tie that near), num_events, SNP_begin and
    SNP_end as ``1.000 0 0``.  Several times faster than
    :meth:`AncFile.write`, which formats record by record."""
    T, M = anc.parent.shape
    if not (np.all(anc.num_events == 1.0) and not anc.snp_begin.any() and not anc.snp_end.any()):
        raise ValueError("write_anc writes num_events 1 and SNP ranges 0 only")
    bl = np.rint(np.asarray(anc.branch_length, np.float64) * 1e5).astype(np.int64)
    if (bl < 0).any() or (anc.parent < -1).any():
        raise ValueError("write_anc needs nonnegative branch lengths and parents >= -1")
    wp = len(str(M))
    wi = len(str(int(bl.max(initial=0)) // 100000))
    sep = np.frombuffer(b":(", np.uint8)
    tail = np.frombuffer(b" 1.000 0 0) ", np.uint8)
    with open(path, "wb") as fh:
        head = f"NUM_HAPLOTYPES {anc.n_hap}"
        if anc.sample_ages is not None:
            head += "".join(f" {a:g}" for a in anc.sample_ages)
        fh.write(f"{head}\nNUM_TREES {T}\n".encode())
        for t0 in range(0, T, trees_per_pass):
            par = np.asarray(anc.parent[t0 : t0 + trees_per_pass], np.int64)
            b = bl[t0 : t0 + trees_per_pass]
            n = par.shape[0]
            pd = _digits(np.maximum(par, 0), wp)
            pd[par < 0] = np.concatenate([np.zeros(wp - 2, np.uint8), np.frombuffer(b"-1", np.uint8)])
            frac = b % 100000
            rec = np.concatenate([
                pd,
                np.broadcast_to(sep, (n, M, sep.size)),
                _digits(b // 100000, wi),
                np.full((n, M, 1), ord("."), np.uint8),
                ((frac[..., None] // 10 ** np.arange(4, -1, -1)) % 10 + 48).astype(np.uint8),
                np.broadcast_to(tail, (n, M, tail.size)),
            ], axis=2).reshape(n, -1)
            line = np.concatenate([
                _digits(np.asarray(anc.start_pos[t0 : t0 + n], np.int64), 19),
                np.broadcast_to(np.frombuffer(b": ", np.uint8), (n, 2)), rec,
                np.full((n, 1), ord("\n"), np.uint8),
            ], axis=1)
            fh.write(line[line != 0].tobytes())


def write_genealogy(path: str, anc: AncFile, fmt: str, ne: float = 1.0, seed: int = 0) -> None:
    """Write the trees of ``anc`` as another inference tool does, one line
    a tree, for the importers of formats/anc.py (gzip when ``path`` ends
    in ``.gz``); each child written in index order, branch lengths ``%.9g``:

    - ``"newick"``: ``<start_snp> <newick>;``, 0-based leaf labels
      (``read_newick_trees``);
    - ``"rent"``: ``<start_snp> <newick>``, 1-based leaf labels, branch
      lengths divided by ``ne`` (``read_rent(path, ne)``);
    - ``"smc"``: ARGweaver's layout (``read_argweaver_smc``): a ``NAMES``
      header of the 1-based haplotype of each newick leaf id (a random
      permutation), a ``REGION`` line, then ``TREE <start> <end>
      <newick>;`` with ``[&&NHX:age=...]`` annotations and each internal
      node labelled after its ``)`` by a random permutation of N..2N-2,
      drawn from ``seed`` tree by tree, so the root is rarely 2N-2.
    """
    if fmt not in ("newick", "rent", "smc"):
        raise ValueError(f"unknown genealogy format {fmt!r}")
    g = np.random.default_rng(seed)
    T, M = anc.parent.shape
    N = anc.n_hap
    if fmt == "smc":
        names = g.permutation(N) + 1
        leaf = np.empty(N, np.int64)
        leaf[names - 1] = np.arange(N)  # the newick leaf id of each haplotype
    else:
        leaf = np.arange(N) + (fmt == "rent")
    scale = 1.0 / ne if fmt == "rent" else 1.0
    lines = []
    if fmt == "smc":
        lines.append("NAMES\t" + "\t".join(map(str, names)) + "\n")
        lines.append(f"REGION\tchr\t1\t{int(anc.start_pos[-1]) + 1}\n")
    for t in range(T):
        par = anc.parent[t].tolist()
        bl = (np.asarray(anc.branch_length[t], np.float64) * scale).tolist()
        label = (g.permutation(N - 1) + N).tolist() if fmt == "smc" else None
        kids = [[] for _ in range(M)]
        root = -1
        for j, p in enumerate(par):
            if p >= 0:
                kids[p].append(j)
            else:
                root = j
        order, stack = [], [root]
        while stack:
            u = stack.pop()
            order.append(u)
            stack.extend(kids[u])
        text = [""] * M
        age = [0.0] * M
        for u in reversed(order):
            if u < N:
                text[u] = str(int(leaf[u]))
                continue
            parts = []
            for c in kids[u]:
                age[u] = max(age[u], age[c] + bl[c])
                nhx = f"[&&NHX:age={age[c]:.9g}]" if fmt == "smc" else ""
                parts.append(f"{text[c]}:{bl[c]:.9g}{nhx}")
            text[u] = "(" + ",".join(parts) + ")" + (str(label[u - N]) if label else "")
        pos = int(anc.start_pos[t])
        if fmt == "smc":
            end = int(anc.start_pos[t + 1]) - 1 if t + 1 < T else pos
            lines.append(f"TREE\t{pos}\t{end}\t{text[root]}[&&NHX:age={age[root]:.9g}];\n")
        else:
            lines.append(f"{pos} {text[root]}{';' if fmt == 'newick' else ''}\n")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        fh.writelines(lines)


def write_segment_poplabels(path: str, chroms, maxpos, n_hap: int, n_segments: int,
                            seed: int, groups=("ANC1", "ANC2")) -> None:
    """Segment-format ancestry labels (the layout of tools/bench_aux.py):
    a header of group names, then per chromosome up to ``n_segments`` rows
    ``<chrom> <bp> <label per haplotype>`` at sorted random cuts below its
    ``maxpos``, the first at 0."""
    g = np.random.default_rng(seed)
    with open(path, "w") as fh:
        fh.write(" ".join(groups) + "\n")
        for c, mx in zip(chroms, maxpos):
            cuts = np.unique(np.concatenate([[0], g.integers(1, int(mx), n_segments - 1)]))
            labels = g.integers(0, len(groups), (cuts.size, n_hap))
            fh.writelines(f"{c} {bp} " + " ".join(map(str, row)) + "\n"
                          for bp, row in zip(cuts.tolist(), labels.tolist()))


# ---- BCF and BAM inputs of mode mut ----------------------------------------
# make_ref_genome and make_vcf_for_mut: the bytes of tests/helpers/synth_vcf.py;
# vcf_text_to_bcf2: of tests/helpers/synth_bcf.py; write_bam and make_bam: of
# tests/helpers/synth_bam.py; gen_bam: of tools/bench_bam_stream.py (seed 7).

_BASES = np.array(list("ACGT"))
_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_CODE = {c: i for i, c in enumerate(_NT16)}
_BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_VCF_META = (
    "##fileformat=VCFv4.2",
    "##contig=<ID={chrom}>",
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
)


def make_ref_genome(length: int, mut: MutTable, seed: int) -> str:
    """Random genome whose bases at mut sites are anc/der/other mix."""
    g = np.random.default_rng(seed)
    seq = g.choice(list("ACGT"), size=length)
    anc = mut.anc_allele
    der = mut.der_allele
    for i in range(len(mut)):
        p = int(mut.pos[i]) - 1
        if p >= length or len(anc[i]) != 1 or len(der[i]) != 1:
            continue
        r = g.random()
        if r < 0.45:
            seq[p] = anc[i]
        elif r < 0.9:
            seq[p] = der[i]
        # else leave a third base
    return "".join(seq)


def make_vcf_for_mut(
    path: str,
    chrom: str,
    mt: MutTable,
    ref_genome: str,
    seed: int,
    n_samples: int = 3,
    p_present: float = 0.75,
    present_head: int = 0,
):
    """Write a text VCF covering a subset of mut sites with varied cases:
    fixed-for-derived, flipped, mismatching, multi-allelic and missing
    genotypes.  ``present_head`` forces the first rows to be present (the
    reference's absent-site fallback reads an uninitialised N_ref before
    the first allele-matching record, coal.cpp:1648-1656)."""
    g = np.random.default_rng(seed)
    lines = [m.format(chrom=chrom) for m in _VCF_META] + [
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"S{i}" for i in range(n_samples)),
    ]
    anc = mt.anc_allele
    der = mt.der_allele
    for i in range(len(mt)):
        if g.random() > p_present and i >= present_head:
            continue
        a, d = anc[i], der[i]
        if len(a) != 1 or len(d) != 1:
            continue
        pos = int(mt.pos[i])
        r = g.random()
        if r < 0.08:
            ref_al, alt_al = d, ""  # fixed-for-derived candidate
            gts = ["0|0"] * n_samples
        elif r < 0.16:
            ref_al, alt_al = d, a  # flipped
            gts = [f"{g.integers(0,2)}|{g.integers(0,2)}" for _ in range(n_samples)]
        elif r < 0.22:
            bases = [b for b in "ACGT" if b not in (a, d)]
            ref_al, alt_al = bases[0], bases[1]  # mismatching alleles
            gts = ["0|1"] * n_samples
        elif r < 0.26:
            ref_al, alt_al = a, f"{d},{'G' if d != 'G' else 'T'}"  # multi-allelic
            gts = ["0|2"] + ["0|1"] * (n_samples - 1)
        elif r < 0.30:
            ref_al, alt_al = a, d  # missing genotype present
            gts = [".|."] + [f"{g.integers(0,2)}|{g.integers(0,2)}" for _ in range(n_samples - 1)]
        else:
            ref_al, alt_al = a, d
            gts = [f"{g.integers(0,2)}|{g.integers(0,2)}" for _ in range(n_samples)]
        alt_field = alt_al if alt_al else "."
        lines.append(
            f"{chrom}\t{pos}\t.\t{ref_al}\t{alt_field}\t.\tPASS\t.\tGT\t"
            + "\t".join(gts)
        )
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _bgzf_block(payload: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25  # header(18) + footer(8) = 26; BSIZE = total size - 1
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66, 67, 2, bsize,
    )
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + comp + footer


def _bgzf_compress(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 60000):
        out += _bgzf_block(data[i : i + 60000])
    out += _BGZF_EOF
    return bytes(out)


def _typed_str(s: bytes) -> bytes:
    n = len(s)
    if n < 15:
        return bytes([(n << 4) | 7]) + s
    return bytes([(15 << 4) | 7]) + _typed_int(n) + s


def _typed_int(v: int) -> bytes:
    if -128 <= v <= 127:
        return bytes([(1 << 4) | 1]) + struct.pack("<b", v)
    if -32768 <= v <= 32767:
        return bytes([(1 << 4) | 2]) + struct.pack("<h", v)
    return bytes([(1 << 4) | 3]) + struct.pack("<i", v)


def _typed_int_vec(vals: list[int]) -> bytes:
    n = len(vals)
    head = bytes([(n << 4) | 1]) if n < 15 else bytes([(15 << 4) | 1]) + _typed_int(n)
    return head + struct.pack(f"<{n}b", *vals)


def vcf_text_to_bcf2(text_path: str, bcf_path: str) -> None:
    """Encode a text VCF as BGZF-compressed BCF2 (GT only; dictionary ids
    in order of appearance with PASS id 0, as htslib numbers them)."""
    with open(text_path) as fh:
        lines = fh.read().splitlines()
    meta = [ln for ln in lines if ln.startswith("##")]
    chrom_line = next(ln for ln in lines if ln.startswith("#CHROM"))
    rows = [ln for ln in lines if ln and not ln.startswith("#")]
    n_samples = max(len(chrom_line.split("\t")) - 9, 0)

    contigs: list[str] = []
    for ln in meta:
        if ln.startswith("##contig=<"):
            body = ln[len("##contig=<") : ln.rindex(">")]
            fields = dict(kv.split("=", 1) for kv in body.split(",") if "=" in kv)
            contigs.append(fields["ID"])
    dict_ids = ["PASS"]
    for ln in meta:
        for tag in ("##INFO=<ID=", "##FILTER=<ID=", "##FORMAT=<ID="):
            if ln.startswith(tag):
                name = ln[len(tag) :].split(",")[0].split(">")[0]
                if name not in dict_ids:
                    dict_ids.append(name)
    gt_id = dict_ids.index("GT") if "GT" in dict_ids else 1

    header_text = "\n".join(meta + [chrom_line]) + "\n"
    htext = header_text.encode() + b"\x00"

    out = bytearray()
    out += b"BCF\x02\x02"
    out += struct.pack("<I", len(htext))
    out += htext

    for ln in rows:
        f = ln.split("\t")
        chrom_id = contigs.index(f[0])
        pos0 = int(f[1]) - 1
        ref = f[3]
        alts = [] if f[4] in (".", "") else f[4].split(",")
        alleles = [ref] + alts
        n_allele = len(alleles)
        rlen = len(ref)

        shared = bytearray()
        shared += struct.pack("<iii", chrom_id, pos0, rlen)
        shared += struct.pack("<I", 0x7F800001)  # QUAL: bcf missing float
        shared += struct.pack("<I", (n_allele << 16) | 0)  # n_info=0
        shared += struct.pack("<I", (1 << 24) | n_samples)  # n_fmt=1
        shared += _typed_str(b"")  # ID missing
        for a in alleles:
            shared += _typed_str(a.encode())
        shared += _typed_int_vec([0])  # FILTER: PASS

        gts: list[list[int]] = []
        fmt = f[8].split(":") if len(f) > 8 else []
        gt_i = fmt.index("GT") if "GT" in fmt else -1
        ploidy = 2
        for s in f[9 : 9 + n_samples]:
            val = s.split(":")[gt_i] if gt_i >= 0 else "."
            phased = "|" in val
            calls = val.replace("|", "/").split("/")
            row = []
            for ci, c in enumerate(calls):
                enc = 0 if c in (".", "") else (int(c) + 1) << 1
                if phased and ci > 0:
                    enc |= 1
                row.append(enc)
            ploidy = max(ploidy, len(row))
            gts.append(row)
        indiv = bytearray()
        indiv += _typed_int(gt_id)
        indiv += bytes([(min(ploidy, 14) << 4) | 1])  # int8 vector, ploidy per sample
        for row in gts:
            row = row + [0x81] * (ploidy - len(row))  # END_OF_VECTOR pad
            indiv += struct.pack(f"<{ploidy}b", *row)

        out += struct.pack("<II", len(shared), len(indiv))
        out += shared
        out += indiv

    with open(bcf_path, "wb") as fh:
        fh.write(_bgzf_compress(bytes(out)))


def write_bcf(path: str, chrom: str, pos: np.ndarray, ref: np.ndarray, alt: np.ndarray,
              gt: np.ndarray) -> None:
    """Vectorised BCF2 writer of one contig's diploid phased genotypes:
    ``ref`` and ``alt`` are uint8 allele characters (``alt`` 0 for a
    record without ALT), ``gt`` int8 [records, 2 x samples] allele indices
    (-1 missing).  Writes the bytes :func:`vcf_text_to_bcf2` writes for the
    same records in :func:`make_vcf_for_mut`'s header."""
    pos = np.asarray(pos, np.int64)
    n, width = gt.shape
    n_samples = width // 2
    head = "\n".join([m.format(chrom=chrom) for m in _VCF_META] + [
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"S{i}" for i in range(n_samples))]) + "\n"
    htext = head.encode() + b"\x00"
    n_allele = np.where(np.asarray(alt) != 0, 2, 1).astype(np.int64)
    l_shared = 24 + 1 + 2 * n_allele + 2
    l_indiv = 3 + width
    rec_len = 8 + l_shared + l_indiv
    start = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    buf = np.zeros(int(rec_len.sum()), np.uint8)
    enc = np.where(gt < 0, 0, (gt.astype(np.int16) + 1) << 1).astype(np.uint8)
    enc[:, 1::2] |= 1  # phased: every call after a sample's first
    for k in (1, 2):
        sel = np.nonzero(n_allele == k)[0]
        if not sel.size:
            continue
        ls = 24 + 1 + 2 * k + 2
        rec = np.zeros((sel.size, 8 + ls + l_indiv), np.uint8)
        i32 = lambda col, v: rec.__setitem__(
            (slice(None), slice(col, col + 4)), np.asarray(v, "<i4").reshape(-1, 1).view(np.uint8))
        i32(0, np.full(sel.size, ls))
        i32(4, np.full(sel.size, l_indiv))
        i32(8, np.zeros(sel.size))             # chrom id
        i32(12, pos[sel] - 1)
        i32(16, np.ones(sel.size))             # rlen
        rec[:, 20:24] = np.frombuffer(struct.pack("<I", 0x7F800001), np.uint8)
        rec[:, 24:28] = np.frombuffer(struct.pack("<I", k << 16), np.uint8)
        rec[:, 28:32] = np.frombuffer(struct.pack("<I", (1 << 24) | n_samples), np.uint8)
        o = 32
        rec[:, o] = 0x07                       # ID missing
        rec[:, o + 1] = 0x17
        rec[:, o + 2] = np.asarray(ref)[sel]
        if k == 2:
            rec[:, o + 3] = 0x17
            rec[:, o + 4] = np.asarray(alt)[sel]
        o += 1 + 2 * k
        rec[:, o:o + 2] = (0x11, 0x00)         # FILTER: PASS
        o += 2
        rec[:, o:o + 3] = (0x11, 0x01, 0x21)   # GT key 1, int8 x 2 a sample
        rec[:, o + 3:] = enc[sel]
        buf[start[sel, None] + np.arange(rec.shape[1])] = rec
    data = b"BCF\x02\x02" + struct.pack("<I", len(htext)) + htext + buf.tobytes()
    with open(path, "wb") as fh:
        fh.write(_bgzf_compress(data))


def bcf_genotypes(mt: MutTable, n_samples: int, seed: int):
    """Records of a BCF over the single-character rows of ``mt``: 90% of
    them, REF the ancestral and ALT the derived allele,
    each haplotype derived with the site's frequency (uniform in [0.02,
    0.98]).  Returns (pos, ref, alt, gt) for :func:`write_bcf`."""
    g = np.random.default_rng(seed)
    mtype = np.asarray(list(mt.mutation_type), object)
    ok = np.array([len(t) == 3 and t[1] == "/" and t[0] in "ACGT" and t[2] in "ACGT"
                   for t in mtype], bool)
    rows = np.nonzero(ok & (g.random(len(mt)) < 0.9))[0]
    codes = np.frombuffer("".join(mtype[rows]).encode(), np.uint8).reshape(-1, 3)
    freq = g.uniform(0.02, 0.98, rows.size)
    gt = (g.random((rows.size, 2 * n_samples)) < freq[:, None]).astype(np.int8)
    return mt.pos[rows].astype(np.int64), codes[:, 0].copy(), codes[:, 2].copy(), gt


def write_bam(path: str, contigs: dict[str, int], records) -> None:
    """records: iterable of (flag, ref_idx, pos0, mapq, seq, qual_array)
    or (..., aux_bytes) with BAM-format auxiliary data appended."""
    names = list(contigs)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{contigs[n]}\n" for n in names
    )
    payload = bytearray()
    payload += b"BAM\x01"
    payload += struct.pack("<i", len(text))
    payload += text.encode()
    payload += struct.pack("<i", len(names))
    for n in names:
        payload += struct.pack("<i", len(n) + 1)
        payload += n.encode() + b"\x00"
        payload += struct.pack("<i", contigs[n])
    for ri, rec in enumerate(records):
        (flag, ref_idx, pos0, mapq, seq, qual) = rec[:6]
        aux = rec[6] if len(rec) > 6 else b""
        name = f"r{ri}".encode() + b"\x00"
        l_seq = len(seq)
        n_cigar = 0 if (flag & 4) else 1
        cigar = b"" if (flag & 4) else struct.pack("<I", (l_seq << 4) | 0)
        packed = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(seq):
            code = _NT16_CODE.get(c.upper(), 15)
            if i % 2 == 0:
                packed[i // 2] = code << 4
            else:
                packed[i // 2] |= code
        body = (
            struct.pack(
                "<iiBBHHHiiii",
                ref_idx, pos0, len(name), mapq, 0, n_cigar, flag,
                l_seq, -1, -1, 0,
            )
            + name
            + cigar
            + bytes(packed)
            + bytes(np.asarray(qual, np.uint8).tobytes())
            + aux
        )
        payload += struct.pack("<i", len(body)) + body
    with open(path, "wb") as fh:
        fh.write(_bgzf_compress(bytes(payload)))


def make_bam(
    path: str,
    contigs: dict[str, str],
    seed: int,
    reads_per_contig: int = 1500,
    deam_rate: float = 0.04,
    mismatch_rate: float = 0.01,
):
    """Write a coordinate-sorted BAM over the given contig sequences.
    Reads vary in length (20-80), mapq (0-60), base quality (2-41),
    strand and mismatch load; positions start at >= 3."""
    g = np.random.default_rng(seed)
    records = []
    for ref_idx, (name, ref) in enumerate(contigs.items()):
        L = len(ref)
        poss = np.sort(g.integers(3, max(L - 10, 4), reads_per_contig))
        for pos in poss:
            rlen = int(g.integers(20, 81))
            seq = list(ref[pos : pos + rlen])
            while len(seq) < rlen:  # overhang past the genome end
                seq.append(str(_BASES[g.integers(0, 4)]))
            # mismatches: mostly sparse; ~5% of reads are mismatch-heavy
            rate = 0.25 if g.random() < 0.05 else mismatch_rate
            for i in range(rlen):
                r = g.random()
                if r < deam_rate:
                    if seq[i] == "C":
                        seq[i] = "T"
                    elif seq[i] == "G":
                        seq[i] = "A"
                elif r < deam_rate + rate:
                    seq[i] = str(_BASES[g.integers(0, 4)])
            if g.random() < 0.02:
                seq[int(g.integers(0, rlen))] = "N"
            qual = g.integers(2, 42, rlen)
            qual[g.random(rlen) < 0.15] = int(g.integers(2, 30))
            mapq = int(g.integers(0, 61)) if g.random() < 0.25 else int(g.integers(20, 61))
            flag = 16 if g.random() < 0.5 else 0
            records.append((flag, ref_idx, int(pos), mapq, "".join(seq), qual))
    write_bam(path, {n: len(s) for n, s in contigs.items()}, records)


RLEN = 60  # gen_bam's read length


def gen_bam(path: str, ref: np.ndarray, n_reads: int, contig: str, seed: int = 7) -> None:
    """Vectorised BAM writer: n_reads uniform 60 bp reads, exact slices of
    ``ref`` (uint8 bases) at sorted positions, all passing the filters;
    written in 1M-read chunks so memory stays bounded."""
    L = ref.shape[0]
    g = np.random.default_rng(seed)
    all_pos = np.sort(g.integers(3, L - RLEN - 3, n_reads)).astype(np.int32)

    name = b"r\x00"
    body_len = 32 + len(name) + 4 + (RLEN + 1) // 2 + RLEN
    rec_len = 4 + body_len

    code_map = np.zeros(256, np.uint8)
    for c, v in _NT16_CODE.items():
        code_map[ord(c)] = v

    def bgzf_write(fh, data: bytes) -> None:
        for i in range(0, len(data), 60000):
            fh.write(_bgzf_block(data[i : i + 60000], 1))

    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{L}\n"
    header = bytearray()
    header += b"BAM\x01"
    header += struct.pack("<i", len(text)) + text.encode()
    header += struct.pack("<i", 1)
    header += struct.pack("<i", len(contig) + 1) + contig.encode() + b"\x00"
    header += struct.pack("<i", L)

    with open(path, "wb") as fh:
        bgzf_write(fh, bytes(header))
        CH = 1_000_000
        for lo in range(0, n_reads, CH):
            pos = all_pos[lo : lo + CH]
            bgzf_write(fh, _records_chunk(pos, ref, code_map, name, body_len, rec_len).tobytes())
        fh.write(_BGZF_EOF)


def _records_chunk(pos, ref, code_map, name, body_len, rec_len) -> np.ndarray:
    n_reads = pos.shape[0]
    head = np.zeros((n_reads, 36), np.uint8)
    head[:, 0:4] = np.frombuffer(struct.pack("<i", body_len), np.uint8)
    # refID=0
    head[:, 8:12] = pos.view(np.uint8).reshape(n_reads, 4)
    head[:, 12] = len(name)  # l_read_name
    head[:, 13] = 60  # mapq
    head[:, 16] = 1  # n_cigar lo
    # flag=0 (bytes 18-19), l_seq at 20-23
    head[:, 20:24] = np.frombuffer(struct.pack("<i", RLEN), np.uint8)
    head[:, 24:28] = np.frombuffer(struct.pack("<i", -1), np.uint8)  # next_refID
    head[:, 28:32] = np.frombuffer(struct.pack("<i", -1), np.uint8)  # next_pos
    # tlen=0 at 32-35
    cigar = np.frombuffer(struct.pack("<I", (RLEN << 4) | 0), np.uint8)
    idx = pos[:, None].astype(np.int64) + np.arange(RLEN)[None, :]
    codes = code_map[ref[idx]]  # [n, 60]
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]  # [n, 30]
    rec = np.zeros((n_reads, rec_len), np.uint8)
    rec[:, :36] = head
    rec[:, 36 : 36 + len(name)] = np.frombuffer(name, np.uint8)
    o = 36 + len(name)
    rec[:, o : o + 4] = cigar
    rec[:, o + 4 : o + 4 + 30] = packed
    rec[:, o + 34 :] = 37  # qual
    return rec


def reference_individual(genome: np.ndarray, mt: MutTable, seed: int) -> np.ndarray:
    """A second individual's genome (uint8 bases): ``genome`` with the
    derived allele at half of the single-base ``.mut`` sites and the
    ancestral one at the rest, so reads of it and of ``genome`` differ at
    those sites (the target's base there is the ancestral, the derived or
    another one)."""
    g = np.random.default_rng(seed)
    out = genome.copy()
    codes = np.frombuffer("".join(t if len(t) == 3 else "N/N" for t in mt.mutation_type)
                          .encode(), np.uint8).reshape(-1, 3)
    at = mt.pos.astype(np.int64) - 1
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ok = (at >= 0) & (at < out.shape[0]) & np.isin(codes[:, 0], acgt) & np.isin(codes[:, 2], acgt)
    out[at[ok]] = np.where(g.random(int(ok.sum())) < 0.5, codes[ok, 2], codes[ok, 0])
    return out


def write_fixture_bcfs(fix: dict) -> dict:
    """BCF2 inputs over a :func:`make_fixture` fixture's ``.mut`` rows: per
    chromosome a target of one diploid sample and a reference of ten (the
    fixture's 2 and 20 haplotypes), from :func:`bcf_genotypes`.  Returns the
    two ``--target_bcf`` / ``--reference_bcf`` prefixes."""
    out = dict(target_bcf=os.path.join(fix["root"], "tbcf"),
               reference_bcf=os.path.join(fix["root"], "rbcf"))
    for i, (c, mt) in enumerate(zip(fix["chroms"], fix["mut_tables"])):
        for key, n_samples, seed in (("target_bcf", 1, 77 + i), ("reference_bcf", 10, 1077 + i)):
            write_bcf(f"{out[key]}_chr{c}.bcf", c, *bcf_genotypes(mt, n_samples, seed))
    return out


def make_bam_fixture(root: str, n_reads: int) -> dict:
    """tools/bench_bam_stream.py's workload: one contig of max(10M, 9 x
    n_reads) bases (seed 1), a ``.mut`` of 200k rows (make_mut seed 3), a
    target BAM of n_reads 60 bp reads (gen_bam seed 7), a reference BAM of
    as many reads of :func:`reference_individual`'s genome (seed 8), and a
    reference BCF2 of ten samples over the ``.mut``.
    Returns the paths and the ``--target_bam`` prefix that mode mut with
    ``--reference_bcf`` appends ``.bam`` to."""
    from colate_tpu_torch.formats.fasta import write_fasta

    os.makedirs(root, exist_ok=True)
    L = max(10_000_000, n_reads * 9)
    ref = np.random.default_rng(1).choice(np.frombuffer(b"ACGT", np.uint8), L)
    write_fasta(os.path.join(root, "rg_chr1.fa"), "1", ref.tobytes().decode())
    mt = make_mut(os.path.join(root, "mut_chr1.mut"), 200_000, seed=3, chrom_span=L - 10)
    fix = dict(root=root, chroms=["1"], length=L, n_reads=n_reads,
               mut_prefix=os.path.join(root, "mut"), ref_genome=os.path.join(root, "rg"),
               target_prefix=os.path.join(root, "target"),
               target_bam=os.path.join(root, "target.bam"),
               reference_bam=os.path.join(root, "refreads.bam"),
               reference_bcf=os.path.join(root, "rbcf"), chrfile=os.path.join(root, "chr.txt"))
    gen_bam(fix["target_bam"], ref, n_reads, "1", seed=7)
    gen_bam(fix["reference_bam"], reference_individual(ref, mt, seed=8), n_reads, "1", seed=8)
    write_bcf(fix["reference_bcf"] + "_chr1.bcf", "1", *bcf_genotypes(mt, 10, seed=9))
    with open(fix["chrfile"], "w") as fh:
        fh.write("1\n")
    return fix


def make_bcf_bam_fixture(root: str, n_rows: int = 800, reads_per_contig: int = 6000) -> dict:
    """Every input kind of mode mut at tests/test_mut_bam.py's scale: two
    contigs of 40,000 bases with ``n_rows`` dirty ``.mut`` rows each,
    reference genomes and masks, a reference VCF of 6 samples and a
    target VCF of 1 (text under a ``.bcf`` name, and their BCF2
    encodings), a target BAM of ``reads_per_contig`` reads a contig (plus
    a contig outside the chromosome list), a reference BAM of as many
    reads of :func:`reference_individual`'s genomes, and the target BAM
    split by contig for ``--per_chr_bam``.  ``inputs`` maps each
    input kind to its mode-mut flags."""
    from colate_tpu_torch.formats.bam import read_bam
    from colate_tpu_torch.formats.fasta import write_fasta

    os.makedirs(root, exist_ok=True)
    p = lambda name: os.path.join(root, name)
    g = np.random.default_rng(77)
    span = 40_000
    contigs = {}
    for i, c in enumerate(["1", "2"]):
        mt = make_mut(p(f"synth_chr{c}.mut"), n_rows, seed=61 + i, chrom_span=span, dirty=True)
        rg = make_ref_genome(span + 10, mt, seed=161 + i)
        contigs[c] = rg
        write_fasta(p(f"rg_chr{c}.fa"), c, rg)
        make_vcf_for_mut(p(f"rvcf_chr{c}.bcf"), c, mt, rg, seed=261 + i, n_samples=6,
                         p_present=0.8, present_head=20)
        make_vcf_for_mut(p(f"tvcf_chr{c}.bcf"), c, mt, rg, seed=361 + i, n_samples=1,
                         p_present=0.8, present_head=20)
        for name in ("rvcf", "tvcf"):
            vcf_text_to_bcf2(p(f"{name}_chr{c}.bcf"), p(f"{name[0]}bcf_chr{c}.bcf"))
        mask = "".join(np.where(g.random(span + 10) < 0.12, "N", "P"))
        write_fasta(p(f"mask_chr{c}.fa"), c, mask)
    contigs["9"] = "".join(g.choice(list("ACGT"), size=2000))
    make_bam(p("target.bam"), contigs, seed=171, reads_per_contig=reads_per_contig)
    other = {c: reference_individual(np.frombuffer(seq.encode(), np.uint8),
                                     MutTable.read(p(f"synth_chr{c}.mut")), seed=371 + i)
                .tobytes().decode() if c in ("1", "2") else seq
             for i, (c, seq) in enumerate(contigs.items())}
    make_bam(p("refreads.bam"), other, seed=271, reads_per_contig=reads_per_contig)
    rec = read_bam(p("target.bam"))
    for c in ("1", "2"):
        idx = np.nonzero(rec.contig == c)[0]
        write_bam(p(f"target_chr{c}.bam"), {c: len(contigs[c])},
                  [(int(rec.flag[i]), 0, int(rec.pos[i]), int(rec.mapq[i]), rec.seq[i],
                    rec.qual[i]) for i in idx])
    with open(p("chr.txt"), "w") as fh:
        fh.write("1\n2\n")
    genome = ["--ref_genome", p("rg")]
    return dict(
        root=root, chroms=["1", "2"], chrfile=p("chr.txt"), mut_prefix=p("synth"),
        rg_prefix=p("rg"), mask_prefix=p("mask"), target_bam=p("target.bam"),
        reference_bam=p("refreads.bam"), tbcf_prefix=p("tbcf"), rbcf_prefix=p("rbcf"),
        tvcf_prefix=p("tvcf"), rvcf_prefix=p("rvcf"),
        inputs={
            "bcf_bcf": ["--target_bcf", p("tbcf"), "--reference_bcf", p("rbcf"), *genome,
                        "--target_mask", p("mask")],
            "bcf_split": ["--target_bcf", p("rbcf"), *genome],
            "bam_bcf": ["--target_bam", p("target"), "--reference_bcf", p("rbcf"), *genome],
            "bam_bcf_per_chr": ["--target_bam", p("target"), "--reference_bcf", p("rbcf"),
                                *genome, "--per_chr_bam"],
            "bam_bam": ["--target_bam", p("target.bam"), "--reference_bam", p("refreads.bam"),
                        *genome, "--reference_mask", p("mask")],
        },
    )
