"""Columnar reader/writer for Relate ``.anc`` marginal-tree files.

Format (reference src/mutations.cpp:342-397, src/anc.cpp:6-47, 494-546)::

    NUM_HAPLOTYPES <N> [sample_age x N]
    NUM_TREES <M>
    <start_snp>: <parent>:(<branch_length> <num_events> <SNP_begin> <SNP_end>) ... x (2N-1)

Each tree line holds 2N-1 node records in node-index order (leaves
0..N-1, internal N..2N-2); ``parent`` is -1 for the root.  All trees of
a file share N, so the whole file loads into dense [num_trees, 2N-1]
arrays, the layout of the batched populate and local-ancestry programs.

Copied from colate_tpu/formats/anc.py (``AncFile.read``/``write``,
``node_ages`` and the Newick, ARGweaver SMC and RENT+ importers) with the
native reader only: a failed native read raises, naming the path; there
is no Python parser to fall back to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gzip
import os
import re

import numpy as np


@dataclasses.dataclass
class AncFile:
    n_hap: int  # N (number of haplotypes/tips)
    sample_ages: np.ndarray | None  # [N] float64 or None
    start_pos: np.ndarray  # [T] int64: SNP index at which each tree starts
    parent: np.ndarray  # [T, 2N-1] int32 (-1 for root)
    branch_length: np.ndarray  # [T, 2N-1] float64
    num_events: np.ndarray  # [T, 2N-1] float32
    snp_begin: np.ndarray  # [T, 2N-1] int32
    snp_end: np.ndarray  # [T, 2N-1] int32

    @property
    def num_trees(self) -> int:
        return int(self.start_pos.shape[0])

    @classmethod
    def read(cls, path: str, columns: str = "all") -> "AncFile":
        """Columnar decode with the native library (io.cpp:cn_anc_read).

        ``columns="tree"`` decodes only parent + branch_length (what the
        tree and local-ancestry estimators consume), roughly half the
        parse work on genome-scale files; num_events/snp_begin/snp_end
        are then zero-filled placeholders.  Raises if the library cannot
        be built or loaded, or if the file does not parse."""
        from colate_tpu_torch import native

        lib = native.load()
        err = ctypes.create_string_buffer(512)
        minimal = 1 if columns == "tree" else 0
        h = lib.cn_anc_read(path.encode(), err, 512, minimal)
        if not h:
            raise ValueError(err.value.decode() or f"native .anc parse failed: {path}")
        try:
            col = lambda c, dt: native.col_array(lib, lib.cn_anc_col, h, c, dt)
            T = int(lib.cn_anc_n(h))
            n_hap = int(lib.cn_anc_nhap(h))
            M = 2 * n_hap - 1
            ages = col(6, np.float64)
            if minimal:
                z32 = np.zeros((T, M), np.float32)
                return cls(
                    n_hap=n_hap,
                    sample_ages=ages if ages.size else None,
                    start_pos=col(0, np.int64),
                    parent=col(1, np.int32).reshape(T, M),
                    branch_length=col(2, np.float64).reshape(T, M),
                    num_events=z32,
                    snp_begin=z32.view(np.int32),
                    snp_end=z32.view(np.int32),
                )
            return cls(
                n_hap=n_hap,
                sample_ages=ages if ages.size else None,
                start_pos=col(0, np.int64),
                parent=col(1, np.int32).reshape(T, M),
                branch_length=col(2, np.float64).reshape(T, M),
                num_events=col(3, np.float32).reshape(T, M),
                snp_begin=col(4, np.int32).reshape(T, M),
                snp_end=col(5, np.int32).reshape(T, M),
            )
        finally:
            lib.cn_anc_free(h)

    def write(self, path: str) -> None:
        """Dump in the reference layout (anc.cpp:523-540 record format)."""
        with open(path, "w") as fh:
            fh.write(f"NUM_HAPLOTYPES {self.n_hap}")
            if self.sample_ages is not None:
                for a in self.sample_ages:
                    fh.write(f" {a:g}")
            fh.write("\n")
            fh.write(f"NUM_TREES {self.num_trees}\n")
            for t in range(self.num_trees):
                parts = [f"{self.start_pos[t]}:"]
                for j in range(self.parent.shape[1]):
                    parts.append(
                        f"{self.parent[t, j]}:({self.branch_length[t, j]:.5f} "
                        f"{self.num_events[t, j]:.3f} {self.snp_begin[t, j]} "
                        f"{self.snp_end[t, j]})"
                    )
                fh.write(" ".join(parts) + " \n")


_CHERRY = re.compile(
    r"\(([^(),:]+):([^(),]+),([^(),:]+):([^(),]+)\)"
)


def _reduce_newick(newick: str, edges: dict, label_of, next_internal: int | None):
    """Cherry-reduction of a binary newick string (the reference's
    importer strategy, anc.cpp:798-864/1130-1198): repeatedly replace the
    leftmost innermost ``(c1:b1,c2:b2)`` pair.

    With ``next_internal`` given (RENT/plain newick), each reduction is
    assigned the next internal id and the pair is replaced by its label;
    otherwise (ARGweaver SMC) the parent's explicit label follows the
    closing bracket and the pair is simply deleted.  Returns the number
    of internal nodes created / consumed.
    """
    made = 0
    while True:
        m = _CHERRY.search(newick)
        if m is None:
            break
        c1, b1, c2, b2 = m.group(1), m.group(2), m.group(3), m.group(4)
        if next_internal is None:
            # parent label written after ')' like "(...)P:bl" or "(...)P"
            rest = newick[m.end():]
            lm = re.match(r"([^(),:\[]+)", rest)
            if lm is None:
                raise ValueError(f"no parent label after cherry: {rest[:40]}")
            parent_label = lm.group(1)
            replacement = ""
        else:
            parent_label = str(next_internal + made)
            replacement = parent_label
        p = label_of(parent_label)
        edges[label_of(c1)] = (p, float(np.float32(float(b1))))
        edges[label_of(c2)] = (p, float(np.float32(float(b2))))
        made += 1
        newick = newick[: m.start()] + replacement + newick[m.end():]
    return made


def _edges_to_ancfile(per_tree: list[tuple[int, dict]], n_hap: int) -> AncFile:
    """Assemble (pos, {child: (parent, blen)}) per tree into an AncFile,
    relabelling so the root is node 2N-2 (the reference's root fix,
    anc.cpp:869-930)."""
    n_nodes = 2 * n_hap - 1
    T = len(per_tree)
    start_pos = np.empty(T, np.int64)
    parent = np.full((T, n_nodes), -1, np.int32)
    blen = np.zeros((T, n_nodes), np.float64)
    for t, (pos, edges) in enumerate(per_tree):
        start_pos[t] = pos
        par = np.full(n_nodes, -1, np.int64)
        bl = np.zeros(n_nodes)
        for c, (p, b) in edges.items():
            par[c] = p
            bl[c] = b
        root = int(np.nonzero(par < 0)[0][0])
        if root != n_nodes - 1:
            perm = np.arange(n_nodes)
            perm[root], perm[n_nodes - 1] = n_nodes - 1, root
            new_par = np.full(n_nodes, -1, np.int64)
            new_bl = np.zeros(n_nodes)
            for j in range(n_nodes):
                if par[j] >= 0:
                    new_par[perm[j]] = perm[par[j]]
                    new_bl[perm[j]] = bl[j]
            par, bl = new_par, new_bl
        parent[t] = par
        blen[t] = bl
    return AncFile(
        n_hap=n_hap,
        sample_ages=None,
        start_pos=start_pos,
        parent=parent,
        branch_length=blen,
        num_events=np.zeros((T, n_nodes), np.float32),
        snp_begin=np.zeros((T, n_nodes), np.int32),
        snp_end=np.zeros((T, n_nodes), np.int32),
    )


def _open_text(path: str):
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path = path + ".gz"
    try:
        fh = gzip.open(path, "rt")
        fh.read(1)
        fh.seek(0)
        return fh
    except (OSError, gzip.BadGzipFile):
        return open(path, "rt")


def read_argweaver_smc(path: str) -> AncFile:
    """ARGweaver ``.smc`` importer (AncesTree::ReadArgweaverSMC,
    anc.cpp:751-950): a NAMES header maps newick leaf ids to haplotype
    indices; every other line is ``TREE <pos> <end> <newick>`` with
    NHX annotations and explicit internal-node labels."""
    per_tree: list[tuple[int, dict]] = []
    with _open_text(path) as fh:
        header = fh.readline().split()
        ids = [int(x) for x in header[1:]]
        n_hap = len(ids)

        # newick node ids are 0-based: leaves map through the NAMES list
        # (convert_index[i] = NAMES[i]-1, anc.cpp:766-777), internal ids
        # keep their own index
        def label_of(s: str) -> int:
            v = int(s)
            return ids[v] - 1 if v < n_hap else v

        lines = fh.readlines()
    tree_lines = [ln for ln in lines if ln.startswith("TREE")]
    for ln in tree_lines:
        f = ln.split(None, 3)
        pos = int(f[1])
        newick = re.sub(r"\[[^\]]*\]", "", f[3].strip())
        edges: dict = {}
        _reduce_newick(newick.rstrip(";"), edges, label_of, None)
        per_tree.append((pos, edges))
    return _edges_to_ancfile(per_tree, n_hap)


def read_rent(path: str, ne: float) -> AncFile:
    """RENT+ importer (AncesTree::ReadRent, anc.cpp:952-1090): lines of
    ``<pos> <newick>`` with 1-based leaf labels and coalescent-unit
    branch lengths scaled by Ne; malformed trees are dropped."""
    return _read_pos_newick(path, ne, one_based=True)


def read_newick_trees(path: str, ne: float) -> AncFile:
    """Plain newick importer (AncesTree::ReadNewick, anc.cpp:1092-1229):
    lines of ``<pos> <newick>`` with 0-based leaf labels."""
    return _read_pos_newick(path, ne, one_based=False)


def _read_pos_newick(path: str, ne: float, one_based: bool) -> AncFile:
    per_tree: list[tuple[int, dict]] = []
    n_hap = None
    with _open_text(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            if n_hap is None:
                n_hap = ln.count(",") + 1
            pos_s, newick = ln.split(None, 1)
            newick = newick.rstrip(";")
            off = 1 if one_based else 0

            def label_of(s: str, off=off) -> int:
                return int(s) - off

            edges: dict = {}
            try:
                made = _reduce_newick(
                    newick, edges, label_of, n_hap + (1 if one_based else 0)
                )
            except (ValueError, KeyError):
                continue
            if made != n_hap - 1 or len(edges) != 2 * n_hap - 2:
                continue  # non-binary / malformed: dropped like the reference
            if ne != 1.0:
                edges = {
                    c: (p, float(np.float32(b * ne))) for c, (p, b) in edges.items()
                }
            per_tree.append((int(pos_s), edges))
    if n_hap is None:
        raise ValueError(f"empty tree file: {path}")
    return _edges_to_ancfile(per_tree, n_hap)


def node_ages(anc: AncFile) -> np.ndarray:
    """[T, 2N-1] float32 node ages (coordinates).

    Matches Tree::GetCoordinates (anc.cpp:280-334): age(node) = max over
    children of (age(child) + branch_length(child)), leaves at 0 or their
    sample age; each node's value is rounded to float32 like the
    reference's ``std::vector<float> coordinates``.

    The native threaded pass (io.cpp:cn_tree_coords) takes Relate's
    numbering (parents after children); it returns 0 for any other
    numbering, and the numpy passes below take those trees: one ascending
    pass when every parent has a larger index than its child, else a
    post-order walk per tree.
    """
    from colate_tpu_torch import native

    T, M = anc.parent.shape
    N = anc.n_hap
    lib = native.load()
    par = np.ascontiguousarray(anc.parent, np.int32)
    bl = np.ascontiguousarray(anc.branch_length, np.float64)
    ages = (
        np.ascontiguousarray(anc.sample_ages, np.float64)
        if anc.sample_ages is not None and anc.sample_ages.size
        else None
    )
    out = np.empty((T, M), np.float32)
    p = lambda a: ctypes.c_void_p(0 if a is None else a.ctypes.data)
    if lib.cn_tree_coords(T, M, N, p(par), p(bl), p(ages), p(out)):
        return out

    coords = np.zeros((T, M), np.float32)
    if anc.sample_ages is not None and anc.sample_ages.size:
        coords[:, :N] = anc.sample_ages[None, :].astype(np.float32)

    ordered = bool(
        np.all((anc.parent > np.arange(M)[None, :]) | (anc.parent < 0))
    )
    if ordered:
        # Relate numbers parents after children: one ascending pass,
        # vectorised across trees; each node f32-rounds once like the
        # reference's float coordinates array.
        acc = np.full((T, M), -np.inf)
        rows = np.arange(T)
        for j in range(M):
            if j >= N:
                coords[:, j] = acc[:, j].astype(np.float32)
            p = anc.parent[:, j]
            valid = p >= 0
            vals = coords[:, j].astype(np.float64) + anc.branch_length[:, j]
            # each tree contributes exactly one (row, parent) entry per
            # column j, so plain fancy indexing (no duplicate targets)
            # replaces the much slower np.maximum.at scatter
            rv, pv = rows[valid], p[valid]
            acc[rv, pv] = np.maximum(acc[rv, pv], vals[valid])
        return coords

    # arbitrary node numbering: per-tree post-order
    for t in range(T):
        par = anc.parent[t]
        kids: dict[int, list[int]] = {}
        for j in range(M):
            if par[j] >= 0:
                kids.setdefault(int(par[j]), []).append(j)
        root = int(np.nonzero(par < 0)[0][0])
        post: list[int] = []
        dfs = [root]
        while dfs:
            u = dfs.pop()
            post.append(u)
            dfs.extend(kids.get(u, []))
        for u in reversed(post):
            cs = kids.get(u, [])
            if cs:
                coords[t, u] = np.float32(
                    max(float(coords[t, c]) + anc.branch_length[t, c] for c in cs)
                )
    return coords
