"""Relate anc/mut ↔ tree-sequence table conversion.

The reference carries a 1,868-line header (src/tree_sequence.hpp:29-1868)
converting between Relate's marginal-tree format and tskit ``.trees``
files (DumpAsTreeSequence / ConvertFromTreeSequence); it is compiled into
relate_lib but not called by any Colate/CoalRate mode.  This module is
the TPU-framework counterpart: the conversion itself is pure columnar
array shuffling (no tskit C library needed), emitting the standard
node/edge/site/mutation tables.  When the optional ``tskit`` Python
package is importable the tables can be materialised as a real
``tskit.TreeSequence``; otherwise they can be written in tskit's text
format (``tskit load_text`` compatible).

Like the reference conversion, marginal trees do not share internal
nodes: each tree contributes 2N-1 fresh internal node rows; sample nodes
0..N-1 are shared across trees.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from colate_tpu_torch.formats.anc import AncFile, node_ages
from colate_tpu_torch.formats.mut import MutTable


@dataclasses.dataclass
class TreeSequenceTables:
    """Columnar node/edge/site/mutation tables (tskit semantics)."""

    # nodes
    node_time: np.ndarray  # [num_nodes] float64
    node_is_sample: np.ndarray  # [num_nodes] bool
    # edges (sorted by left, then parent time — tskit requirement)
    edge_left: np.ndarray  # [num_edges] float64 (bp, 0-based half-open)
    edge_right: np.ndarray  # [num_edges] float64
    edge_parent: np.ndarray  # [num_edges] int64
    edge_child: np.ndarray  # [num_edges] int64
    # sites + mutations (one mutation per site, like Relate)
    site_pos: np.ndarray  # [num_sites] float64
    site_ancestral: np.ndarray  # [num_sites] object (str)
    mut_site: np.ndarray  # [num_sites] int64
    mut_node: np.ndarray  # [num_sites] int64
    mut_derived: np.ndarray  # [num_sites] object (str)
    sequence_length: float

    def to_tskit(self):
        """Materialise as a tskit.TreeSequence (requires tskit)."""
        import tskit

        tables = tskit.TableCollection(sequence_length=self.sequence_length)
        for i in range(self.node_time.shape[0]):
            tables.nodes.add_row(
                flags=tskit.NODE_IS_SAMPLE if self.node_is_sample[i] else 0,
                time=float(self.node_time[i]),
            )
        for i in range(self.edge_left.shape[0]):
            tables.edges.add_row(
                left=float(self.edge_left[i]),
                right=float(self.edge_right[i]),
                parent=int(self.edge_parent[i]),
                child=int(self.edge_child[i]),
            )
        for i in range(self.site_pos.shape[0]):
            s = tables.sites.add_row(
                position=float(self.site_pos[i]),
                ancestral_state=str(self.site_ancestral[i]),
            )
            tables.mutations.add_row(
                site=s, node=int(self.mut_node[i]),
                derived_state=str(self.mut_derived[i]),
            )
        tables.sort()
        return tables.tree_sequence()

    def write_text(self, prefix: str) -> None:
        """tskit ``load_text``-compatible node/edge/site/mutation files."""
        with open(prefix + ".nodes.txt", "w") as fh:
            fh.write("id\tis_sample\ttime\n")
            for i in range(self.node_time.shape[0]):
                fh.write(
                    f"{i}\t{int(self.node_is_sample[i])}\t{self.node_time[i]:.17g}\n"
                )
        with open(prefix + ".edges.txt", "w") as fh:
            fh.write("left\tright\tparent\tchild\n")
            for i in range(self.edge_left.shape[0]):
                fh.write(
                    f"{self.edge_left[i]:.17g}\t{self.edge_right[i]:.17g}\t"
                    f"{self.edge_parent[i]}\t{self.edge_child[i]}\n"
                )
        with open(prefix + ".sites.txt", "w") as fh:
            fh.write("position\tancestral_state\n")
            for i in range(self.site_pos.shape[0]):
                fh.write(f"{self.site_pos[i]:.17g}\t{self.site_ancestral[i]}\n")
        with open(prefix + ".mutations.txt", "w") as fh:
            fh.write("site\tnode\tderived_state\n")
            for i in range(self.mut_site.shape[0]):
                fh.write(
                    f"{self.mut_site[i]}\t{self.mut_node[i]}\t{self.mut_derived[i]}\n"
                )


def anc_to_tables(anc: AncFile, mut: MutTable) -> TreeSequenceTables:
    """DumpAsTreeSequence equivalent (tree_sequence.hpp:281-560 semantics):
    tree t spans bp [pos(start_snp_t), pos(start_snp_{t+1})); internal
    nodes are fresh per tree; mutations with exactly one mapped branch
    become (site, mutation) rows on that branch's per-tree node id."""
    T = anc.num_trees
    N = anc.n_hap
    M = 2 * N - 1
    ages = node_ages(anc).astype(np.float64)

    mut_pos = mut.pos.astype(np.float64)
    # genomic span of each tree: bp of its first SNP .. bp of next tree's
    left_bp = mut_pos[np.clip(anc.start_pos, 0, len(mut) - 1)]
    right_bp = np.append(left_bp[1:], mut_pos[-1] + 1.0)
    seq_len = float(mut_pos[-1] + 1.0)
    left_bp[0] = 0.0  # first tree starts at the origin (tree_sequence.hpp:418)

    # nodes: samples 0..N-1 then T blocks of M-N internal nodes
    n_internal = M - N
    node_time = np.concatenate(
        [
            (anc.sample_ages if anc.sample_ages is not None else np.zeros(N)),
            (ages[:, N:]).reshape(-1),
        ]
    ).astype(np.float64)
    node_is_sample = np.zeros(node_time.shape[0], bool)
    node_is_sample[:N] = True

    def gid(t: int, node: np.ndarray) -> np.ndarray:
        """global node id for per-tree node index."""
        node = np.asarray(node)
        return np.where(node < N, node, N + t * n_internal + (node - N))

    # edges: every non-root node contributes one edge per tree
    e_left, e_right, e_parent, e_child = [], [], [], []
    for t in range(T):
        par = anc.parent[t]
        child = np.nonzero(par >= 0)[0]
        e_left.append(np.full(child.shape[0], left_bp[t]))
        e_right.append(np.full(child.shape[0], right_bp[t]))
        e_parent.append(gid(t, par[child]))
        e_child.append(gid(t, child))
    edge_left = np.concatenate(e_left)
    edge_right = np.concatenate(e_right)
    edge_parent = np.concatenate(e_parent).astype(np.int64)
    edge_child = np.concatenate(e_child).astype(np.int64)

    # sites/mutations: rows with exactly one mapped branch
    rows = [i for i in range(len(mut)) if mut.num_branches[i] == 1]
    site_pos, site_anc, mut_node, mut_der = [], [], [], []
    for i in rows:
        t = int(mut.tree[i])
        if not (0 <= t < T):
            continue
        b = int(mut.branch[i][0])
        if not (0 <= b < M) or anc.parent[t][b] < 0:
            continue
        mt = mut.mutation_type[i]
        a, d = (mt.split("/", 1) + [""])[:2] if "/" in mt else (mt, "")
        site_pos.append(float(mut.pos[i]))
        site_anc.append(a)
        mut_node.append(int(gid(t, np.array([b]))[0]))
        mut_der.append(d)

    ns = len(site_pos)
    return TreeSequenceTables(
        node_time=node_time,
        node_is_sample=node_is_sample,
        edge_left=edge_left,
        edge_right=edge_right,
        edge_parent=edge_parent,
        edge_child=edge_child,
        site_pos=np.array(site_pos, np.float64),
        site_ancestral=np.array(site_anc, object),
        mut_site=np.arange(ns, dtype=np.int64),
        mut_node=np.array(mut_node, np.int64),
        mut_derived=np.array(mut_der, object),
        sequence_length=seq_len,
    )


def tables_to_anc(tables: TreeSequenceTables, n_hap: int) -> AncFile:
    """ConvertFromTreeSequence equivalent (tree_sequence.hpp:563-900
    semantics, restricted to Relate-shaped inputs: binary trees, no
    shared internal nodes): rebuild per-tree parent/branch arrays from
    the edge intervals."""
    # breakpoints = unique edge lefts
    lefts = np.unique(tables.edge_left)
    T = lefts.shape[0]
    M = 2 * n_hap - 1
    parent = np.full((T, M), -1, np.int32)
    blen = np.zeros((T, M), np.float64)
    start_pos = np.zeros(T, np.int64)
    site_pos = tables.site_pos
    for t, lo in enumerate(lefts):
        sel = np.nonzero(
            (tables.edge_left <= lo)
            & (tables.edge_right > lo)
        )[0]
        # map global ids back to per-tree: samples keep ids, internal
        # ids are densified by time order
        gids = np.unique(
            np.concatenate([tables.edge_parent[sel], tables.edge_child[sel]])
        )
        internal = gids[gids >= n_hap]
        order = internal[np.argsort(tables.node_time[internal], kind="stable")]
        lid = {int(g): n_hap + k for k, g in enumerate(order)}
        for g in range(n_hap):
            lid[g] = g
        for e in sel:
            c = lid[int(tables.edge_child[e])]
            p = lid[int(tables.edge_parent[e])]
            parent[t, c] = p
            blen[t, c] = (
                tables.node_time[tables.edge_parent[e]]
                - tables.node_time[tables.edge_child[e]]
            )
        start_pos[t] = np.searchsorted(site_pos, lo, side="left") if site_pos.size else 0
    return AncFile(
        n_hap=n_hap,
        sample_ages=(
            tables.node_time[:n_hap].copy()
            if np.any(tables.node_time[:n_hap] != 0)
            else None
        ),
        start_pos=start_pos,
        parent=parent,
        branch_length=blen,
        num_events=np.zeros((T, M), np.float32),
        snp_begin=np.zeros((T, M), np.int32),
        snp_end=np.zeros((T, M), np.int32),
    )


# ---------------------------------------------------------------------------
# Binary ``.trees`` (kastore) interchange — from scratch.
#
# The reference stores tree sequences through the vendored tskit C
# library (file format 12 over kastore v1; src/tskit/kastore.c,
# tables.c).  This is an independent implementation of both layers'
# on-disk formats: kastore = 64-byte header (magic, version, item
# count, file size) + 64-byte item descriptors (type @0, key
# start/len @8/@16, array start/len @24/@32) + keys (sorted) + 8-byte
# aligned little-endian arrays.
# ---------------------------------------------------------------------------

_KAS_MAGIC = b"\x89KAS\r\n\x1a\n"
_KAS_DTYPES = {
    0: np.dtype("i1"), 1: np.dtype("u1"), 2: np.dtype("<i2"),
    3: np.dtype("<u2"), 4: np.dtype("<i4"), 5: np.dtype("<u4"),
    6: np.dtype("<i8"), 7: np.dtype("<u8"), 8: np.dtype("<f4"),
    9: np.dtype("<f8"),
}
_KAS_CODES = {v: k for k, v in _KAS_DTYPES.items()}


def kastore_read(path: str) -> dict[str, np.ndarray]:
    """Read a kastore v1 container into {key: array}."""
    import struct

    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _KAS_MAGIC:
        raise ValueError(f"{path}: not a kastore file")
    vmaj, vmin = struct.unpack_from("<HH", data, 8)
    if vmaj != 1:
        raise ValueError(f"{path}: unsupported kastore major version {vmaj}")
    (nitems,) = struct.unpack_from("<I", data, 12)
    out = {}
    off = 64
    for _ in range(nitems):
        (ty,) = struct.unpack_from("<B", data, off)
        ks, kl, ast, al = struct.unpack_from("<QQQQ", data, off + 8)
        key = data[ks : ks + kl].decode()
        dt = _KAS_DTYPES[ty]
        out[key] = np.frombuffer(data, dtype=dt, count=al, offset=ast).copy()
        off += 64
    return out


def kastore_write(path: str, items: dict[str, np.ndarray]) -> None:
    """Write a kastore v1 container (keys sorted, arrays 8-aligned)."""
    import struct

    keys = sorted(items)
    arrs = []
    for k in keys:
        a = np.ascontiguousarray(items[k])
        if a.dtype == np.dtype("S1") or a.dtype.kind == "S":
            a = np.frombuffer(a.tobytes(), np.int8)
        if a.dtype not in _KAS_CODES:
            a = a.astype(np.dtype(a.dtype.str.replace(">", "<")))
        arrs.append(a)
    n = len(keys)
    off = 64 + 64 * n
    key_starts = []
    for k in keys:
        key_starts.append(off)
        off += len(k.encode())
    arr_starts = []
    for a in arrs:
        if off % 8:
            off += 8 - off % 8
        arr_starts.append(off)
        off += a.nbytes
    file_size = off
    buf = bytearray(file_size)
    buf[:8] = _KAS_MAGIC
    struct.pack_into("<HH", buf, 8, 1, 1)
    struct.pack_into("<I", buf, 12, n)
    struct.pack_into("<Q", buf, 16, file_size)
    for i, (k, a) in enumerate(zip(keys, arrs)):
        d = 64 + 64 * i
        struct.pack_into("<B", buf, d, _KAS_CODES[a.dtype])
        struct.pack_into(
            "<QQQQ", buf, d + 8, key_starts[i], len(k.encode()),
            arr_starts[i], a.shape[0],
        )
        kb = k.encode()
        buf[key_starts[i] : key_starts[i] + len(kb)] = kb
        buf[arr_starts[i] : arr_starts[i] + a.nbytes] = a.tobytes()
    with open(path, "wb") as fh:
        fh.write(bytes(buf))


def _ragged(strings) -> tuple[np.ndarray, np.ndarray]:
    """(blob int8, offsets uint32) for a tskit ragged char column."""
    blob = "".join(str(s) for s in strings).encode()
    off = np.zeros(len(strings) + 1, np.uint32)
    np.cumsum([len(str(s).encode()) for s in strings], out=off[1:])
    return (
        np.frombuffer(blob, np.uint8).copy() if blob else np.zeros(0, np.uint8),
        off,
    )


def _build_indexes(tables: TreeSequenceTables):
    """tskit edge indexes (tsk_table_collection_build_index semantics):
    insertion order sorts by (left, parent time, parent, child);
    removal order by (right, -parent time, -parent, -child)."""
    pt = tables.node_time[tables.edge_parent]
    ins = np.lexsort(
        (tables.edge_child, tables.edge_parent, pt, tables.edge_left)
    ).astype(np.int32)
    rem = np.lexsort(
        (-tables.edge_child, -tables.edge_parent, -pt, tables.edge_right)
    ).astype(np.int32)
    return ins, rem


def write_trees_file(tables: TreeSequenceTables, path: str) -> None:
    """Write a binary tskit ``.trees`` (file format 12) the reference's
    vendored tskit loads (ConvertFromTreeSequence round-trip tested);
    edges are stored in insertion-sorted order as tskit requires."""
    # tskit requires edges sorted by (time[parent], parent, child, left)
    pt = tables.node_time[tables.edge_parent]
    order = np.lexsort(
        (tables.edge_left, tables.edge_child, tables.edge_parent, pt)
    )
    t = TreeSequenceTables(
        node_time=tables.node_time,
        node_is_sample=tables.node_is_sample,
        edge_left=tables.edge_left[order],
        edge_right=tables.edge_right[order],
        edge_parent=tables.edge_parent[order],
        edge_child=tables.edge_child[order],
        site_pos=tables.site_pos,
        site_ancestral=tables.site_ancestral,
        mut_site=tables.mut_site,
        mut_node=tables.mut_node,
        mut_derived=tables.mut_derived,
        sequence_length=tables.sequence_length,
    )
    nn = t.node_time.shape[0]
    ns = t.site_pos.shape[0]
    sa_blob, sa_off = _ragged(t.site_ancestral)
    md_blob, md_off = _ragged(t.mut_derived)
    ins, rem = _build_indexes(t)
    z1u = np.zeros(1, np.uint32)
    items = {
        "format/name": np.frombuffer(b"tskit.trees", np.int8).copy(),
        "format/version": np.array([12, 0], np.uint32),
        "sequence_length": np.array([t.sequence_length], np.float64),
        "uuid": np.frombuffer(b"0" * 36, np.int8).copy(),
        "nodes/time": t.node_time.astype(np.float64),
        "nodes/flags": np.where(t.node_is_sample, 1, 0).astype(np.uint32),
        "nodes/population": np.full(nn, -1, np.int32),
        "nodes/individual": np.full(nn, -1, np.int32),
        "nodes/metadata": np.zeros(0, np.uint8),
        "nodes/metadata_offset": np.zeros(nn + 1, np.uint32),
        "edges/left": t.edge_left.astype(np.float64),
        "edges/right": t.edge_right.astype(np.float64),
        "edges/parent": t.edge_parent.astype(np.int32),
        "edges/child": t.edge_child.astype(np.int32),
        "sites/position": t.site_pos.astype(np.float64),
        "sites/ancestral_state": sa_blob,
        "sites/ancestral_state_offset": sa_off,
        "sites/metadata": np.zeros(0, np.uint8),
        "sites/metadata_offset": np.zeros(ns + 1, np.uint32),
        "mutations/site": t.mut_site.astype(np.int32),
        "mutations/node": t.mut_node.astype(np.int32),
        "mutations/parent": np.full(ns, -1, np.int32),
        "mutations/derived_state": md_blob,
        "mutations/derived_state_offset": md_off,
        "mutations/metadata": np.zeros(0, np.uint8),
        "mutations/metadata_offset": np.zeros(ns + 1, np.uint32),
        "individuals/flags": np.zeros(0, np.uint32),
        "individuals/location": np.zeros(0, np.float64),
        "individuals/location_offset": z1u,
        "individuals/metadata": np.zeros(0, np.uint8),
        "individuals/metadata_offset": z1u,
        "populations/metadata": np.zeros(0, np.uint8),
        "populations/metadata_offset": z1u,
        "migrations/left": np.zeros(0, np.float64),
        "migrations/right": np.zeros(0, np.float64),
        "migrations/node": np.zeros(0, np.int32),
        "migrations/source": np.zeros(0, np.int32),
        "migrations/dest": np.zeros(0, np.int32),
        "migrations/time": np.zeros(0, np.float64),
        "provenances/record": np.zeros(0, np.uint8),
        "provenances/record_offset": z1u,
        "provenances/timestamp": np.zeros(0, np.uint8),
        "provenances/timestamp_offset": z1u,
        "indexes/edge_insertion_order": ins,
        "indexes/edge_removal_order": rem,
    }
    kastore_write(path, items)


def read_trees_file(path: str) -> TreeSequenceTables:
    """Read a binary tskit ``.trees`` into columnar tables."""
    ks = kastore_read(path)
    name = bytes(ks["format/name"].view(np.uint8)).decode()
    if name != "tskit.trees":
        raise ValueError(f"{path}: not a tskit.trees file ({name!r})")

    def ragged(blob, off):
        b = bytes(blob.view(np.uint8))
        o = off.astype(np.int64)
        return np.array(
            [b[o[i] : o[i + 1]].decode() for i in range(o.shape[0] - 1)],
            object,
        )

    return TreeSequenceTables(
        node_time=ks["nodes/time"].astype(np.float64),
        node_is_sample=(ks["nodes/flags"] & 1) != 0,
        edge_left=ks["edges/left"].astype(np.float64),
        edge_right=ks["edges/right"].astype(np.float64),
        edge_parent=ks["edges/parent"].astype(np.int64),
        edge_child=ks["edges/child"].astype(np.int64),
        site_pos=ks["sites/position"].astype(np.float64),
        site_ancestral=ragged(
            ks["sites/ancestral_state"], ks["sites/ancestral_state_offset"]
        ),
        mut_site=ks["mutations/site"].astype(np.int64),
        mut_node=ks["mutations/node"].astype(np.int64),
        mut_derived=ragged(
            ks["mutations/derived_state"], ks["mutations/derived_state_offset"]
        ),
        sequence_length=float(ks["sequence_length"][0]),
    )
