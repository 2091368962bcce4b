"""The inputs of a run, made from its seed: one general generator, driven by
the configuration's ``inputs`` key.

- ``colate_in``: a Relate ``.mut`` per chromosome, with rows in proportion
  to its length (``mut_rows_per_bp``), and two ``.colate.in`` streams (a
  target and a reference sample) covering random subsets of its rows,
  shaped as the program's own test fixture shapes them (sorted unique
  positions, log-uniform ages, a share of rows that the join drops, allele
  mismatches in the streams), written vectorised.  Ages are whole
  generations, so the file's six significant digits hold them exactly.
- ``colate_mat``: a panel of pairs, each with the ``<out>.colate_mat`` that
  a first pass over BCF or BAM inputs leaves: a synthetic site set over
  the genome's blocks (bench.py's binning input), per pair its own site
  weights, binned by the reference's analytic binning, block-bootstrapped
  and written normalised, all made on the device from the seed.

Both return what the reference needs besides the files, which are written
under ``root``.  The files are not synced: a run's set-up waits for the
page cache, not for the host's disk.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.reference import binning, bootstrap
from benchmark.reference.join import MutRows, Stream

BASES = np.frombuffer(b"ACGT", np.uint8)
MUT_HEADER = (b"snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;is_not_mapping;"
              b"is_flipped;age_begin;age_end;ancestral_allele/alternative_allele;"
              b"upstream_allele;downstream_allele;\n")
COLATE_MAT_NORM = 1e3


# ---------------------------------------------------------------- text, vectorised

def digits(v: np.ndarray) -> np.ndarray:
    """Decimal digits of non-negative integers as a uint8 matrix [n, w],
    right-aligned, 0 where a leading zero would be."""
    v = np.asarray(v, np.int64)
    w = max(len(str(int(v.max()))) if v.size else 1, 1)
    x = v.astype(np.int32) if w < 10 else v.copy()
    out = np.empty((v.shape[0], w), np.uint8)
    for j in range(w - 1, -1, -1):
        q = x // 10
        out[:, j] = x - q * 10
        x = q
    out += 48
    width = np.ones(v.shape[0], np.int64)
    for j in range(1, w):
        width += v >= 10 ** j
    out[np.arange(w)[None, :] < (w - width)[:, None]] = 0
    return out


def literal(n: int, text: bytes) -> np.ndarray:
    return np.broadcast_to(np.frombuffer(text, np.uint8), (n, len(text)))


def rows_bytes(columns: list) -> bytes:
    """The bytes of rows whose pieces are the uint8 matrices ``columns``,
    zeros left out."""
    m = np.concatenate(columns, axis=1)
    return m[m != 0].tobytes()


def sci6(x: np.ndarray) -> np.ndarray:
    """Non-negative floats to six significant digits (``d.ddddde+XX``, ``0``
    for zero) as a uint8 matrix [n, 12], zero-padded."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    pos = x > 0
    e = np.floor(np.log10(np.where(pos, x, 1.0))).astype(np.int64)
    m = np.rint(np.where(pos, x, 0.0) / 10.0 ** e * 1e5).astype(np.int64)
    hi, lo = m >= 1_000_000, pos & (m < 100_000)
    m = np.where(hi, np.rint(m / 10.0).astype(np.int64), np.where(lo, m * 10, m))
    e = e + hi - lo
    out = np.zeros((n, 13), np.uint8)
    d = (m[:, None] // 10 ** np.arange(5, -1, -1)) % 10 + 48
    out[:, 0] = d[:, 0]
    out[:, 1] = ord(".")
    out[:, 2:7] = d[:, 1:]
    out[:, 7] = ord("e")
    out[:, 8] = np.where(e < 0, ord("-"), ord("+"))
    ae = np.abs(e)
    out[:, 9] = np.where(ae >= 100, ae // 100 + 48, 0)
    out[:, 10] = (ae // 10) % 10 + 48
    out[:, 11] = ae % 10 + 48
    out[~pos] = 0
    out[~pos, 0] = ord("0")
    return out


def write_colate_mat(path: str, centers, shared, notshared) -> None:
    """``.colate_mat``: the bin ages, then per replicate its shared and its
    notshared row, space-separated, each row ending in a space."""
    B, N = shared.shape
    rows = np.empty((1 + 2 * B, N), np.float64)
    rows[0] = centers
    rows[1::2] = shared
    rows[2::2] = notshared
    cells = sci6(rows.ravel()).reshape(rows.shape[0], N, 13)
    cells[:, :, 12] = ord(" ")
    flat = cells.reshape(rows.shape[0], N * 13)
    text = rows_bytes([flat, literal(rows.shape[0], b"\n")])
    with open(path, "wb") as fh:
        fh.write(text)


# ---------------------------------------------------------------- a modern pair

@dataclasses.dataclass
class PairInputs:
    mut_prefix: str
    target: str
    reference: str
    chr_file: str
    chroms: list
    muts: list            # MutRows a chromosome
    target_stream: Stream
    reference_stream: Stream
    bytes_written: int


def _sorted_unique_positions(g, n: int, span: int) -> np.ndarray:
    """n sorted distinct positions in [1, span), by spacing n + 1 exponential
    gaps over span - n and adding one base a row."""
    c = np.cumsum(g.standard_exponential(n + 1))
    return (np.floor(c[:n] / c[n] * (span - n)).astype(np.int64) + np.arange(n) + 1)


def _mut_rows(g, n: int, span: int, cfg: dict) -> MutRows:
    """One chromosome's ``.mut`` rows, drawn from ``g``."""
    pos = _sorted_unique_positions(g, n, span)
    lo, hi = cfg["age_end_range"]
    age_end = np.exp(g.uniform(np.log(lo), np.log(hi), n))
    age_begin = age_end * g.uniform(0.0, cfg["age_begin_frac_max"], n)
    age_begin[g.random(n) < cfg["share_age_begin_zero"]] = 0.0
    flipped = (g.random(n) < cfg["share_flipped"]).astype(np.int64)
    nbr = np.where(g.random(n) < cfg["share_two_branches"], 2, 1)
    inv = g.random(n) < cfg["share_inverted_ages"]
    age_begin[inv], age_end[inv] = age_end[inv], age_begin[inv] * 1.5 + 1.0
    junk = g.random(n) < cfg["share_junk_alleles"]
    anc_i = g.integers(0, 4, n)
    der_i = (anc_i + g.integers(1, 4, n)) % 4
    anc = np.where(junk, ord("N"), BASES[anc_i]).astype(np.uint8)
    der = np.where(junk, ord("A"), BASES[der_i]).astype(np.uint8)
    return MutRows(pos=pos, age_begin=np.rint(age_begin), age_end=np.rint(age_end),
                   flipped=flipped, num_branches=nbr, anc=anc, der=der, valid=~junk)


def _write_mut(path: str, m: MutRows, span: int) -> int:
    """Write the rows as a Relate ``.mut``; returns the bytes written."""
    n = m.pos.shape[0]
    snp = digits(np.arange(n))
    two = m.num_branches == 2
    branch = np.zeros((n, 3), np.uint8)
    branch[:, 0] = ord("0")
    branch[two, 1], branch[two, 2] = ord(" "), ord("1")
    text = rows_bytes([
        snp, literal(n, b";"), digits(m.pos), literal(n, b";"),
        digits(np.diff(np.append(m.pos, span))), literal(n, b";rs"), snp, literal(n, b";0;"),
        branch, literal(n, b";"), (48 + two).astype(np.uint8)[:, None], literal(n, b";"),
        (48 + m.flipped).astype(np.uint8)[:, None], literal(n, b";"),
        digits(m.age_begin.astype(np.int64)), literal(n, b";"),
        digits(m.age_end.astype(np.int64)), literal(n, b";"), m.anc[:, None], literal(n, b"/"),
        m.der[:, None], literal(n, b";\n"),
    ])
    with open(path, "wb") as fh:
        fh.write(MUT_HEADER)
        fh.write(text)
    return len(MUT_HEADER) + len(text)


def _stream(g, chroms, muts, n_hap: int, cfg: dict, path: str) -> tuple[Stream, int]:
    """Write a ``.colate.in`` over random subsets of the rows; returns it."""
    parts, starts, total = [], [0], 0
    with open(path, "wb") as fh:
        for name, m in zip(chroms, muts):
            idx = np.flatnonzero(g.random(m.pos.shape[0]) < cfg["share_present"])
            anc, der = m.anc[idx].copy(), m.der[idx].copy()
            swap = g.random(idx.size) < cfg["share_allele_mismatch"]
            anc[swap], der[swap] = der[swap], anc[swap]
            daf = g.integers(0, n_hap + 1, idx.size).astype(np.int32)
            aaf = (n_hap - daf).astype(np.int32)
            nb = name.encode()
            rec = np.zeros(idx.size, np.dtype([("l", "<i4"), ("c", f"S{len(nb)}"), ("bp", "<i4"),
                                               ("a", "u1"), ("d", "u1"), ("aaf", "<i4"),
                                               ("daf", "<i4")]))
            rec["l"], rec["c"], rec["bp"] = len(nb), nb, m.pos[idx]
            rec["a"], rec["d"], rec["aaf"], rec["daf"] = anc, der, aaf, daf
            fh.write(rec.tobytes())
            total += rec.nbytes
            parts.append((m.pos[idx].astype(np.int32), anc, der, aaf, daf))
            starts.append(starts[-1] + idx.size)
    cat = lambda i: np.concatenate([p[i] for p in parts])
    st = Stream(starts=np.asarray(starts, np.int64), names=list(chroms), bp=cat(0), anc=cat(1),
                der=cat(2), aaf=cat(3), daf=cat(4))
    return st, total


def make_pair(root: str, config: dict, seed: int) -> PairInputs:
    """A ``.mut`` per chromosome of ``config["chromosomes"]``, of its length
    times ``config["mut_rows_per_bp"]`` rows, and a target and a reference
    stream, under ``root``.  The rows are drawn in turn; the files are
    written by a thread each."""
    os.makedirs(root, exist_ok=True)
    ss = np.random.SeedSequence(seed)
    g_mut, g_t, g_r = (np.random.default_rng(s) for s in ss.spawn(3))
    prefix = os.path.join(root, "pair")
    chroms = list(config["chromosomes"])
    spans = [config["chromosomes"][c] for c in chroms]
    muts = [_mut_rows(g_mut, round(span * config["mut_rows_per_bp"]), span, config)
            for span in spans]
    target, reference = os.path.join(root, "target.colate.in"), os.path.join(root, "reference.colate.in")
    chr_file = os.path.join(root, "chr.txt")
    with open(chr_file, "w") as fh:
        fh.write("\n".join(chroms) + "\n")
    with ThreadPoolExecutor(max_workers=len(chroms) + 2) as ex:
        mut_bytes = [ex.submit(_write_mut, f"{prefix}_chr{c}.mut", m, span)
                     for c, m, span in zip(chroms, muts, spans)]
        t = ex.submit(_stream, g_t, chroms, muts, config["target_haplotypes"], config, target)
        r = ex.submit(_stream, g_r, chroms, muts, config["reference_haplotypes"], config, reference)
        (t_st, nt), (r_st, nr) = t.result(), r.result()
        written = sum(f.result() for f in mut_bytes) + nt + nr
    return PairInputs(prefix, target, reference, chr_file, chroms, muts, t_st, r_st, written)


# ---------------------------------------------------------------- a panel of cached counts

@dataclasses.dataclass
class PanelInputs:
    prefixes: list          # a pair's output prefix; <prefix>.colate_mat exists
    shared: list            # a pair's counts [B, 185] as written (before rounding)
    notshared: list
    bytes_written: int


def make_panel(root: str, config: dict, seed: int, device) -> PanelInputs:
    """``config["panel_size"]`` pairs' ``.colate_mat`` under ``root``."""
    import torch

    os.makedirs(root, exist_ok=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = torch.float64
    n, nb = config["sites"], config["blocks"]
    P, B = config["panel_size"], config["num_bootstraps"]
    u = lambda *shape: torch.rand(*shape, generator=gen, device=device, dtype=f64)
    lo, hi = config["age_begin_range"]
    ab = torch.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * u(n))
    g_lo, g_hi = config["age_ratio_log_range"]
    ae = ab * torch.exp(g_lo + (g_hi - g_lo) * u(n))
    ab = torch.where(u(n) < config["share_age_begin_zero"], torch.zeros_like(ab), ab)
    block = torch.sort(torch.randint(0, nb, (n,), generator=gen, device=device)).values
    age = bootstrap.age_generations(config["target_age"], config["years_per_gen"])
    keep = ae >= age                      # the join drops mutations younger than the target
    ab, ae, block = ab[keep], ae[keep], block[keep]
    w_hi = config["site_weight_max"]
    ws = w_hi * u(ab.shape[0], P)
    wn = w_hi * u(ab.shape[0], P)
    hists = binning.bin_sites(ab, ae, ws, wn, block, nb, device=device)
    del ab, ae, block, ws, wn
    centers = bootstrap.age_bin_centers()
    prefixes, shared, notshared, written = [], [], [], 0
    for p in range(P):
        draws = torch.randint(0, nb, (B, nb), generator=gen, device=device)
        w = torch.zeros(B, nb, dtype=f64, device=device)
        w.scatter_add_(1, draws, torch.ones_like(w))
        sc, nc = bootstrap.counts([h[p] for h in hists], w.cpu().numpy(), age)
        sc, nc = sc / COLATE_MAT_NORM, nc / COLATE_MAT_NORM
        prefix = os.path.join(root, f"pair{p:02d}")
        write_colate_mat(prefix + ".colate_mat", centers, sc, nc)
        written += os.path.getsize(prefix + ".colate_mat")
        prefixes.append(prefix)
        shared.append(sc)
        notshared.append(nc)
    return PanelInputs(prefixes, shared, notshared, written)
