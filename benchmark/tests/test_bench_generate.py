"""The generator is deterministic per seed, and the program's readers read
what it writes."""

import hashlib
import json
import os

import numpy as np

from benchmark.harness import generate

from .conftest import REPO

PAIR = dict(json.load(open(os.path.join(REPO, "benchmark", "configs", "mut_modern_pair.json"))),
            chromosomes={"7": 9_000_000, "12": 5_000_000}, mut_rows_per_bp=3e-4)
PANEL = dict(json.load(open(os.path.join(REPO, "benchmark", "configs", "mut_ancient_panel.json"))),
             sites=20_000, panel_size=2, num_bootstraps=8)


def _digest(root):
    h = hashlib.sha256()
    for f in sorted(os.listdir(root)):
        h.update(f.encode())
        with open(os.path.join(root, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def test_pair_is_deterministic(tmp_path):
    seed = 2**31 + 977
    generate.make_pair(str(tmp_path / "a"), PAIR, seed)
    generate.make_pair(str(tmp_path / "b"), PAIR, seed)
    generate.make_pair(str(tmp_path / "c"), PAIR, seed + 1)
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b") != _digest(tmp_path / "c")


def test_panel_is_deterministic(tmp_path):
    a = generate.make_panel(str(tmp_path / "a"), PANEL, 5, "cpu")
    b = generate.make_panel(str(tmp_path / "b"), PANEL, 5, "cpu")
    generate.make_panel(str(tmp_path / "c"), PANEL, 6, "cpu")
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b") != _digest(tmp_path / "c")
    assert a.bytes_written == b.bytes_written > 0


def test_program_reads_the_pair(tmp_path):
    from colate_tpu_torch.formats.colate_in import read_colate_in
    from colate_tpu_torch.formats.mut import MutTable

    p = generate.make_pair(str(tmp_path), PAIR, 11)
    for name, rows in zip(p.chroms, p.muts):
        t = MutTable.read(f"{p.mut_prefix}_chr{name}.mut")
        assert np.array_equal(t.pos, rows.pos)
        assert np.array_equal(t.age_begin, rows.age_begin)
        assert np.array_equal(t.age_end, rows.age_end)
        assert np.array_equal(t.flipped, rows.flipped)
        assert np.array_equal(t.num_branches, rows.num_branches)
        assert np.array_equal(t.allele_valid, rows.valid)
        assert np.array_equal(t.anc_code[rows.valid], rows.anc[rows.valid])
        assert np.array_equal(t.der_code[rows.valid], rows.der[rows.valid])
        assert np.array_equal(t.dist, np.diff(np.append(rows.pos, PAIR["chromosomes"][name])))
        assert np.all(np.diff(rows.pos) > 0) and rows.pos[0] >= 1
    for path, st in ((p.target, p.target_stream), (p.reference, p.reference_stream)):
        s = read_colate_in(path)
        assert list(s.runs()[1]) == p.chroms
        assert np.array_equal(s.runs()[0], st.starts)
        for col in ("bp", "anc", "der", "aaf", "daf"):
            assert np.array_equal(getattr(s, col), getattr(st, col)), col


def test_program_reads_the_panel(tmp_path):
    from colate_tpu_torch.formats.colate_mat import read_colate_mat

    p = generate.make_panel(str(tmp_path), PANEL, 3, "cpu")
    for prefix, sc, nc in zip(p.prefixes, p.shared, p.notshared):
        bins, s, n = read_colate_mat(prefix + ".colate_mat", PANEL["num_bootstraps"])
        assert np.allclose(s, sc, rtol=6e-6, atol=0) and np.allclose(n, nc, rtol=6e-6, atol=0)
        assert np.array_equal(s == 0, sc == 0)
        assert bins.shape == (185,)


def test_sci6_round_trips_six_digits():
    x = np.array([0.0, 1.0, 9.999995, 0.000123456789, 123456789.0, 5e-300, 999999.5, 1e-5])
    txt = generate.rows_bytes([generate.sci6(x), generate.literal(x.size, b"\n")]).split()
    back = np.array([float(t) for t in txt])
    assert np.array_equal(back, np.array([float(f"{v:.5e}") for v in x]))
