"""The port's genealogy interchange (colate_tpu_torch/formats: the Newick,
RENT+ and ARGweaver SMC importers of anc.py, trees.py, branch_assoc.py,
collapsed.py, mut.py:annotate_ages, utils/progress.py:StageTimer) against
colate_tpu's, on the CPU.

Both packages get the same files, written from numpy seeds; every column
must be bitwise equal and every written file byte-identical (the port's
copies are the JAX package's host code, so there is no tolerance).  Also
mode ``tree`` under ``--torch_device cpu`` on an SMC-imported genealogy
whose internal labels were permuted in the file (imported, parents are not
numbered after their children): the ``.coal`` byte-identical to ``python
-m colate_tpu``'s.
"""

import dataclasses
import filecmp
import gzip
import os

import numpy as np
import pytest

from colate_tpu import cli as jax_cli
from colate_tpu.formats import anc as jax_anc
from colate_tpu.formats import branch_assoc as jax_ba
from colate_tpu.formats import collapsed as jax_collapsed
from colate_tpu.formats import mut as jax_mut
from colate_tpu.formats import trees as jax_trees
from colate_tpu.utils import progress as jax_progress
from colate_tpu_torch import cli
from colate_tpu_torch.fixtures import make_anc_mut, write_genealogy
from colate_tpu_torch.formats import anc, branch_assoc, collapsed, mut, trees
from colate_tpu_torch.utils import progress
from test_torch_mut import load_native

ANC_COLUMNS = ("n_hap", "sample_ages", "start_pos", "parent", "branch_length", "num_events",
               "snp_begin", "snp_end")
READERS = {"newick": ("read_newick_trees", (1.0,)), "rent": ("read_rent", (2e4,)),
           "smc": ("read_argweaver_smc", ())}


def _same_anc(a, b):
    for f in ANC_COLUMNS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _same_files(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


def _import_both(path, fmt, tmp_path):
    """Imports path with both packages; checks the columns bitwise and the
    .anc each writes byte for byte; returns the port's AncFile."""
    name, args = READERS[fmt]
    ours = getattr(anc, name)(path, *args)
    ref = getattr(jax_anc, name)(path, *args)
    _same_anc(ours, ref)
    ours.write(str(tmp_path / "ours.anc"))
    ref.write(str(tmp_path / "ref.anc"))
    _same_files(str(tmp_path / "ours.anc"), str(tmp_path / "ref.anc"))
    np.testing.assert_array_equal(anc.node_ages(ours), jax_anc.node_ages(ref))
    return ours


# ---- importers -----------------------------------------------------------------

# the literal inputs of tests/test_anc_importers.py
LITERALS = {
    "newick_two_trees": ("newick", "100 ((0:1.0,1:1.0):3.0,(2:2.0,3:2.5):1.5);\n"
                                   "200 ((0:1.0,2:1.0):3.0,(1:2.0,3:2.5):1.5);\n"),
    "newick_ne_and_drop": ("newick", "1 ((0:0.5,1:0.5):1.0,(2:1.0,3:1.0):0.5);\n"
                                     "2 ((0:0.5,1:0.5,2:1.0):1.0,3:1.0);\n"),
    "rent": ("rent", "10 ((1:0.1,2:0.1):0.3,(3:0.2,4:0.25):0.15)\n"),
    "smc": ("smc", "NAMES\t1\t2\t3\t4\nREGION\tchr\t1\t1000\n"
                   "TREE\t55\t500\t((0:1.0[&&NHX:age=0],1:1.0[&&NHX:age=0])4:3.0[&&NHX:age=1],"
                   "(2:2.0[&&NHX:age=0],3:2.5[&&NHX:age=0])5:1.5[&&NHX:age=1])6[&&NHX:age=4.5];\n"),
    "smc_root_relabel": ("smc", "NAMES\t1\t2\t3\t4\n"
                                "TREE\t7\t99\t((0:1.0,1:1.0)6:3.0,(2:2.0,3:2.5)5:1.5)4;\n"),
}


@pytest.mark.parametrize("case", sorted(LITERALS))
def test_importer_literals(case, tmp_path):
    load_native()
    fmt, text = LITERALS[case]
    path = str(tmp_path / f"in.{fmt}")
    with open(path, "w") as fh:
        fh.write(text)
    _import_both(path, fmt, tmp_path)
    if case == "newick_ne_and_drop":
        ours, ref = anc.read_newick_trees(path, 100.0), jax_anc.read_newick_trees(path, 100.0)
        _same_anc(ours, ref)
        assert ours.num_trees == 1


# a non-binary tree, a tree cut short and a branch length that is not a
# number: the reference drops each line
DROPPED = ["5 ((0:1.0,1:1.0,2:1.0):1.0,3:1.0);\n", "6 ((0:1.0,1:1.0):2.0,(2:1.0,3\n",
           "7 ((0:abc,1:1.0):2.0,(2:1.0,3:1.0):1.0);\n"]


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """12 haplotypes, 40 coalescent trees of fixtures.make_anc_mut."""
    load_native()
    root = str(tmp_path_factory.mktemp("interchange"))
    a, m = make_anc_mut(os.path.join(root, "src"), "1", N=12, num_trees=40, snps_per_tree=6,
                        seed=19)
    return dict(root=root, anc=a, mut=m, prefix=os.path.join(root, "src"))


@pytest.mark.parametrize("fmt", sorted(READERS))
@pytest.mark.parametrize("gz", ["plain", "gz", "gz_probed"])
def test_importers_on_written_trees(source, tmp_path, fmt, gz):
    """Trees written by fixtures.write_genealogy (SMC: permuted leaf and
    internal labels); Newick and RENT+ files also carry the DROPPED lines;
    gzip read by its own name and through the path-without-.gz probe."""
    src = source["anc"]
    plain = str(tmp_path / f"t.{fmt}")
    write_genealogy(plain, src, fmt, ne=2e4, seed=5)
    if fmt != "smc":
        with open(plain) as fh:
            lines = fh.readlines()
        with open(plain, "w") as fh:
            fh.writelines(lines[:3] + DROPPED + lines[3:])
    path = plain
    if gz != "plain":
        with open(plain, "rb") as fh, gzip.open(plain + ".gz", "wb") as out:
            out.write(fh.read())
        os.remove(plain)
        path = plain + ".gz" if gz == "gz" else plain
    ours = _import_both(path, fmt, tmp_path)
    assert ours.num_trees == src.num_trees
    np.testing.assert_array_equal(ours.start_pos, src.start_pos)
    assert (ours.parent[:, -1] == -1).all()
    if fmt == "smc":
        M = ours.parent.shape[1]
        # arbitrary numbering: some parents sit below their children
        assert not np.all((ours.parent > np.arange(M)) | (ours.parent < 0))


def test_tree_mode_on_smc_import_writes_the_reference_bytes(source, tmp_path, capsys):
    """The JAX package's workflow, import -> AncFile.write -> --mode tree,
    through both CLIs (the port under --torch_device cpu)."""
    smc = str(tmp_path / "t.smc")
    write_genealogy(smc, source["anc"], "smc", seed=8)
    imported = anc.read_argweaver_smc(smc)
    assert imported.parent[:, -1].tolist() == [-1] * imported.num_trees
    prefix = str(tmp_path / "imp")
    imported.write(prefix + "_chr1.anc")
    source["mut"].write(prefix + "_chr1.mut")
    chrfile = str(tmp_path / "chr.txt")
    with open(chrfile, "w") as fh:
        fh.write("1\n")
    argv = ["--mode", "tree", "-i", prefix, "--chr", chrfile, "--bins", "2,6,0.25",
            "--num_bootstraps", "3", "--seed", "4"]
    assert jax_cli.main(argv + ["-o", str(tmp_path / "ref")]) == 0
    assert cli.main(argv + ["-o", str(tmp_path / "ours"), "--torch_device", "cpu"]) == 0
    capsys.readouterr()
    _same_files(str(tmp_path / "ours.coal"), str(tmp_path / "ref.coal"))


# ---- tskit tables and the .trees file -------------------------------------------

@pytest.fixture(scope="module", params=["relate", "smc_import"])
def genealogy(source, request):
    """The source trees as Relate numbers them, and as imported from SMC
    (arbitrary numbering), each with the source .mut."""
    a = source["anc"]
    if request.param == "smc_import":
        path = os.path.join(source["root"], "g.smc")
        write_genealogy(path, a, "smc", seed=13)
        a = anc.read_argweaver_smc(path)
    return a, source["mut"]


def _same_tables(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, float):
            assert x == y, f.name
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name


def test_anc_to_tables_and_text(genealogy, tmp_path):
    a, m = genealogy
    ours, ref = trees.anc_to_tables(a, m), jax_trees.anc_to_tables(a, m)
    _same_tables(ours, ref)
    ours.write_text(str(tmp_path / "ours"))
    ref.write_text(str(tmp_path / "ref"))
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 8
    for suffix in ("nodes", "edges", "sites", "mutations"):
        _same_files(str(tmp_path / f"ours.{suffix}.txt"), str(tmp_path / f"ref.{suffix}.txt"))


def test_trees_file_round_trip(genealogy, tmp_path):
    a, m = genealogy
    tb = trees.anc_to_tables(a, m)
    ours, ref = str(tmp_path / "ours.trees"), str(tmp_path / "ref.trees")
    trees.write_trees_file(tb, ours)
    jax_trees.write_trees_file(jax_trees.anc_to_tables(a, m), ref)
    _same_files(ours, ref)
    back, jax_back = trees.read_trees_file(ours), jax_trees.read_trees_file(ours)
    _same_tables(back, jax_back)
    _same_anc(trees.tables_to_anc(back, a.n_hap), jax_trees.tables_to_anc(jax_back, a.n_hap))


def test_kastore_round_trip(tmp_path):
    """tests/test_trees_binary.py:114's items: the same bytes, each
    package reads the other's file."""
    items = {
        "a/ints": np.arange(7, dtype=np.int32),
        "b/floats": np.linspace(0, 1, 5),
        "c/bytes": np.frombuffer(b"hello", np.int8).copy(),
        "d/empty": np.zeros(0, np.uint32),
    }
    ours, ref = str(tmp_path / "ours.kas"), str(tmp_path / "ref.kas")
    trees.kastore_write(ours, items)
    jax_trees.kastore_write(ref, items)
    _same_files(ours, ref)
    for read in (trees.kastore_read, jax_trees.kastore_read):
        back = read(ours)
        assert set(back) == set(items)
        for k, v in items.items():
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_to_tskit_needs_tskit(source, monkeypatch):
    """Both packages import tskit only inside to_tskit, and raise the same
    way where it cannot be imported."""
    monkeypatch.setitem(__import__("sys").modules, "tskit", None)
    tb = trees.anc_to_tables(source["anc"], source["mut"])
    with pytest.raises(ImportError):
        tb.to_tskit()
    with pytest.raises(ImportError):
        jax_trees.anc_to_tables(source["anc"], source["mut"]).to_tskit()


# ---- branch association ----------------------------------------------------------

# tests/test_relate_lib_corners.py:127-184's chains (N = 4)
CHAINS = {
    "identity": [[4, 4, 5, 6, 5, 6, -1]] * 3,
    "disjoint": [[4, 4, 5, 6, 5, 6, -1], [4, 4, 6, 5, 5, 6, -1]],
    "permuted": [[4, 4, 5, 6, 5, 6, -1], [5, 5, 4, 6, 6, 4, -1]],
}


def _random_chain(seed, N=10, T=12):
    """A chain of trees where each next tree is the last unchanged, with
    its internal labels below the root permuted, with two leaves swapped,
    or fresh."""
    from colate_tpu_torch.fixtures import random_tree

    g = np.random.default_rng(seed)
    M = 2 * N - 1
    chain = [random_tree(g, N)[0]]
    for _ in range(T - 1):
        par = chain[-1].copy()
        op = g.integers(0, 4)
        if op == 1:
            perm = np.arange(M)  # the root stays at 2N-2, as every importer leaves it
            perm[N:-1] = N + g.permutation(N - 2)
            new = np.full(M, -1, par.dtype)
            new[perm] = np.where(par >= 0, perm[np.maximum(par, 0)], -1)
            par = new
        elif op == 2:
            i, j = g.choice(N, 2, replace=False)
            par[i], par[j] = par[j], par[i]
        elif op == 3:
            par = random_tree(g, N)[0]
        chain.append(par)
    return chain


def _anc_of_chain(chain, N):
    T, M = len(chain), 2 * N - 1
    g = np.random.default_rng(T)
    return anc.AncFile(
        n_hap=N, sample_ages=None, start_pos=np.arange(T, dtype=np.int64),
        parent=np.array(chain, np.int32), branch_length=np.ones((T, M)),
        num_events=g.integers(0, 3, (T, M)).astype(np.float32),
        snp_begin=np.tile(np.arange(T, dtype=np.int32)[:, None], (1, M)),
        snp_end=np.tile(np.arange(T, dtype=np.int32)[:, None] + 1, (1, M)),
    )


@pytest.mark.parametrize("case", sorted(CHAINS) + ["random0", "random1", "random2"])
def test_branch_association(case):
    if case in CHAINS:
        chain, N = CHAINS[case], 4
    else:
        chain, N = _random_chain(int(case[-1])), 10
    chain = [np.asarray(p, np.int64) for p in chain]
    for p, q in zip(chain, chain[1:]):
        np.testing.assert_array_equal(branch_assoc.branch_association(p, q, N),
                                      jax_ba.branch_association(p, q, N))
    np.testing.assert_array_equal(branch_assoc.potential_branch_counts(N),
                                  jax_ba.potential_branch_counts(N))
    ours, ref = _anc_of_chain(chain, N), _anc_of_chain(chain, N)
    maps, jax_maps = (branch_assoc.associate_equivalent_branches(ours),
                      jax_ba.associate_equivalent_branches(ref))
    assert len(maps) == len(jax_maps) == len(chain) - 1
    for x, y in zip(maps, jax_maps):
        np.testing.assert_array_equal(x, y)
    _same_anc(ours, ref)


# ---- CollapsedMatrix, annotate_ages, StageTimer --------------------------------

def test_collapsed_matrix_bytes(tmp_path):
    g = np.random.default_rng(2)
    mats = [g.normal(size=(7, 5)).astype(np.float32), g.integers(-9, 9, (3, 11)).astype(np.int32),
            np.zeros((0, 4), np.float64)]
    for pkg, name in ((collapsed, "ours"), (jax_collapsed, "ref")):
        with open(tmp_path / name, "wb") as fh:
            for a in mats:
                pkg.write_collapsed(fh, a)
    _same_files(str(tmp_path / "ours"), str(tmp_path / "ref"))
    with open(tmp_path / "ours", "rb") as fh:
        for a in mats:
            back = collapsed.read_collapsed(fh, a.dtype)
            assert back.dtype == a.dtype and np.array_equal(back, a)
        with pytest.raises(EOFError):
            collapsed.read_collapsed(fh)


def test_annotate_ages(genealogy, source):
    """Relate numbering takes the ascending pass, the SMC import the walk
    per tree; rows of 0 or 2 branches are left as they are."""
    a, _ = genealogy
    m = mut.MutTable.read(source["prefix"] + "_chr1.mut")
    ref = jax_mut.MutTable.read(source["prefix"] + "_chr1.mut")
    m.branch = [list(b) for b in m.branch]
    m.branch[0], m.branch[1] = [], [0, 1]
    ref.branch = [list(b) for b in m.branch]
    before = m.age_begin[:2].copy(), m.age_end[:2].copy()
    mut.annotate_ages(m, a)
    jax_mut.annotate_ages(ref, a)
    for f in ("age_begin", "age_end"):
        x, y = getattr(m, f), getattr(ref, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    np.testing.assert_array_equal(m.age_begin[:2], before[0])
    np.testing.assert_array_equal(m.age_end[:2], before[1])


def test_stage_timer(monkeypatch, capsys):
    """The same stage records from the same clock readings: the JAX
    package's on time.time, the port's on time.perf_counter_ns, where it
    also keeps each stage's span."""
    records, timers = [], []
    readings = [10.0, 10.5, 11.0, 13.25, 20.0, 20.125]
    for pkg, clock_name, clock in (
            (progress, "perf_counter_ns", iter(int(r * 10**9) for r in readings)),
            (jax_progress, "time", iter(readings))):
        monkeypatch.setattr(pkg.time, clock_name, lambda: next(clock))
        st = pkg.StageTimer()
        for name in ("parse", "em", "parse"):
            with st.stage(name) as s:
                assert isinstance(s, pkg._Stage)
        monkeypatch.delenv("COLATE_TPU_LOG", raising=False)
        st.report(sites=7)
        monkeypatch.undo()
        records.append((st.timings, capsys.readouterr().err))
        timers.append(st)
    assert records[0] == records[1]
    assert records[0][0] == {"parse": 0.5 + 0.125, "em": 2.25}
    assert [tuple(s[:3]) for s in timers[0].spans] == [
        ("parse", 10 * 10**9, 10_500_000_000), ("em", 11 * 10**9, 13_250_000_000),
        ("parse", 20 * 10**9, 20_125_000_000)]
