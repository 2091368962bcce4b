"""The last host modes of the port, ``print_tmp``, ``compare_tmp``,
``count_topo`` and ``CondCoalRates``, through its CLI against ``python -m
colate_tpu`` on the CPU: the same inputs, byte-identical output files.
CondCoalRates on tests/test_aux_modes.py's layouts under the analytic
walk and the ``mc_parity`` replay, with an empty conditional group,
bootstraps, a mask and a map, ancient samples, and 3,000 trees.  Also: no
host mode imports torch (each run in a fresh process), the modules that
compute with torch turn TF32 off, and CondCoalRates has no Python
fallback.  The host modules of the library surface (the importers,
``.trees``, branch association, CollapsedMatrix, annotate_ages, the tree
E-step, StageTimer) import no torch either, in a fresh process.

The fixtures are the port's generators (colate_tpu_torch/fixtures.py),
which write the bytes of tests/helpers' (test_torch_make_tmp.py holds
that), from numpy seeds."""

import ast
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from colate_tpu import cli as jax_cli
from colate_tpu_torch import cli
from test_torch_mut import REPO, load_native

FOC_CON_OTH = lambda n: [f"S{i} {'FOC' if i < 2 else 'CON' if i < 4 else 'OTH'} G1 NA\n"
                         for i in range(n)]


def _poplabels(path, n_samples):
    with open(path, "w") as fh:
        fh.write("sample population group sex\n")
        fh.writelines(FOC_CON_OTH(n_samples))
    return path


def _chrfile(root, chroms):
    path = os.path.join(root, "chr.txt")
    with open(path, "w") as fh:
        fh.write("".join(f"{c}\n" for c in chroms))
    return path


def _both(tmp_path, capsys, argv):
    """Runs both CLIs on argv (+ -o); returns the two output paths, after
    checking that the port wrote a non-empty file."""
    ref, ours = str(tmp_path / "jax.txt"), str(tmp_path / "torch.txt")
    assert jax_cli.main(argv + ["-o", ref]) == 0
    assert cli.main(argv + ["-o", ours]) == 0
    capsys.readouterr()
    assert os.path.getsize(ours) > 0
    return ref, ours


def _same(a, b):
    return filecmp.cmp(a, b, shallow=False)


# ---- print_tmp, compare_tmp, count_topo ---------------------------------------

@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    """tests/test_cli.py's fixture (make_fixture at 800 rows, seed 31) and a
    third stream for count_topo's -i (seed 777, 8 haplotypes)."""
    from colate_tpu_torch.fixtures import make_fixture, make_stream

    load_native()
    f = make_fixture(str(tmp_path_factory.mktemp("hostmodes")), n_per_chrom=800, seed=31)
    f["cond"] = os.path.join(f["root"], "cond.colate.in")
    make_stream(f["cond"], f["chroms"], f["mut_tables"], seed=777, n_hap=8)
    return f


def test_print_tmp(fix, tmp_path, capsys):
    a, b = _both(tmp_path, capsys, ["--mode", "print_tmp", "--mut", fix["mut_prefix"],
                                     "--target_tmp", fix["target"], "--chr", fix["chrfile"]])
    assert _same(a, b)
    with open(b) as fh:
        rows = [ln.split() for ln in fh]
    assert len(rows) > 100 and all(len(r) == 8 for r in rows)


@pytest.mark.parametrize("seed", [11, 23])
def test_compare_tmp(fix, tmp_path, capsys, seed):
    a, b = _both(tmp_path, capsys, [
        "--mode", "compare_tmp", "--mut", fix["mut_prefix"], "--target_tmp", fix["target"],
        "--reference_tmp", fix["reference"], "--chr", fix["chrfile"], "--seed", str(seed)])
    assert _same(a, b)


def test_count_topo(fix, tmp_path, capsys):
    a, b = _both(tmp_path, capsys, [
        "--mode", "count_topo", "--mut", fix["mut_prefix"], "--target_tmp", fix["target"],
        "--reference_tmp", fix["reference"], "-i", fix["cond"], "--chr", fix["chrfile"],
        "--seed", "13"])
    assert _same(a, b)
    with open(b) as fh:
        assert len(fh.read().splitlines()) > 10


# ---- CondCoalRates ------------------------------------------------------------

@pytest.fixture(scope="module")
def cond(tmp_path_factory):
    """tests/test_aux_modes.py's CondCoalRates layouts: two chromosomes of
    19 trees of 12 haplotypes (cond_fixture), with a mask and a
    recombination map a chromosome (test_cond_coal_rates_mask_map_golden's
    generator); 400 trees with ancient samples; 3,000 trees of 14
    haplotypes."""
    from colate_tpu_torch.fixtures import make_anc_mut
    from colate_tpu_torch.formats.mut import MutTable

    load_native()
    root = str(tmp_path_factory.mktemp("cond"))
    prefix = os.path.join(root, "trees")
    for i, c in enumerate(["1", "2"]):
        make_anc_mut(prefix, c, N=12, num_trees=19, seed=61 + i)
    g = np.random.default_rng(5)
    mask, gmap = os.path.join(root, "mask"), os.path.join(root, "map")
    for c in ["1", "2"]:
        L = int(MutTable.read(f"{prefix}_chr{c}.mut").pos[-1]) + 10_000
        seq = np.where(g.random(L) < 0.95, ord("P"), ord("N")).astype(np.uint8)
        with open(f"{mask}_chr{c}.fa", "w") as fh:
            fh.write(">mask\n" + bytes(seq).decode() + "\n")
        bps = np.append(np.sort(g.choice(np.arange(1, L - 1), size=11, replace=False)), L)
        rates = np.where(g.random(bps.size) < 0.3, g.uniform(0.5, 3.0, bps.size),
                         g.uniform(0.0, 0.05, bps.size))
        gen = np.concatenate([[0.0], np.cumsum(rates[:-1] * np.diff(bps) / 1e6)])
        with open(f"{gmap}_chr{c}.txt", "w") as fh:
            fh.write("pos COMBINED_rate Genetic_Map\n")
            fh.writelines(f"{b} {r} {gn}\n" for b, r, gn in zip(bps, rates, gen))
    old = os.path.join(root, "old")
    make_anc_mut(old, "1", N=12, num_trees=400, seed=23,
                 sample_ages=[0.0, 40.0, 0.0, 125.0, 0.0, 0.0, 7.5, 0.0, 0.0, 310.0, 0.0, 0.0])
    big = os.path.join(root, "big")
    make_anc_mut(big, "1", N=14, num_trees=3000, snps_per_tree=3, seed=9)
    return dict(root=root, prefix=prefix, old=old, big=big, mask=mask, map=gmap,
                chrfile=_chrfile(root, ["1", "2"]),
                one=os.path.join(root, "one.txt"),
                pop6=_poplabels(os.path.join(root, "pop6.poplabels"), 6),
                pop7=_poplabels(os.path.join(root, "pop7.poplabels"), 7))


def _cond_argv(cond, src="prefix", groups="FOC,CON", boots=1, sampling="analytic", pop="pop6"):
    chrfile = cond["chrfile"]
    if src != "prefix":
        chrfile = cond["one"]
        with open(chrfile, "w") as fh:
            fh.write("1\n")
    return ["--mode", "CondCoalRates", "-i", cond[src], "--chr", chrfile, "--poplabels",
            cond[pop], "--groups", groups, "--bins", "2,6,0.5", "--seed", "7",
            "--num_bootstraps", str(boots), "--sampling", sampling]


def _rates(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    assert lines[0] == "boot lineage_epoch epoch.start group rate"
    return np.array([float(ln.split()[4]) for ln in lines[1:]])


@pytest.mark.parametrize("sampling", ["analytic", "mc_parity"])
@pytest.mark.parametrize("groups", ["FOC,CON", "FOC,NONEXIST"])
def test_cond_coal(cond, tmp_path, capsys, groups, sampling):
    """An empty conditional group (NONEXIST) takes the c=-1 path."""
    a, b = _both(tmp_path, capsys, _cond_argv(cond, groups=groups, sampling=sampling))
    assert _same(a, b)
    assert np.isfinite(_rates(b)).sum() > 10


@pytest.mark.parametrize("sampling", ["analytic", "mc_parity"])
def test_cond_coal_bootstraps(cond, tmp_path, capsys, sampling):
    a, b = _both(tmp_path, capsys, _cond_argv(cond, boots=4, sampling=sampling))
    assert _same(a, b)
    assert len(_rates(b)) == 4 * 2 * 11 * 3  # boots x focal epochs x epochs x groups


@pytest.mark.parametrize("sampling", ["analytic", "mc_parity"])
def test_cond_coal_mask_map(cond, tmp_path, capsys, sampling):
    """The mask's passing fraction and the map's recombination rate drop
    trees (the cutoff is always 0.9, as in the reference), so the rates
    differ from the unfiltered run's."""
    argv = _cond_argv(cond, sampling=sampling)
    a, b = _both(tmp_path, capsys, argv + ["--mask", cond["mask"], "--map", cond["map"]])
    assert _same(a, b)
    assert cli.main(argv + ["-o", str(tmp_path / "plain.txt")]) == 0
    assert not _same(b, str(tmp_path / "plain.txt"))


def test_cond_coal_ancient(cond, tmp_path, capsys):
    """Nonzero sample ages take the age-aware replay (cn_cond_chrom with
    the ages) under the default --sampling analytic."""
    a, b = _both(tmp_path, capsys, _cond_argv(cond, src="old"))
    assert _same(a, b)
    assert np.isfinite(_rates(b)).sum() > 10


@pytest.mark.parametrize("sampling", ["analytic", "mc_parity"])
def test_cond_coal_at_3000_trees(cond, tmp_path, capsys, sampling):
    """tests/test_aux_modes.py:test_cond_coal_rates_byte_parity_at_scale's
    input, four bootstraps; the analytic walk within 1e-4 of the replay,
    with the same NaN pattern."""
    argv = _cond_argv(cond, src="big", boots=4, sampling=sampling, pop="pop7")
    a, b = _both(tmp_path, capsys, argv)
    assert _same(a, b)
    if sampling == "analytic":
        assert cli.main(_cond_argv(cond, src="big", boots=4, sampling="mc_parity", pop="pop7")
                        + ["-o", str(tmp_path / "replay.txt")]) == 0
        ours, replay = _rates(b), _rates(str(tmp_path / "replay.txt"))
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(replay))
        ok = np.isfinite(replay)
        assert ok.sum() > 50
        np.testing.assert_allclose(ours[ok], replay[ok], rtol=1e-4)


@pytest.mark.parametrize("src", ["prefix", "old"])
def test_tree_spans_and_children_match(cond, src):
    """The port's tree_spans and _children (written for modes tree and
    local_ancestry) give CondCoalRates the JAX package's arrays."""
    from colate_tpu.formats.anc import AncFile as JaxAnc
    from colate_tpu.formats.mut import MutTable as JaxMut
    from colate_tpu.models.local_ancestry import _children as jax_children
    from colate_tpu.models.tree_coal import tree_spans as jax_spans
    from colate_tpu_torch.formats.anc import AncFile
    from colate_tpu_torch.formats.mut import MutTable
    from colate_tpu_torch.models.local_ancestry import _children
    from colate_tpu_torch.models.tree_coal import tree_spans

    base = cond[src] + "_chr1"
    anc, mut = AncFile.read(base + ".anc", columns="tree"), MutTable.read(base + ".mut")
    janc, jmut = JaxAnc.read(base + ".anc", columns="tree"), JaxMut.read(base + ".mut")
    np.testing.assert_array_equal(anc.parent, janc.parent)
    np.testing.assert_array_equal(anc.branch_length, janc.branch_length)
    assert (anc.sample_ages is None) == (src == "prefix")
    if src == "old":
        np.testing.assert_array_equal(anc.sample_ages, janc.sample_ages)
    np.testing.assert_array_equal(tree_spans(anc, mut), jax_spans(janc, jmut))
    np.testing.assert_array_equal(_children(anc), jax_children(janc))


def test_cond_epochs_and_map_helpers():
    """The epoch grids, the epoch lookups and the map's per-tree rates of
    the port's cond_coal against the JAX package's."""
    from colate_tpu.formats.gmap import RecombMap as JaxMap
    from colate_tpu.models import cond_coal as ref
    from colate_tpu_torch.formats.gmap import RecombMap
    from colate_tpu_torch.models import cond_coal

    for ypg in (28.0, 25.0):
        np.testing.assert_array_equal(cond_coal.default_epochs(ypg), ref.default_epochs(ypg))
        np.testing.assert_array_equal(cond_coal.epochs_from_bins_cond("2,6,0.5", ypg),
                                      ref.epochs_from_bins_cond("2,6,0.5", ypg))
    epochs = ref.epochs_from_bins_cond("2,6,0.25", 28.0)
    focal = np.array([0.0, 1e3])
    for age in np.concatenate([[0.0], epochs, np.random.default_rng(3).uniform(0, 4e4, 200)]):
        assert cond_coal._ep_init_of(age, epochs) == ref._ep_init_of(age, epochs)
        assert cond_coal._ep_focal_of(age, focal) == ref._ep_focal_of(age, focal)
    g = np.random.default_rng(8)
    bp = np.sort(g.choice(np.arange(1, 100_000), 30, replace=False))
    gen = np.concatenate([[0.0], np.cumsum(g.uniform(0, 3e-6, bp.size - 1) * np.diff(bp))])
    ps = np.sort(g.integers(bp[0], bp[-1] - 2000, 200))
    pe = ps + g.integers(1, 2000, 200)
    has = g.random(200) < 0.9
    np.testing.assert_array_equal(
        cond_coal._map_recrates(ps, pe, has, RecombMap(bp=bp, gen_pos=gen)),
        ref._map_recrates(ps, pe, has, JaxMap(bp=bp, gen_pos=gen)))


@pytest.mark.parametrize("sampling", ["analytic", "mc_parity"])
def test_cond_coal_without_native_raises(cond, tmp_path, monkeypatch, sampling):
    """With the native library unloadable once the trees are parsed, the
    walk raises naming the library's path: no Python fallback, no output."""
    from colate_tpu_torch import native
    from colate_tpu_torch.models import cond_coal

    bogus = str(tmp_path / "libcolate_io-broken.so")
    with open(bogus, "w") as fh:
        fh.write("not a shared library\n")
    spans = cond_coal.tree_spans

    def spans_then_break(anc, mut):
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "library_path", lambda build_dir=None: bogus)
        return spans(anc, mut)

    monkeypatch.setattr(cond_coal, "tree_spans", spans_then_break)
    out = str(tmp_path / "out.txt")
    with pytest.raises(RuntimeError, match=f"failed to build or load: {bogus}"):
        cli.main(_cond_argv(cond, sampling=sampling) + ["-o", out])
    assert not os.path.exists(out)


def test_the_card_test_holds_the_reference_bytes(tmp_path, capsys):
    """tests/test_torch_cuda.py holds print_tmp and CondCoalRates on a card
    machine to these digests of python -m colate_tpu's outputs."""
    from test_torch_cuda import HOST_MODE_SHA256, host_mode_outputs

    load_native()
    assert host_mode_outputs(str(tmp_path), jax_cli.main) == HOST_MODE_SHA256


# ---- host modes import no torch; torch modules turn TF32 off -------------------

HOST_MODES = ["make_tmp", "preprocess_mut", "calc_depth", "get_deam", "print_tmp", "compare_tmp",
              "count_topo", "CondCoalRates"]

# runs each (mode, argv) of argv[1] through the port's CLI in this one fresh
# process and records its exit code and whether torch was loaded after it
NO_TORCH = """
import json, sys
from colate_tpu_torch import cli
out = {}
for mode, argv in json.loads(sys.argv[1]):
    out[mode] = [cli.main(argv), "torch" in sys.modules]
with open(sys.argv[2], "w") as fh:
    json.dump(out, fh)
"""


@pytest.fixture(scope="module")
def no_torch_runs(fix, cond, tmp_path_factory):
    """Every host mode, in turn, in one process that has not imported torch."""
    from colate_tpu_torch.fixtures import make_anc_mut, make_bcf_bam_fixture
    from colate_tpu_torch.formats.fasta import write_fasta
    from helpers.synth_vcf import make_vcf_for_preprocess

    root = str(tmp_path_factory.mktemp("notorch"))
    bb = make_bcf_bam_fixture(os.path.join(root, "bb"), n_rows=300, reads_per_contig=1500)
    g = np.random.default_rng(7)
    _, mt = make_anc_mut(os.path.join(root, "pp"), "1", N=10, num_trees=25, snps_per_tree=30,
                         seed=77)
    span = int(mt.pos[-1]) + 50
    ref_g = "".join(g.choice(list("ACGT"), size=span))
    write_fasta(os.path.join(root, "rg.fa"), "1", ref_g)
    write_fasta(os.path.join(root, "mask.fa"), "1",
                "".join(np.where(g.random(span) < 0.1, "N", "P")))
    make_vcf_for_preprocess(os.path.join(root, "ref.bcf"), "1", mt, ref_g, ref_g, seed=177)
    o = lambda name: ["-o", os.path.join(root, name)]
    bam = ["--target_bam", bb["target_bam"], "--ref_genome", bb["rg_prefix"], "--chr",
           bb["chrfile"]]
    tmp = ["--mut", fix["mut_prefix"], "--target_tmp", fix["target"], "--chr", fix["chrfile"]]
    runs = [
        ("make_tmp", ["--mode", "make_tmp", "--mut", bb["mut_prefix"], *bam, *o("made")]),
        ("preprocess_mut", ["--mode", "preprocess_mut", "--anc", os.path.join(root, "pp_chr1.anc"),
                            "--mut", os.path.join(root, "pp_chr1.mut"), "--reference_bcf",
                            os.path.join(root, "ref.bcf"), "--ref_genome",
                            os.path.join(root, "rg.fa"), "--anc_genome",
                            os.path.join(root, "rg.fa"), "--mask", os.path.join(root, "mask.fa"),
                            *o("pp.mut")]),
        ("calc_depth", ["--mode", "calc_depth", *bam, *o("depth")]),
        ("get_deam", ["--mode", "get_deam", *bam, *o("deam")]),
        ("print_tmp", ["--mode", "print_tmp", *tmp, *o("printed")]),
        ("compare_tmp", ["--mode", "compare_tmp", *tmp, "--reference_tmp", fix["reference"],
                         *o("compared")]),
        ("count_topo", ["--mode", "count_topo", *tmp, "--reference_tmp", fix["reference"],
                        "-i", fix["cond"], *o("topo")]),
        ("CondCoalRates", [*_cond_argv(cond), *o("cond")]),
    ]
    assert [m for m, _ in runs] == HOST_MODES
    result = os.path.join(root, "result.json")
    p = subprocess.run([sys.executable, "-c", NO_TORCH, json.dumps(runs), result], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(result) as fh:
        return json.load(fh)


@pytest.mark.parametrize("mode", HOST_MODES)
def test_host_mode_imports_no_torch(no_torch_runs, mode):
    rc, torch_loaded = no_torch_runs[mode]
    assert rc == 0
    assert not torch_loaded, f"torch was imported by mode {mode} (or a mode before it)"


# the host modules of the library surface: each imported in turn in one fresh
# process, then driven once on a small genealogy (SMC import, node ages,
# .trees round trip, branch association, annotate_ages, the tree E-step,
# CollapsedMatrix, StageTimer), recording whether torch was loaded after each
LIBRARY_MODULES = ["colate_tpu_torch.formats.anc", "colate_tpu_torch.formats.mut",
                   "colate_tpu_torch.formats.trees", "colate_tpu_torch.formats.branch_assoc",
                   "colate_tpu_torch.formats.collapsed", "colate_tpu_torch.ops.em_tree",
                   "colate_tpu_torch.utils.progress"]
NO_TORCH_LIBRARY = """
import importlib, json, os, sys
out = {}
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
    out[name] = "torch" in sys.modules
import numpy as np
from colate_tpu_torch.fixtures import make_anc_mut, write_genealogy
from colate_tpu_torch.formats import anc, branch_assoc, collapsed, mut, trees
from colate_tpu_torch.ops import em_tree
from colate_tpu_torch.utils.progress import StageTimer
root = sys.argv[2]
st = StageTimer()
with st.stage("all"):
    a, m = make_anc_mut(os.path.join(root, "g"), "1", N=8, num_trees=12, seed=3)
    write_genealogy(os.path.join(root, "g.smc"), a, "smc", seed=1)
    imp = anc.read_argweaver_smc(os.path.join(root, "g.smc"))
    anc.node_ages(imp)
    trees.write_trees_file(trees.anc_to_tables(imp, m), os.path.join(root, "g.trees"))
    back = trees.tables_to_anc(trees.read_trees_file(os.path.join(root, "g.trees")), 8)
    branch_assoc.associate_equivalent_branches(back)
    mut.annotate_ages(m, imp)
    ones = np.ones(185, np.float32)
    em_tree.em_tree_shared(np.array([0.0, 100.0, 1e4]), np.full(3, 1e-4), ones, ones, 50.0, 50.0)
    with open(os.path.join(root, "g.bin"), "wb") as fh:
        collapsed.write_collapsed(fh, np.eye(3, dtype=np.float32))
out["workflow"] = "torch" in sys.modules
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def no_torch_library(tmp_path_factory):
    load_native()
    p = subprocess.run([sys.executable, "-c", NO_TORCH_LIBRARY, json.dumps(LIBRARY_MODULES),
                        str(tmp_path_factory.mktemp("notorchlib"))], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.splitlines()[-1])


@pytest.mark.parametrize("step", LIBRARY_MODULES + ["workflow"])
def test_library_host_modules_import_no_torch(no_torch_library, step):
    assert not no_torch_library[step], f"torch was loaded by {step} (or a step before it)"

TF32 = """
import importlib, sys, torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
importlib.import_module(sys.argv[1])
print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
"""


@pytest.mark.parametrize("module", ["colate_tpu_torch.ops.em", "colate_tpu_torch.ops.tree_kernel"])
def test_torch_modules_turn_tf32_off(module):
    """Importing a module that computes with torch turns both switches off,
    even where the process had turned them on."""
    p = subprocess.run([sys.executable, "-c", TF32, module], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split() == ["False", "False"]


def test_every_torch_module_takes_torch_from_one_place():
    """A module of the port that names torch imports it from _torch.py (the
    TF32 switches), at its top or in the function that uses it; no other
    module imports torch itself."""
    pkg = os.path.join(REPO, "colate_tpu_torch")
    users = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py") or name == "_torch.py":
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read())
            typing_only = {id(n) for b in ast.walk(tree) if isinstance(b, ast.If)
                           and getattr(b.test, "id", None) == "TYPE_CHECKING"
                           for s in b.body for n in ast.walk(s)}
            direct = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Import)
                      and id(n) not in typing_only and any(a.name == "torch" for a in n.names)]
            assert not direct, f"{path}:{direct} imports torch itself"
            via = any(isinstance(n, ast.ImportFrom) and n.module == "colate_tpu_torch._torch"
                      for n in ast.walk(tree))
            named = any(isinstance(n, ast.Name) and n.id == "torch" for n in ast.walk(tree))
            if named:
                assert via, f"{path} uses torch without importing colate_tpu_torch._torch"
                users.append(name)
    assert {"em.py", "em_kernel.py", "bin_kernel.py", "tree_kernel.py", "la_kernel.py",
            "binning.py", "mesh.py", "multihost.py", "mut_em.py", "cli.py"} <= set(users)
