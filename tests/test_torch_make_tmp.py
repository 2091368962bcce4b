"""The host modes that read BCF and BAM inputs, through the port's CLI
against ``python -m colate_tpu``, on the CPU: ``make_tmp`` (table, VCF and
BAM inputs), ``preprocess_mut``, ``calc_depth`` and ``get_deam`` must
write the same bytes.  Also: these modes need no card, and the input
generators of colate_tpu_torch/fixtures.py write the bytes of the JAX
package's test generators (and of tools/bench_bam_stream.py's)."""

import filecmp
import importlib.util
import os

import numpy as np
import pytest
import torch

from colate_tpu import cli as jax_cli
from colate_tpu_torch import cli
from test_torch_mut import REPO, load_native

# small tensors: one intra-op thread per test process (see test_torch_mut.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    """make_bcf_bam_fixture's inputs plus an ancestral genome a contig (the
    reference genome with 2% of its bases changed, for --strandfilter)."""
    from colate_tpu_torch.fixtures import make_bcf_bam_fixture
    from colate_tpu_torch.formats.fasta import read_fasta, write_fasta

    load_native()
    f = make_bcf_bam_fixture(str(tmp_path_factory.mktemp("maketmp")))
    g = np.random.default_rng(31)
    for c in f["chroms"]:
        anc = list(read_fasta(f"{f['rg_prefix']}_chr{c}.fa"))
        for j in np.nonzero(g.random(len(anc)) < 0.02)[0]:
            anc[j] = [b for b in "ACGT" if b != anc[j]][int(g.integers(0, 3))]
        write_fasta(os.path.join(f["root"], f"ag_chr{c}.fa"), c, "".join(anc))
    f["ag_prefix"] = os.path.join(f["root"], "ag")
    return f


def _both(tmp_path, capsys, argv, suffix):
    """Runs both CLIs on argv (+ -o); returns the two output paths."""
    ref, ours = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(argv + ["-o", ref]) == 0
    assert cli.main(argv + ["-o", ours]) == 0
    capsys.readouterr()
    return ref + suffix, ours + suffix


def _same(a, b):
    return filecmp.cmp(a, b, shallow=False)


def test_make_tmp_table(tmp_path, capsys):
    from colate_tpu_torch.fixtures import make_fixture
    from colate_tpu_torch.formats.fasta import write_fasta
    from helpers.synth import make_table

    load_native()
    f = make_fixture(str(tmp_path / "fix"), n_per_chrom=3000, seed=21)
    table = str(tmp_path / "reads.table")
    make_table(table, f["chroms"], f["mut_tables"], seed=5)
    for c in f["chroms"]:
        write_fasta(str(tmp_path / f"rg_chr{c}.fa"), c, "ACGT")
    argv = ["--mode", "make_tmp", "--mut", f["mut_prefix"], "--target_table", table,
            "--ref_genome", str(tmp_path / "rg"), "--chr", f["chrfile"]]
    a, b = _both(tmp_path, capsys, argv, ".colate.in")
    assert os.path.getsize(b) > 1000 and _same(a, b)


@pytest.mark.parametrize("encoding, mask", [("text", False), ("bcf2", False), ("bcf2", True)])
def test_make_tmp_vcf(fix, tmp_path, capsys, encoding, mask):
    prefix = fix["rvcf_prefix"] if encoding == "text" else fix["rbcf_prefix"]
    argv = ["--mode", "make_tmp", "--mut", fix["mut_prefix"], "--target_bcf", prefix,
            "--ref_genome", fix["rg_prefix"], "--chr", fix["chrfile"]]
    if mask:
        argv += ["--target_mask", fix["mask_prefix"]]
    a, b = _both(tmp_path, capsys, argv, ".colate.in")
    assert os.path.getsize(b) > 1000 and _same(a, b)


@pytest.mark.parametrize("variant", ["plain", "mask", "strand"])
def test_make_tmp_bam(fix, tmp_path, capsys, variant):
    argv = ["--mode", "make_tmp", "--mut", fix["mut_prefix"], "--target_bam", fix["target_bam"],
            "--ref_genome", fix["rg_prefix"], "--chr", fix["chrfile"]]
    if variant == "mask":
        argv += ["--target_mask", fix["mask_prefix"]]
    if variant == "strand":
        argv += ["--strandfilter", "--anc_genome", fix["ag_prefix"]]
    a, b = _both(tmp_path, capsys, argv, ".colate.in")
    assert os.path.getsize(b) > 1000 and _same(a, b)


def test_preprocess_mut(tmp_path, capsys):
    """tests/test_vcf_modes.py:test_preprocess_mut_golden's inputs."""
    from colate_tpu_torch.fixtures import make_anc_mut
    from colate_tpu_torch.formats.fasta import write_fasta
    from helpers.synth_vcf import make_vcf_for_preprocess

    load_native()
    root = str(tmp_path)
    g = np.random.default_rng(7)
    _, mt = make_anc_mut(os.path.join(root, "pp"), "1", N=10, num_trees=25, snps_per_tree=30,
                         seed=77, skip_trees=(0, 3))
    n = len(mt)
    mt.age_begin = g.uniform(1.0, 50.0, n)
    mt.age_end = np.full(n, 100.0)
    mt.write(os.path.join(root, "pp_chr1.mut"))
    span = int(mt.pos[-1]) + 50
    ref_g = "".join(g.choice(list("ACGT"), size=span))
    anc_list = list(ref_g)
    for i in np.nonzero(g.random(span) < 0.01)[0]:
        anc_list[i] = [b for b in "ACGT" if b != ref_g[i]][int(g.integers(0, 3))]
    anc_g = "".join(anc_list)
    write_fasta(os.path.join(root, "rg.fa"), "1", ref_g)
    write_fasta(os.path.join(root, "ag.fa"), "1", anc_g)
    write_fasta(os.path.join(root, "mask.fa"), "1",
                "".join(np.where(g.random(span) < 0.1, "N", "P")))
    make_vcf_for_preprocess(os.path.join(root, "ref.bcf"), "1", mt, ref_g, anc_g, seed=177)
    argv = ["--mode", "preprocess_mut", "--anc", os.path.join(root, "pp_chr1.anc"),
            "--mut", os.path.join(root, "pp_chr1.mut"), "--reference_bcf",
            os.path.join(root, "ref.bcf"), "--ref_genome", os.path.join(root, "rg.fa"),
            "--anc_genome", os.path.join(root, "ag.fa"), "--mask", os.path.join(root, "mask.fa")]
    a, b = _both(tmp_path, capsys, argv, "")
    with open(b) as fh:
        assert len(fh.read().splitlines()) > 100
    assert _same(a, b)


@pytest.mark.parametrize("mode", ["calc_depth", "get_deam"])
def test_bam_stats(fix, tmp_path, capsys, mode):
    argv = ["--mode", mode, "--target_bam", fix["target_bam"], "--ref_genome", fix["rg_prefix"],
            "--chr", fix["chrfile"]]
    a, b = _both(tmp_path, capsys, argv, "")
    with open(b) as fh:
        text = fh.read()
    assert len(text.splitlines()) == (1 if mode == "calc_depth" else 31)
    assert float(text.split()[0 if mode == "calc_depth" else 6]) > 0
    assert _same(a, b)


def test_host_modes_need_no_card(fix, tmp_path, monkeypatch):
    """make_tmp runs under the default --torch_device cuda on a machine
    without a card; mode mut there raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--mut", fix["mut_prefix"], "--ref_genome", fix["rg_prefix"], "--chr", fix["chrfile"]]
    assert cli.main(["--mode", "make_tmp", "--target_bam", fix["target_bam"], *argv,
                     "-o", str(tmp_path / "t")]) == 0
    assert os.path.getsize(str(tmp_path / "t.colate.in")) > 1000
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode", "mut", "--target_bam", fix["target_bam"], "--reference_bam",
                  fix["reference_bam"], "--bins", "3,7,0.2", *argv, "-o", str(tmp_path / "m")])


# ---- the input generators ----------------------------------------------------

@pytest.mark.parametrize("what", ["vcf", "bcf2", "bam"])
def test_generators_write_the_reference_bytes(tmp_path, what):
    """make_vcf_for_mut, vcf_text_to_bcf2 and make_bam write the bytes of
    tests/helpers/synth_vcf.py, synth_bcf.py and synth_bam.py."""
    from colate_tpu_torch import fixtures
    from helpers import synth_bam, synth_bcf, synth_vcf
    from helpers.synth import make_mut as ref_make_mut

    mt = ref_make_mut(str(tmp_path / "m_chr1.mut"), 300, seed=4, chrom_span=20_000)
    rg = synth_vcf.make_ref_genome(20_010, mt, seed=5)
    assert rg == fixtures.make_ref_genome(20_010, mt, seed=5)
    a, b = str(tmp_path / "ours"), str(tmp_path / "ref")
    if what == "bam":
        contigs = {"1": rg, "2": rg[:5000]}
        fixtures.make_bam(a, contigs, seed=3, reads_per_contig=300)
        synth_bam.make_bam(b, contigs, seed=3, reads_per_contig=300)
    else:
        args = ("1", mt, rg)
        fixtures.make_vcf_for_mut(a, *args, seed=6, n_samples=4)
        synth_vcf.make_vcf_for_mut(b, *args, seed=6, n_samples=4)
        if what == "bcf2":
            fixtures.vcf_text_to_bcf2(a, a + ".bcf")
            synth_bcf.vcf_text_to_bcf2(b, b + ".bcf")
            a, b = a + ".bcf", b + ".bcf"
    assert os.path.getsize(a) > 1000 and _same(a, b)


def test_gen_bam_writes_the_tool_bytes(tmp_path):
    """fixtures.gen_bam at seed 7 writes tools/bench_bam_stream.py's bytes."""
    from colate_tpu_torch.fixtures import gen_bam

    spec = importlib.util.spec_from_file_location(
        "bench_bam_stream", os.path.join(REPO, "tools", "bench_bam_stream.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ref = np.random.default_rng(1).choice(np.frombuffer(b"ACGT", np.uint8), 60_000)
    gen_bam(str(tmp_path / "ours.bam"), ref, 4000, "1")
    tool.gen_bam(str(tmp_path / "tool.bam"), ref, 4000, "1")
    assert _same(str(tmp_path / "ours.bam"), str(tmp_path / "tool.bam"))


def test_write_bcf_is_vcf_text_to_bcf2(tmp_path):
    """The vectorised write_bcf writes vcf_text_to_bcf2's bytes for the same
    records (an ALT-less record and a missing call among them), and the
    native decoder reads its genotypes back."""
    from colate_tpu_torch.fixtures import (
        bcf_genotypes, make_mut, vcf_text_to_bcf2, write_bcf,
    )
    from colate_tpu_torch.formats.vcf import read_vcf

    load_native()
    mt = make_mut(str(tmp_path / "m.mut"), 400, seed=8, chrom_span=50_000)
    pos, ref, alt, gt = bcf_genotypes(mt, 3, seed=2)
    alt[0] = 0
    gt[1, 0] = -1
    write_bcf(str(tmp_path / "fast.bcf"), "7", pos, ref, alt, gt)
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=7>",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\tS1\tS2"]
    call = lambda x: "." if x < 0 else str(x)
    for i in range(pos.size):
        gts = [f"{call(gt[i, 2 * k])}|{call(gt[i, 2 * k + 1])}" for k in range(3)]
        lines.append(f"7\t{pos[i]}\t.\t{chr(ref[i])}\t{chr(alt[i]) if alt[i] else '.'}\t.\tPASS\t.\t"
                     f"GT\t" + "\t".join(gts))
    with open(tmp_path / "t.vcf", "w") as fh:
        fh.write("\n".join(lines) + "\n")
    vcf_text_to_bcf2(str(tmp_path / "t.vcf"), str(tmp_path / "slow.bcf"))
    assert _same(str(tmp_path / "fast.bcf"), str(tmp_path / "slow.bcf"))
    back = read_vcf(str(tmp_path / "fast.bcf"))
    np.testing.assert_array_equal(back.gt, gt)
    np.testing.assert_array_equal(back.pos, pos)
    assert back.alt[0] == "" and back.alt[1] == chr(alt[1])
