"""Mode ``mut`` on BCF and BAM/CRAM inputs through the port against
colate_tpu, on the CPU.

The inputs are colate_tpu_torch.fixtures.make_bcf_bam_fixture's (the
scale of tests/test_mut_bam.py: two contigs of 800 dirty ``.mut`` rows,
6,000 reads a contig), one per input kind: ``--target_bcf`` with and
without ``--reference_bcf``, ``--target_bam`` with ``--reference_bcf``
(one BAM, and one a chromosome under ``--per_chr_bam``) and with
``--reference_bam``.  The readers and the five joins are the JAX
package's host code copied, so their columns and sites must be equal;
the ``.coal`` and ``.colate_mat`` of mode mut byte-identical under
``--sampling mc_parity --em_dtype float64`` and under analytic sampling
with the host EM; under ``--binning device`` (the binning kernel's plain
torch version) the histograms within 2e-5 of the native binning's max
(tests/test_bin_pallas.py's bound) and the rates in tests/test_em_f32.py's
tiers.  ``--devices 2 --binning sharded`` writes the bytes of one
device's ``--binning device --em_dtype float64`` run, and
``--checkpoint`` those of ``python -m colate_tpu --checkpoint``.
"""

import contextlib
import filecmp
import io
import os

import numpy as np
import pytest
import torch

from colate_tpu import cli as jax_cli
from colate_tpu.formats.coal import CoalFile
from colate_tpu_torch import cli
from test_cram import cram_fix  # noqa: F401  (a fixture)
from test_torch_mut import load_native

# small tensors: one intra-op thread per test process (see test_torch_mut.py)
torch.set_num_threads(1)

KINDS = ("bcf_bcf", "bcf_split", "bam_bcf", "bam_bcf_per_chr", "bam_bam")


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    from colate_tpu_torch.fixtures import make_bcf_bam_fixture

    load_native()
    return make_bcf_bam_fixture(str(tmp_path_factory.mktemp("bcfbam")))


def _argv(fix, kind, out, *extra, bins="3,7,0.2", B=4):
    return ["--mode", "mut", "--mut", fix["mut_prefix"], "--chr", fix["chrfile"], "--bins", bins,
            "--seed", "43", "--num_bootstraps", str(B), *fix["inputs"][kind], "-o", out, *extra]


def _configs(fix, kind, *extra):
    """The port's and the reference's MutRunConfig of one input kind."""
    from colate_tpu.config import MutRunConfig as JaxConfig

    cfg = cli.mut_config(cli.build_parser().parse_args(_argv(fix, kind, os.devnull, *extra)))
    return cfg, JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _same(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


def _quiet(fn, *a):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*a)


# ---- readers -----------------------------------------------------------------

@pytest.mark.parametrize("encoding", ["text", "bcf2"])
def test_read_vcf_columns(fix, encoding):
    """read_vcf gives the reference's columns on text VCF (under a .bcf
    name: the native decoder answers not-bcf) and on BCF2, and the two
    encodings of one file give equal columns."""
    from colate_tpu.formats.vcf import read_vcf as jax_read_vcf
    from colate_tpu_torch.formats.vcf import read_vcf

    for c in fix["chroms"]:
        text = f"{fix['rvcf_prefix']}_chr{c}.bcf"
        path = text if encoding == "text" else f"{fix['rbcf_prefix']}_chr{c}.bcf"
        ours, ref, plain = read_vcf(path), jax_read_vcf(path), read_vcf(text)
        assert len(ours) > 500 and ours.gt.shape[1] == 12
        for other in (ref, plain):
            for name in ("chrom", "pos", "ref", "alt", "n_allele", "gt"):
                np.testing.assert_array_equal(getattr(ours, name), getattr(other, name), name)
            assert (ours.n_samples, ours.ploidy) == (other.n_samples, other.ploidy)


def _write_sam(bam: str, sam: str) -> None:
    """SAM text of a BAM file's records, as read_bam decodes them."""
    from colate_tpu_torch.formats.bam import read_bam

    rec = read_bam(bam)
    with open(sam, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for i in range(len(rec)):
            q = (np.asarray(rec.qual[i], np.uint8) + 33).tobytes().decode()
            fh.write(f"r{i}\t{rec.flag[i]}\t{rec.contig[i]}\t{rec.pos[i] + 1}\t{rec.mapq[i]}\t"
                     f"{len(rec.seq[i])}M\t*\t0\t0\t{rec.seq[i]}\t{q}\n")


@pytest.mark.parametrize("encoding", ["bam", "sam"])
def test_open_pileup_counts(fix, tmp_path, encoding):
    """open_pileup streams BAM through the native pileup and SAM text
    through BamCursor; both give the reference's claims, counts and
    coverages at every .mut position of both contigs."""
    from colate_tpu.models.bam_pileup import open_pileup as jax_open
    from colate_tpu_torch.models.bam_pileup import BamCursor, NativeBamPileup, open_pileup

    path = fix["target_bam"]
    if encoding == "sam":
        path = str(tmp_path / "target.sam")
        _write_sam(fix["target_bam"], path)
    ours = open_pileup(path)
    assert isinstance(ours, BamCursor if encoding == "sam" else NativeBamPileup)
    ref = jax_open(fix["target_bam"])
    from colate_tpu_torch.formats.mut import MutTable

    for c in fix["chroms"]:
        q = MutTable.read(f"{fix['mut_prefix']}_chr{c}.mut").pos - 1
        a = ours.contig_counts(c, f"{fix['rg_prefix']}_chr{c}.fa", None, q)
        b = ref.contig_counts(c, f"{fix['rg_prefix']}_chr{c}.fa", None, q)
        assert a[0].sum() > 100
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_native_failure_raises(fix, monkeypatch):
    """With the native library failing to load, read_vcf on BCF2 (and on
    text VCF: the parser is chosen by the native answer, not the name) and
    open_pileup on BAM raise instead of falling back to Python decoders."""
    from colate_tpu_torch import native
    from colate_tpu_torch.formats.vcf import read_vcf
    from colate_tpu_torch.models.bam_pileup import open_pileup

    def broken(so=None):
        raise RuntimeError("native library failed to build or load: (test)")

    monkeypatch.setattr(native, "load", broken)
    for call in (lambda: read_vcf(f"{fix['rbcf_prefix']}_chr1.bcf"),
                 lambda: read_vcf(f"{fix['rvcf_prefix']}_chr1.bcf"),
                 lambda: open_pileup(fix["target_bam"])):
        with pytest.raises(RuntimeError, match="native library failed"):
            call()


@pytest.mark.parametrize("case", ["missing", "bad-cram"])
def test_open_pileup_raises_with_the_native_message(tmp_path, case):
    """A null native handle other than "not a BAM file" raises with the
    native message: a file that cannot be opened, a malformed CRAM."""
    from colate_tpu_torch.models.bam_pileup import open_pileup

    path = str(tmp_path / "x.cram")
    if case == "missing":
        with pytest.raises(FileNotFoundError, match="cannot open"):
            open_pileup(path)
        return
    with open(path, "wb") as fh:
        fh.write(b"CRAM\x03\x00" + bytes(64))
    with pytest.raises(ValueError, match=r"x\.cram: \S"):
        open_pileup(path)


@pytest.mark.parametrize("tag", ["cram", "cram21"])
def test_cram_matches_bam(cram_fix, tag):
    """CRAM 3.0 and 2.1 conversions of a BAM (tests/test_cram.py's fixture,
    made with the reference's htslib; it skips without that tool) give the
    BAM's claims, counts and coverages through the port's open_pileup."""
    from colate_tpu_torch.models.bam_pileup import NativeBamPileup, open_pileup

    for contig in cram_fix["contigs"]:
        L = 40000 if contig == "1" else 25000
        q = np.sort(np.random.default_rng(5).choice(L, 3000, replace=False)).astype(np.int64)
        ref = os.path.join(cram_fix["root"], f"ref_{contig}.fa")
        got = []
        for path in (cram_fix[tag], cram_fix["bam"]):
            p = open_pileup(path)
            assert isinstance(p, NativeBamPileup)
            got.append(p.contig_counts(contig, ref, None, q))
            p.close()
        assert got[0][1].sum() > 0
        for x, y in zip(*got):
            np.testing.assert_array_equal(x, y)


# ---- joins ---------------------------------------------------------------------

def _join(fix, kind, pkg):
    """The JoinedSites of one input kind through ``pkg``'s join functions."""
    import importlib

    jv = importlib.import_module(f"{pkg}.pipeline.join_vcf")
    jb = importlib.import_module(f"{pkg}.pipeline.join_bam")
    MT = importlib.import_module(f"{pkg}.hostrng").MT19937
    cs = fix["chroms"]
    per = lambda prefix, ext: [f"{prefix}_chr{c}{ext}" for c in cs]
    muts, rg = per(fix["mut_prefix"], ".mut"), per(fix["rg_prefix"], ".fa")
    mask = per(fix["mask_prefix"], ".fa")
    calls = {
        "bcf_bcf": lambda: jv.join_vcfvcf(cs, muts, per(fix["tbcf_prefix"], ".bcf"),
                                          per(fix["rbcf_prefix"], ".bcf"), mask, None, rg),
        "bcf_split": lambda: jv.join_vcf_split(cs, muts, per(fix["rbcf_prefix"], ".bcf"), None,
                                               rg, MT(43)),
        "bam_bcf": lambda: jb.join_onebamvcf(cs, muts, fix["target_bam"],
                                             per(fix["rbcf_prefix"], ".bcf"), None, None, rg),
        "bam_bcf_per_chr": lambda: jb.join_bamvcf(cs, muts, per(fix["target_bam"][:-4], ".bam"),
                                                  per(fix["rbcf_prefix"], ".bcf"), None, None, rg),
        "bam_bam": lambda: jb.join_onebambam(cs, muts, fix["target_bam"], fix["reference_bam"],
                                             None, mask, rg),
    }
    return _quiet(calls[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_join_matches_the_reference(fix, kind):
    """Each of the five joins gives the reference join's sites exactly."""
    ours, ref = _join(fix, kind, "colate_tpu_torch"), _join(fix, kind, "colate_tpu")
    assert len(ours) > 200 and ours.num_blocks == ref.num_blocks
    for name in ("age_begin", "age_end", "w_shared", "w_notshared", "block_id",
                 "w_shared_mc", "w_notshared_mc"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a, b), name


def test_per_chr_bam_join_equals_the_one_bam_join(fix):
    """parse_bamvcf on a contig split of the BAM gives parse_onebamvcf's
    sites (tests/test_mut_bam.py pins the same in the reference)."""
    one, per = _join(fix, "bam_bcf", "colate_tpu_torch"), _join(fix, "bam_bcf_per_chr", "colate_tpu_torch")
    for name in ("age_begin", "age_end", "w_shared", "w_notshared", "block_id"):
        assert np.array_equal(getattr(one, name), getattr(per, name)), name


# ---- mode mut ------------------------------------------------------------------

@pytest.mark.parametrize("sampling", ["mc_parity", "analytic"])
@pytest.mark.parametrize("kind", KINDS)
def test_mut_bytes_match_the_reference(fix, tmp_path, capsys, kind, sampling):
    """.coal and .colate_mat byte-identical to python -m colate_tpu: the
    draw replay with the f64 EM, and analytic sampling with the host EM."""
    extra = ("--sampling", "mc_parity", "--em_dtype", "float64") if sampling == "mc_parity" else ()
    ref, ours = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(_argv(fix, kind, ref, *extra)) == 0
    capsys.readouterr()
    assert cli.main(_argv(fix, kind, ours, *extra, "--torch_device", "cpu")) == 0
    err = capsys.readouterr().err
    provider = "torch:float64(cpu)" if sampling == "mc_parity" else "native"
    binning = "mc_parity(host)" if sampling == "mc_parity" else "native"
    assert f"provider={provider} " in err and f"binning={binning} " in err
    assert _same(ref + ".coal", ours + ".coal")
    assert _same(ref + ".colate_mat", ours + ".colate_mat")


@pytest.mark.parametrize("kind", KINDS)
def test_device_binning_within_tolerance(fix, tmp_path, capsys, kind):
    """--binning device bins with the kernel's plain torch version: the
    histograms within 2e-5 of the reference's device binning (XLA on the
    CPU), the .coal's rates in the f32 tiers of the reference's run under
    --binning device.  (Not against the native binning: it clips each
    bin's net mass at 0, io.cpp:1076-1077, and missing genotypes give
    these BCF inputs negative weights; ROADMAP queue 3.)"""
    from colate_tpu.models import mut_em as jax_mut
    from colate_tpu_torch.fixtures import hist_rel
    from colate_tpu_torch.models import mut_em

    cfg, jcfg = _configs(fix, kind, "--binning", "device")
    ours = mut_em.compute_suffstats(cfg, *mut_em.resolve_tmp_inputs(cfg), 0.0, 0.0, False,
                                    None, 43, {}, "cpu")
    ref = _quiet(jax_mut.compute_suffstats, jcfg, *jax_mut.resolve_tmp_inputs(jcfg), 0.0, 0.0,
                 False, None, 43, {})
    assert ours[4:] == ref[4:] and ours[4] > 200
    assert hist_rel(list(ours[:4]), [np.asarray(h, np.float64) for h in ref[:4]]) <= 2e-5
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(_argv(fix, kind, a, "--binning", "device", B=8)) == 0
    capsys.readouterr()
    assert cli.main(_argv(fix, kind, b, "--binning", "device", "--torch_device", "cpu", B=8)) == 0
    assert "binning=torch-twin:float32(cpu) " in capsys.readouterr().err
    ra, rb = CoalFile.read(a + ".coal").rates, CoalFile.read(b + ".coal").rates
    rel = np.abs(rb - ra) / np.maximum(np.abs(ra), 1e-300)
    assert (ra >= 1e-4).sum() >= 4, "fixture must have identified epochs"
    assert rel[ra >= 1e-4].max() <= 1e-4
    assert rel[ra >= 1e-6].max() <= 2e-2
    np.testing.assert_array_equal(ra == 0.0, rb == 0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_devices_and_checkpoint_bytes(fix, tmp_path, capsys, kind):
    """--devices 2 --binning sharded writes the bytes of a one-device
    --binning device --em_dtype float64 run; --checkpoint writes
    python -m colate_tpu --checkpoint's bytes, and so do reruns of both,
    which read their .colate_mat caches."""
    run = lambda out, *extra: cli.main(_argv(fix, kind, str(tmp_path / out), *extra,
                                             "--torch_device", "cpu", bins="3,7,0.5", B=2))
    assert run("d2", "--devices", "2", "--binning", "sharded") == 0
    assert run("one", "--binning", "device", "--em_dtype", "float64") == 0
    assert "provider=mesh[2]:torch:float64(cpu) " in capsys.readouterr().err
    for ext in (".coal", ".colate_mat"):
        assert _same(str(tmp_path / ("d2" + ext)), str(tmp_path / ("one" + ext)))
    assert jax_cli.main(_argv(fix, kind, str(tmp_path / "jck"), "--checkpoint", bins="3,7,0.5",
                              B=2)) == 0
    assert run("ck", "--checkpoint") == 0
    assert "(checkpointed) " in capsys.readouterr().err
    for ext in (".coal", ".colate_mat"):
        assert _same(str(tmp_path / ("jck" + ext)), str(tmp_path / ("ck" + ext)))
    # the reruns read the .colate_mat each wrote (counts printed to 6 digits)
    assert jax_cli.main(_argv(fix, kind, str(tmp_path / "jck"), "--checkpoint", bins="3,7,0.5",
                              B=2)) == 0
    capsys.readouterr()
    assert run("ck", "--checkpoint") == 0
    assert "binning=colate_mat " in capsys.readouterr().err
    assert _same(str(tmp_path / "jck.coal"), str(tmp_path / "ck.coal"))


@pytest.mark.parametrize("kind", ["bcf_bcf", "bam_bcf", "bam_bam", "bcf_split"])
def test_two_ranks_write_the_single_process_bytes(fix, tmp_path, kind):
    """--coordinator with 2 ranks (a chromosome each, gloo): rank 0 writes
    the single-process .coal and .colate_mat; the single BCF is refused, as
    the reference refuses it (its split draws one stream across
    chromosomes)."""
    import sys

    from test_torch_multihost import _free_port, _ranks

    multi, single = str(tmp_path / "multi"), str(tmp_path / "single")
    argv = _argv(fix, kind, multi, "--torch_device", "cpu", bins="3,7,0.5", B=2)
    port = _free_port()
    cmd = lambda i: [sys.executable, "-m", "colate_tpu_torch", *argv, "--coordinator",
                     f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i)]
    if kind == "bcf_split":
        from colate_tpu_torch.parallel.multihost import run_mut_multihost

        with pytest.raises(ValueError, match="half-split"):
            run_mut_multihost(cli.mut_config(cli.build_parser().parse_args(argv)), "cpu")
        return
    _ranks(cmd, 2)
    assert cli.main(_argv(fix, kind, single, "--torch_device", "cpu", bins="3,7,0.5", B=2)) == 0
    for ext in (".coal", ".colate_mat"):
        assert _same(single + ext, multi + ext)


@pytest.mark.parametrize("case", ["target_bam without --ref_genome", "no inputs"])
def test_mut_input_errors(fix, tmp_path, capsys, case):
    """The reference's ValueErrors, as an error block and exit 1."""
    argv = ["--mode", "mut", "--mut", fix["mut_prefix"], "--chr", fix["chrfile"], "--bins",
            "3,7,0.2", "-o", str(tmp_path / "x"), "--torch_device", "cpu"]
    if case.startswith("target_bam"):
        argv += ["--target_bam", fix["target_bam"], "--reference_bam", fix["reference_bam"]]
        msg = "requires --ref_genome"
    else:
        msg = "mode mut needs"
    assert cli.main(argv) == 1
    assert msg in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "x.coal"))


# ---- the emp sites of the joins (ROADMAP queue 3) ------------------------------

@pytest.mark.parametrize("kind", KINDS + ("tmp",))
def test_joins_emit_no_zero_width_sites(fix, tmp_path, capsys, kind):
    """Over the dirty fixtures (inverted and zero ages among the .mut
    rows), every site the five joins and the .colate.in join emit has
    age_end > age_begin, so the native binning (which skips zero-width emp
    sites) and the device binning agree on them; and the .colate_mat under
    --binning auto equals the one under native."""
    from colate_tpu_torch.fixtures import hist_rel, make_fixture
    from colate_tpu_torch.models.mut_em import join_inputs
    from colate_tpu_torch.pipeline.binning import bin_sites_analytic, bin_sites_analytic_native
    from colate_tpu_torch.pipeline.join import JoinedSites

    if kind == "tmp":
        tmp = make_fixture(str(tmp_path / "tmp"), n_per_chrom=1500, seed=5)
        argv = ["--mode", "mut", "--mut", tmp["mut_prefix"], "--chr", tmp["chrfile"], "--bins",
                "3,7,0.2", "--seed", "43", "--target_tmp", tmp["target"], "--reference_tmp",
                tmp["reference"]]
    else:
        argv = _argv(fix, kind, os.devnull)[:-2]
    cfg = cli.mut_config(cli.build_parser().parse_args(argv + ["-o", os.devnull]))
    sites = _quiet(join_inputs, cfg)
    assert len(sites) > 200
    assert (sites.age_end > sites.age_begin).all()
    assert (sites.age_begin == 0).sum() > 20, "the fixture must carry emp sites"
    # sites of non-negative weight (missing genotypes make some negative;
    # the native binning clips a bin's net mass at 0: ROADMAP queue 3)
    keep = (sites.w_shared >= 0) & (sites.w_notshared >= 0)
    sites = JoinedSites(age_begin=sites.age_begin[keep], age_end=sites.age_end[keep],
                        w_shared=sites.w_shared[keep], w_notshared=sites.w_notshared[keep],
                        block_id=sites.block_id[keep], num_blocks=sites.num_blocks)
    native = bin_sites_analytic_native(sites)
    assert hist_rel(list(bin_sites_analytic(sites, 0.0, "cpu")), list(native)) <= 2e-5
    if kind != "tmp":
        for binning in ("auto", "native"):
            assert cli.main(argv + ["--binning", binning, "--torch_device", "cpu", "-o",
                                    str(tmp_path / binning)]) == 0
        assert _same(str(tmp_path / "auto.colate_mat"), str(tmp_path / "native.colate_mat"))
