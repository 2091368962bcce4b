"""The port's analytic binning against colate_tpu's, on the CPU.

``colate_tpu_torch.pipeline.binning.bin_sites_analytic`` bins through the
CUDA kernel's plain torch version here (CPU tensors).  It is held against
the three binnings of the reference, which compute the same expectation of
the reference's 100-draw Monte Carlo binning (coal.cpp:2244-2298): the
Pallas kernel in interpret mode and the XLA program, both float32 per
site, within 2e-5 of each histogram's max (tests/test_bin_pallas.py's
bound), and the native float64 ``cn_bin_analytic`` within 5e-5.  Then
mode ``mut --binning device|sharded`` through both CLIs.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from colate_tpu import cli as jax_cli
from colate_tpu.formats.coal import CoalFile
from colate_tpu.ops.bin_pallas import bin_sites_pallas
from colate_tpu.pipeline import binning as jax_binning
from colate_tpu.pipeline.join import JoinedSites
from colate_tpu_torch import cli
from colate_tpu_torch.ops import bin_kernel
from colate_tpu_torch.pipeline.binning import bin_sites_analytic
from helpers.sites import beyond_table_sites, hist_rel, synthetic_sites
from test_torch_mut import load_native

# tensors here are small: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def native_lib():
    return load_native()


CASES = {
    "sorted-20000-7": dict(),
    "unsorted-4000": dict(n=4000, sorted_blocks=False),
    "sorted-30000-125": dict(n=30000, nb=125, seed=3),
    "age30": dict(age=30.0, seed=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_pallas_kernel(case):
    kw = CASES[case]
    sites, age = synthetic_sites(**kw), kw.get("age", 0.0)
    ref = bin_sites_pallas(sites, age, interpret=True)
    assert ref is not None
    assert hist_rel(bin_sites_analytic(sites, age), ref) <= 2e-5


@pytest.mark.parametrize("case", [*CASES, "sorted-20000-3000"])
def test_matches_xla_and_native(case, native_lib):
    """3,000 blocks lie beyond the TPU kernel's accumulator ladder
    (``_nb_cap(3000) is None``), so only XLA and native hold them."""
    kw = CASES.get(case, dict(n=20000, nb=3000, seed=4))
    sites, age = synthetic_sites(**kw), kw.get("age", 0.0)
    ours = bin_sites_analytic(sites, age)
    assert hist_rel(ours, jax_binning.bin_sites_analytic(sites, age)) <= 2e-5
    assert hist_rel(ours, jax_binning.bin_sites_analytic_native(sites, age)) <= 5e-5


def test_ages_beyond_the_table(native_lib):
    """Emp sites put the mass beyond the table into the last bin; regular
    sites beyond it have no in-table overlap and bin nothing."""
    sites = beyond_table_sites()
    ours = bin_sites_analytic(sites)
    assert ours[1][:, -1].min() > 0
    assert hist_rel(ours, bin_sites_pallas(sites, interpret=True)) <= 2e-5
    assert hist_rel(ours, jax_binning.bin_sites_analytic(sites)) <= 2e-5
    assert hist_rel(ours, jax_binning.bin_sites_analytic_native(sites)) <= 5e-5


def test_split_at_a_block_boundary_is_bitwise():
    sites = synthetic_sites(n=9000, nb=9, seed=7)
    whole = bin_sites_analytic(sites)
    cut = int(np.searchsorted(sites.block_id, 5))
    parts = []
    for lo, hi in ((0, cut), (cut, len(sites))):
        parts.append(bin_sites_analytic(JoinedSites(
            age_begin=sites.age_begin[lo:hi], age_end=sites.age_end[lo:hi],
            w_shared=sites.w_shared[lo:hi], w_notshared=sites.w_notshared[lo:hi],
            block_id=sites.block_id[lo:hi], num_blocks=sites.num_blocks,
        )))
    for w, a, b in zip(whole, *parts):
        np.testing.assert_array_equal(w, a + b)


def test_empty_and_tiny():
    empty = synthetic_sites(n=0, nb=0)
    for h in bin_sites_analytic(empty):
        assert h.shape == (0, 185)
    tiny = synthetic_sites(n=3, nb=1, seed=5)
    for a, b in zip(bin_sites_analytic(tiny), jax_binning.bin_sites_analytic(tiny)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_past_max_blocks_raises_like_the_reference():
    sites = synthetic_sites(n=10, nb=jax_binning.MAX_BLOCKS + 1)
    with pytest.raises(ValueError, match="exceeds MAX_BLOCKS") as ours:
        bin_sites_analytic(sites)
    with pytest.raises(ValueError, match="exceeds MAX_BLOCKS") as ref:
        jax_binning.bin_sites_analytic(sites)
    assert str(ours.value) == str(ref.value)


def test_packing_is_block_aligned():
    """Unsorted ids restart a chunk at every id change: every chunk holds
    one block's sites, padded with zero-weight regular lanes."""
    sites = synthetic_sites(n=4000, sorted_blocks=False)
    p = bin_kernel.pack_sites(sites)
    C = bin_kernel.CHUNK
    blk = np.asarray(sites.block_id)
    runs = np.flatnonzero(np.diff(blk)) + 1
    assert p.n_chunks == runs.size + 1 and p.fv.shape == (4, p.n_chunks * C)
    n = p.chunk_n.numpy()
    assert n.sum() == len(sites) and (n >= 1).all() and (n <= C).all()
    np.testing.assert_array_equal(p.chunk_blk.numpy(), blk[np.concatenate([[0], runs])])
    lane = np.arange(C)[None, :]
    pad = (lane >= n[:, None]).ravel()
    fv = p.fv.numpy()
    assert (fv[0, pad] == 1.0).all() and (fv[1, pad] == 2.0).all() and (fv[2:, pad] == 0).all()
    assert (p.meta.numpy()[pad] == 0).all()
    np.testing.assert_array_equal(fv[2, ~pad], sites.w_shared.astype(np.float32))
    emp = (p.meta.numpy()[~pad] & bin_kernel.EMP) != 0
    np.testing.assert_array_equal(emp, sites.age_begin <= 0.0)
    off = p.block_off.numpy()
    for b in range(sites.num_blocks):
        chunks = p.block_chunks.numpy()[off[b] : off[b + 1]]
        assert (np.diff(chunks) > 0).all() and (p.chunk_blk.numpy()[chunks] == b).all()


def test_hist_rel():
    a = [np.full((2, 185), 4.0) for _ in range(4)]
    b = [x.copy() for x in a]
    b[2][1, 7] = 2.0
    assert hist_rel(a, b) == 0.5
    assert hist_rel([np.zeros((0, 185))] * 4, [np.zeros((0, 185))] * 4) == 0.0
    with pytest.raises(ValueError, match="histograms"):
        hist_rel(a, [x[:1] for x in b])
    with pytest.raises(ValueError, match="histograms"):
        hist_rel(a, [x.astype(np.float32) for x in b])


def test_no_kernel_for_another_device():
    packed = bin_kernel.pack_sites(synthetic_sites(n=100, nb=2)).to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bin_kernel.bin_chunks(packed)


# ---- mode mut --binning device|sharded through the CLIs ----


@pytest.fixture(scope="module")
def fix(tmp_path_factory, native_lib):
    from helpers.synth import make_fixture

    return make_fixture(str(tmp_path_factory.mktemp("torchbin")), n_per_chrom=3000, seed=5)


def _argv(fix, out, *extra):
    return [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", "3,7,0.2", "--seed", "3",
        "--em_dtype", "float64", "--num_bootstraps", "8", "-o", out, *extra,
    ]


def _port(fix, out, capsys, *extra):
    capsys.readouterr()
    assert cli.main(_argv(fix, out, "--torch_device", "cpu", *extra)) == 0
    return out + ".coal", capsys.readouterr().err


def test_mut_binning_device_against_the_reference(fix, tmp_path, capsys):
    """Identified rates (>= 1e-4) within 1e-4 and weak ones (>= 1e-6)
    within 1e-3 of the reference's ``.coal``: the two bin in float32 with
    another order of sums, and the EM (float64 in both) carries that
    difference into weakly identified rates."""
    ref = str(tmp_path / "jax")
    assert jax_cli.main(_argv(fix, ref, "--binning", "device")) == 0
    ours, err = _port(fix, str(tmp_path / "torch"), capsys, "--binning", "device")
    assert "binning=torch-twin:float32(cpu) " in err
    a = CoalFile.read(ref + ".coal").rates
    b = CoalFile.read(ours).rates
    assert a.shape == b.shape == (8, 23)
    rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-300)
    assert (a >= 1e-4).sum() >= 4, "fixture must have identified epochs"
    assert rel[a >= 1e-4].max() <= 1e-4
    assert rel[a >= 1e-6].max() <= 1e-3
    np.testing.assert_array_equal(a == 0.0, b == 0.0)


def test_mut_binning_sharded_writes_what_device_writes(fix, tmp_path, capsys):
    dev, _ = _port(fix, str(tmp_path / "device"), capsys, "--binning", "device")
    sh, err = _port(fix, str(tmp_path / "sharded"), capsys, "--binning", "sharded")
    assert "binning=torch-twin:float32(cpu) " in err
    assert filecmp.cmp(dev, sh, shallow=False)


def test_mut_binning_device_needs_no_native_library(fix, tmp_path, capsys, monkeypatch):
    """Device binning decodes and joins with colate_tpu's Python fallbacks
    when the native library is missing, and bins the same sites."""
    from colate_tpu import native

    with_lib, _ = _port(fix, str(tmp_path / "lib"), capsys, "--binning", "device")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    without, _ = _port(fix, str(tmp_path / "nolib"), capsys, "--binning", "device")
    assert filecmp.cmp(with_lib, without, shallow=False)


@pytest.mark.parametrize("binning", ["device", "sharded"])
def test_bcf_inputs_with_device_binning_exit_nonzero(tmp_path, capsys, binning):
    out = str(tmp_path / "x")
    argv = [
        "--mode", "mut", "--mut", str(tmp_path / "m"), "--target_bcf", str(tmp_path / "t"),
        "--reference_bcf", str(tmp_path / "r"), "--bins", "3,7,0.2", "--binning", binning,
        "--torch_device", "cpu", "-o", out,
    ]
    assert cli.main(argv) != 0
    assert "ROADMAP" in capsys.readouterr().err
    assert not os.path.exists(out + ".coal")
