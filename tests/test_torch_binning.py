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
from colate_tpu.config import bin_of_age
from colate_tpu.formats.coal import CoalFile
from colate_tpu.ops.bin_pallas import bin_sites_pallas
from colate_tpu.pipeline import binning as jax_binning
from colate_tpu_torch import cli
from colate_tpu_torch.fixtures import beyond_table_sites, hist_rel, synthetic_sites
from colate_tpu_torch.ops import bin_kernel
from colate_tpu_torch.pipeline.binning import MAX_BLOCKS, bin_sites_analytic
from colate_tpu_torch.pipeline.join import JoinedSites
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
    assert hist_rel(bin_sites_analytic(sites, age, "cpu"), ref) <= 2e-5


@pytest.mark.parametrize("case", [*CASES, "sorted-20000-3000"])
def test_matches_xla_and_native(case, native_lib):
    """3,000 blocks lie beyond the TPU kernel's accumulator ladder
    (``_nb_cap(3000) is None``), so only XLA and native hold them."""
    kw = CASES.get(case, dict(n=20000, nb=3000, seed=4))
    sites, age = synthetic_sites(**kw), kw.get("age", 0.0)
    ours = bin_sites_analytic(sites, age, "cpu")
    assert hist_rel(ours, jax_binning.bin_sites_analytic(sites, age)) <= 2e-5
    assert hist_rel(ours, jax_binning.bin_sites_analytic_native(sites, age)) <= 5e-5


def test_ages_beyond_the_table(native_lib):
    """Emp sites put the mass beyond the table into the last bin; regular
    sites beyond it have no in-table overlap and bin nothing."""
    sites = beyond_table_sites()
    ours = bin_sites_analytic(sites, 0.0, "cpu")
    assert ours[1][:, -1].min() > 0
    assert hist_rel(ours, bin_sites_pallas(sites, interpret=True)) <= 2e-5
    assert hist_rel(ours, jax_binning.bin_sites_analytic(sites)) <= 2e-5
    assert hist_rel(ours, jax_binning.bin_sites_analytic_native(sites)) <= 5e-5


def test_split_at_a_block_boundary_is_bitwise():
    sites = synthetic_sites(n=9000, nb=9, seed=7)
    whole = bin_sites_analytic(sites, 0.0, "cpu")
    cut = int(np.searchsorted(sites.block_id, 5))
    parts = []
    for lo, hi in ((0, cut), (cut, len(sites))):
        parts.append(bin_sites_analytic(JoinedSites(
            age_begin=sites.age_begin[lo:hi], age_end=sites.age_end[lo:hi],
            w_shared=sites.w_shared[lo:hi], w_notshared=sites.w_notshared[lo:hi],
            block_id=sites.block_id[lo:hi], num_blocks=sites.num_blocks,
        ), 0.0, "cpu"))
    for w, a, b in zip(whole, *parts):
        np.testing.assert_array_equal(w, a + b)


def test_empty_and_tiny():
    empty = synthetic_sites(n=0, nb=0)
    for h in bin_sites_analytic(empty, 0.0, "cpu"):
        assert h.shape == (0, 185)
    tiny = synthetic_sites(n=3, nb=1, seed=5)
    for a, b in zip(bin_sites_analytic(tiny, 0.0, "cpu"), jax_binning.bin_sites_analytic(tiny)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_past_max_blocks_raises_like_the_reference():
    assert MAX_BLOCKS == jax_binning.MAX_BLOCKS
    sites = synthetic_sites(n=10, nb=MAX_BLOCKS + 1)
    with pytest.raises(ValueError, match="exceeds MAX_BLOCKS") as ours:
        bin_sites_analytic(sites, 0.0, "cpu")
    with pytest.raises(ValueError, match="exceeds MAX_BLOCKS") as ref:
        jax_binning.bin_sites_analytic(sites)
    assert str(ours.value) == str(ref.value)


def _check_chunk_table(blk, nb):
    """The chunk table covers every site once, in stream order; each chunk
    holds up to CHUNK sites of one run of one block, and the chunks
    restart at every run; each block's chunks are listed in stream order
    and cut into segments of SEG chunks (the last one shorter)."""
    C, S = bin_kernel.CHUNK, bin_kernel.SEG
    blk = np.asarray(blk)
    t = bin_kernel.chunk_table(blk, nb)
    start, cnt, cblk = t["chunk_start"], t["chunk_n"], t["chunk_blk"]
    assert start.dtype == np.int64 and cnt.dtype == cblk.dtype == np.int32
    assert cnt.sum() == blk.size and (cnt >= 1).all() and (cnt <= C).all()
    np.testing.assert_array_equal(start, np.cumsum(cnt) - cnt)
    np.testing.assert_array_equal(blk, np.repeat(cblk, cnt))
    runs = np.diff(np.flatnonzero(np.diff(blk, prepend=-1, append=-1)))
    assert cnt.size == (-(-runs // C)).sum()
    # a chunk is short only at the end of its run
    ends = start + cnt
    short = cnt < C
    assert (blk[ends[short & (ends < blk.size)]] != blk[ends[short & (ends < blk.size)] - 1]).all()

    bc, sf, bs = t["block_chunks"], t["seg_first"], t["block_seg"]
    assert bc.dtype == sf.dtype == bs.dtype == np.int32
    np.testing.assert_array_equal(np.sort(bc), np.arange(cnt.size))
    assert bs.shape == (nb + 1,) and bs[0] == 0 and sf[0] == 0 and sf[-1] == cnt.size
    assert bs[-1] == sf.size - 1
    off = np.concatenate([[0], np.cumsum(np.bincount(cblk, minlength=nb))])
    for b in range(nb):
        mine = bc[off[b] : off[b + 1]]
        assert (cblk[mine] == b).all() and (np.diff(mine) > 0).all()
        np.testing.assert_array_equal(sf[bs[b] : bs[b + 1] + 1],
                                      np.append(np.arange(off[b], off[b + 1], S), off[b + 1])
                                      if off[b + 1] > off[b] else [off[b]])
    return t


def test_packing_is_block_aligned():
    """The unpadded stream: the columns as float32 in stream order, the emp
    flag and bin in ``meta``, and a chunk table in which every chunk lies
    in one run of one block (unsorted ids restart a chunk at every id
    change)."""
    sites = synthetic_sites(n=4000, sorted_blocks=False)
    s = bin_kernel.site_stream(sites)
    assert s.fv.shape == (4, len(sites)) and s.meta.shape == (len(sites),)
    for row, col in enumerate((sites.age_begin, sites.age_end, sites.w_shared, sites.w_notshared)):
        np.testing.assert_array_equal(s.fv[row].numpy(), col.astype(np.float32))
    meta = s.meta.numpy()
    emp = (meta & bin_kernel.EMP) != 0
    np.testing.assert_array_equal(emp, sites.age_begin <= 0.0)
    assert (meta[~emp] == 0).all()
    ref = bin_of_age(sites.age_end[emp])
    np.testing.assert_array_equal(meta[emp] & (bin_kernel.EMP - 1), ref)
    t = _check_chunk_table(sites.block_id, sites.num_blocks)
    for name in bin_kernel.SiteStream.TABLE:
        np.testing.assert_array_equal(getattr(s, name).numpy(), t[name])
    assert s.n_chunks == np.count_nonzero(np.diff(sites.block_id)) + 1


CHUNK_TABLES = {  # name: (block ids, number of blocks)
    "no sites": (np.zeros(0, np.int32), 3),
    "one site": (np.array([2], np.int32), 4),
    "a block of exactly 512 sites": (np.repeat(np.arange(3, dtype=np.int32), [5, 512, 7]), 3),
    "a block of several segments": (np.repeat(np.arange(3, dtype=np.int32), [1, 512 * 16 * 3 + 5, 512 * 16]), 3),
    "3000 blocks": (np.sort(np.random.default_rng(4).integers(0, 3000, 20000)).astype(np.int32), 3000),
    "unsorted ids, blocks of several runs": (
        np.repeat(np.array([1, 0, 1, 2, 0, 1], np.int32), [700, 3, 512 * 17, 1, 1025, 9]), 4),
}


@pytest.mark.parametrize("name", list(CHUNK_TABLES))
def test_chunk_table_edge_cases(name):
    blk, nb = CHUNK_TABLES[name]
    t = _check_chunk_table(blk, nb)
    S = bin_kernel.SEG
    if name == "a block of several segments":  # 1, 49 and 16 chunks
        assert list(np.diff(t["block_seg"])) == [1, -(-49 // S), -(-16 // S)]
    if name == "unsorted ids, blocks of several runs":
        # block 0: 1 + 3 chunks; block 1: runs of 700, 512 * 17 and 9 sites, 2 + 17 + 1 chunks
        assert list(np.diff(t["block_seg"])) == [1, -(-20 // S), 1, 0]


def test_plain_version_reads_the_chunk_table():
    """The plain version bins what a chunk table hands it: a stream whose
    chunks are listed out of stream order bins as the ordered one."""
    sites = synthetic_sites(n=3000, nb=3, seed=2)
    s = bin_kernel.site_stream(sites)
    ref = bin_kernel.bin_chunks_reference(s)
    perm = torch.randperm(s.n_chunks, generator=torch.Generator().manual_seed(0))
    shuffled = bin_kernel.SiteStream(
        fv=s.fv, meta=s.meta, chunk_start=s.chunk_start[perm], chunk_n=s.chunk_n[perm],
        chunk_blk=s.chunk_blk[perm], block_chunks=s.block_chunks, seg_first=s.seg_first,
        block_seg=s.block_seg, num_blocks=s.num_blocks, age=s.age,
    )
    torch.testing.assert_close(bin_kernel.bin_chunks_reference(shuffled), ref, rtol=1e-12, atol=0)


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
    stream = bin_kernel.site_stream(synthetic_sites(n=100, nb=2)).to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bin_kernel.bin_chunks(stream)


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
    """The port's device binning needs nothing of colate_tpu's native
    library (the port decodes and joins with its own): with that library
    marked unavailable it writes the same bytes."""
    from colate_tpu import native

    with_lib, _ = _port(fix, str(tmp_path / "lib"), capsys, "--binning", "device")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    without, _ = _port(fix, str(tmp_path / "nolib"), capsys, "--binning", "device")
    assert filecmp.cmp(with_lib, without, shallow=False)


@pytest.mark.parametrize("binning", ["device", "sharded"])
def test_bcf_inputs_with_device_binning_exit_nonzero(tmp_path, capsys, binning):
    """BCF inputs that do not exist, under --binning device|sharded: an
    error block naming the missing file, exit 1, nothing written."""
    out = str(tmp_path / "x")
    argv = [
        "--mode", "mut", "--mut", str(tmp_path / "m"), "--target_bcf", str(tmp_path / "t"),
        "--reference_bcf", str(tmp_path / "r"), "--bins", "3,7,0.2", "--binning", binning,
        "--torch_device", "cpu", "-o", out,
    ]
    assert cli.main(argv) != 0
    err = capsys.readouterr().err
    assert "####### error #######" in err and str(tmp_path / "m") in err
    assert not os.path.exists(out + ".coal")
