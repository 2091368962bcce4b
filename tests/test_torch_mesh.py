"""``--devices N`` and the sharded binning of the port (parallel/mesh.py)
against colate_tpu's mesh, on the CPU.

Under ``--torch_device cpu`` a mesh of N is N shards on the CPU, and the
EM is the replicate-sequential f64 EM, as on the reference's CPU mesh
(tests/conftest.py gives JAX 8 virtual CPU devices): the ``.coal`` must be
byte-identical to ``python -m colate_tpu --devices N`` and the same for
every N.  Under ``--binning sharded`` the port bins in float32 (the
kernel's plain version) where the reference's CPU mesh bins in XLA f64,
so against the reference it is held to the binning tiers of
tests/test_torch_binning.py (identified rates within 1e-4, weak ones
within 1e-3), and within the port to the same bytes for every N.  The
histograms are bitwise equal between shard counts, and within 2e-5 of
the reference's sharded binning.
"""

import contextlib
import filecmp
import io

import numpy as np
import pytest
import torch

from colate_tpu import cli as jax_cli
from colate_tpu.formats.coal import CoalFile
from colate_tpu.parallel import mesh as jax_mesh
from colate_tpu_torch import cli
from colate_tpu_torch.fixtures import hist_rel, synthetic_sites
from colate_tpu_torch.parallel import mesh
from colate_tpu_torch.pipeline.binning import bin_sites_analytic
from colate_tpu_torch.pipeline.join import JoinedSites
from test_torch_mut import load_native

# small tensors: one intra-op thread per test process (see test_torch_mut.py)
torch.set_num_threads(1)

SHARDS = (1, 2, 4)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    from colate_tpu_torch.fixtures import make_fixture

    load_native()
    return make_fixture(str(tmp_path_factory.mktemp("mesh")), n_per_chrom=2500, seed=11)


def _argv(fix, out, *extra):
    return [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", "3,7,0.5", "--seed", "3", "--num_bootstraps", "2",
        "-o", out, *extra,
    ]


@pytest.fixture(scope="module")
def port(fix, tmp_path_factory):
    """The port's .coal and log of --devices 1, 2 and 4 under --binning
    auto and sharded."""
    root = tmp_path_factory.mktemp("port")
    runs = {}
    for binning in ("auto", "sharded"):
        for n in SHARDS:
            out = str(root / f"{binning}{n}")
            log = io.StringIO()
            with contextlib.redirect_stderr(log):
                rc = cli.main(_argv(fix, out, "--devices", str(n), "--binning", binning,
                                    "--torch_device", "cpu"))
            assert rc == 0, log.getvalue()[-2000:]
            runs[binning, n] = (out + ".coal", log.getvalue())
    return runs


@pytest.mark.parametrize("n", SHARDS)
def test_devices_coal_matches_the_reference(fix, port, tmp_path, n):
    ref = str(tmp_path / "jax")
    assert jax_cli.main(_argv(fix, ref, "--devices", str(n))) == 0
    coal, log = port["auto", n]
    assert f"provider=mesh[{n}]:torch:float64(cpu) " in log
    assert filecmp.cmp(ref + ".coal", coal, shallow=False)
    assert filecmp.cmp(port["auto", 1][0], coal, shallow=False)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_binning_devices(fix, port, tmp_path, n):
    coal, log = port["sharded", n]
    assert "binning=torch-twin:float32(cpu) " in log
    assert filecmp.cmp(port["sharded", 1][0], coal, shallow=False)
    ref = str(tmp_path / "jax")
    assert jax_cli.main(_argv(fix, ref, "--devices", str(n), "--binning", "sharded")) == 0
    a, b = CoalFile.read(ref + ".coal").rates, CoalFile.read(coal).rates
    assert a.shape == b.shape == (2, 11)
    rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-300)
    assert (a >= 1e-4).sum() >= 2 and (a >= 1e-6).sum() >= 8, "fixture must identify rates"
    assert rel[a >= 1e-4].max() <= 1e-4
    assert rel[a >= 1e-6].max() <= 1e-3, rel
    np.testing.assert_array_equal(a == 0.0, b == 0.0)


def _em_problem(B=5):
    from colate_tpu_torch.ops.epochs import epochs_from_bins

    g = np.random.default_rng(3)
    epochs, _ = epochs_from_bins("3,7,0.25", 28.0, 0.0)
    init = np.full(epochs.shape, 1 / 20000.0)
    sc = np.abs(g.normal(5.0, 2.0, (B, 185)))
    nc = np.abs(g.normal(50.0, 10.0, (B, 185)))
    return epochs, init, sc, nc


@pytest.mark.parametrize("backend", ["kernel", "float64"])
def test_sharded_run_em_is_bitwise_across_shards(backend):
    """B=5 replicates (not a multiple of the shard counts; 8 shards leave
    3 empty), cut at 96 iterations: every shard count gives the bits of
    one shard, which are those of the unsharded EM of that backend."""
    from colate_tpu_torch.ops.em import run_em_sequential
    from colate_tpu_torch.ops.em_kernel import run_em_kernel

    epochs, init, sc, nc = _em_problem()
    kw = dict(max_iter=96, min_iter=16)
    one = mesh.sharded_run_em(mesh.make_mesh(1, "cpu"), epochs, init, sc, nc, backend, **kw)
    if backend == "kernel":
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
        ref = run_em_kernel(epochs, init, f32(sc), f32(nc), **kw)
    else:
        ref = run_em_sequential(epochs, init, sc, nc, dtype="float64", device="cpu", **kw)
    for a, b in zip(one, ref):
        np.testing.assert_array_equal(a, b.numpy())
    assert one[0].shape == (5, epochs.shape[0]) and (one[2] > 16).all()
    for n in (2, 4, 8):
        out = mesh.sharded_run_em(mesh.make_mesh(n, "cpu"), epochs, init, sc, nc, backend, **kw)
        for a, b in zip(out, one):
            np.testing.assert_array_equal(a, b)


def test_f64_sharded_em_matches_the_reference():
    """The replicate-sequential f64 EM against colate_tpu's sharded EM on
    its 2-device CPU mesh: iterations equal, rates within 1e-12."""
    epochs, init, sc, nc = _em_problem()
    ours = mesh.sharded_run_em(mesh.make_mesh(2, "cpu"), epochs, init, sc, nc, "float64",
                               max_iter=96, min_iter=16)
    ref = jax_mesh.sharded_run_em(jax_mesh.make_mesh(2), epochs, init, sc, nc, max_iter=96,
                                  min_iter=16)
    np.testing.assert_array_equal(ours[2], np.asarray(ref[2]))
    np.testing.assert_allclose(ours[0], np.asarray(ref[0]), rtol=1e-12)


def test_make_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a mesh of 2 cards, but torch sees 1"):
        mesh.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        mesh.make_mesh(0, "cpu")


EDGES = {  # the edges of the binning's cuts (VERDICT.md's list)
    "no-sites": lambda: synthetic_sites(n=0, nb=3),
    "one-block": lambda: synthetic_sites(n=500, nb=1, seed=6),
    "3-blocks-8-shards": lambda: synthetic_sites(n=3000, nb=3, seed=7),
    "empty-blocks-between": lambda: JoinedSites(**{
        **synthetic_sites(n=4000, nb=4, seed=8).__dict__,
        "block_id": np.repeat(np.array([0, 5, 6, 11], np.int32), 1000), "num_blocks": 12}),
    "3000-blocks": lambda: synthetic_sites(n=20000, nb=3000, seed=4),
    "20000-12": lambda: synthetic_sites(n=20000, nb=12, seed=1),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_sharded_binning_edges(case):
    """Every shard count bins bitwise as one shard, which is the port's
    binning of the whole stream; against colate_tpu's sharded binning on
    its CPU mesh (XLA f64) within 2e-5."""
    sites = EDGES[case]()
    whole = bin_sites_analytic(sites, 0.0, "cpu")
    for n in (1, 2, 4, 8):
        out = mesh.sharded_bin_sites(mesh.make_mesh(n, "cpu"), sites)
        for a, b in zip(out, whole):
            assert a.shape == (sites.num_blocks, 185)
            np.testing.assert_array_equal(a, b)
        if n in (1, 4) and len(sites):
            ref = jax_mesh.sharded_bin_sites(
                jax_mesh.make_mesh(n), sites.age_begin, sites.age_end, sites.w_shared,
                sites.w_notshared, sites.block_id, sites.num_blocks)
            assert hist_rel(out, ref) <= 2e-5


def test_block_aligned_bounds_match_the_reference():
    g = np.random.default_rng(2)
    for blk in (np.zeros(0, np.int64), np.zeros(7, np.int64),
                np.sort(g.integers(0, 5, 1000)), np.repeat(np.arange(3), [1, 500, 2])):
        for nd in (1, 2, 3, 8):
            np.testing.assert_array_equal(mesh._block_aligned_site_bounds(blk, nd),
                                          jax_mesh._block_aligned_site_bounds(blk, nd))


def test_dryrun_multichip_on_cpu_shards(capsys):
    """The dry run chip_smoke.py runs on 4 shards of one card, here on 2
    shards of the CPU at one replicate (the f64 EM)."""
    info = mesh.dryrun_multichip(2, devices=mesh.make_mesh(2, "cpu"), B=1)
    assert info["backend"] == "float64" and info["sites"] == 20_000 and info["blocks"] == 12
    assert info["e2e_sites"] > 1000
    assert "byte-identical" in capsys.readouterr().out
