"""The CUDA kernels of the port on the card (marker ``cuda``; skips without
a CUDA device).  Imports no JAX, so it also runs on a machine without it:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports JAX; ``--noconftest`` skips it.)

Tolerances: the EM kernel against its plain torch twin, both on the card,
those of tests/test_em_pallas.py (one 8-iteration chunk: rates 1e-4, f64
log-likelihood 3e-6; the two differ in reduction order and in CUDA's
against torch's expf/expm1f); runs to convergence against the host f64 EM
the f32 tiers of tests/test_em_f32.py:34-35.  The binning kernel against
its plain version within 2e-5 of each histogram's max and against the host
f64 binning within 5e-5 (tests/test_bin_pallas.py's bounds: both bin in
float32 per site, in another order of sums).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from colate_tpu.config import INITIAL_COAL_RATE
from colate_tpu.formats.coal import CoalFile
from colate_tpu.ops.epochs import epochs_from_bins
from colate_tpu.pipeline.join import JoinedSites
from colate_tpu_torch import cli
from colate_tpu_torch.ops import bin_kernel, em_kernel
from colate_tpu_torch.ops.em import run_em, run_em_native
from colate_tpu_torch.pipeline.binning import bin_sites_analytic, bin_sites_analytic_native
from helpers.sites import bench_sites, beyond_table_sites, hist_rel, synthetic_sites
from test_em_pallas import _synthetic_counts

pytestmark = pytest.mark.cuda

K = 8


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chunk_both(card, bins, B):
    epochs, _ = epochs_from_bins(bins, 28.0, 0.0)
    sc, nc = _synthetic_counts(B, seed=B)
    r0 = torch.full((B, epochs.shape[0]), INITIAL_COAL_RATE, device=card)
    s = torch.as_tensor(sc, dtype=torch.float32, device=card)
    n = torch.as_tensor(nc, dtype=torch.float32, device=card)
    before = em_kernel.launches
    out_k = em_kernel.em_chunk(epochs, r0, s, n, K)
    torch.cuda.synchronize()
    assert em_kernel.launches == before + 1
    return out_k, em_kernel.em_chunk_reference(epochs, r0, s, n, K)


@pytest.mark.parametrize("bins, B", [
    ("3,7,0.2", 5), ("3,7,0.2", 128), ("3,7,0.2", 1024), ("3,7,0.05", 64),
])
def test_kernel_matches_twin(card, bins, B):
    (rk, wk), (rt, wt) = _chunk_both(card, bins, B)
    rk, rt = rk.cpu().numpy(), rt.cpu().numpy()
    assert np.isfinite(rk).all() and np.isfinite(wk.cpu().numpy()).all()
    nz = rt != 0
    assert (np.abs(rk[nz] - rt[nz]) / np.abs(rt[nz])).max() <= 1e-4
    np.testing.assert_array_equal(rk == 0, rt == 0)
    llk = wk.double().sum(1).cpu().numpy()
    llt = wt.double().sum(1).cpu().numpy()
    assert (np.abs(llk - llt) / np.abs(llt)).max() <= 3e-6


def test_kernel_is_independent_of_batch(card):
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    sc, nc = _synthetic_counts(6, seed=3)
    s = torch.as_tensor(sc, dtype=torch.float32, device=card)
    n = torch.as_tensor(nc, dtype=torch.float32, device=card)
    E = epochs.shape[0]
    r6, w6 = em_kernel.em_chunk(epochs, torch.full((6, E), INITIAL_COAL_RATE, device=card), s, n, K)
    r5, w5 = em_kernel.em_chunk(
        epochs, torch.full((5, E), INITIAL_COAL_RATE, device=card),
        s[:5].contiguous(), n[:5].contiguous(), K,
    )
    assert torch.equal(r6[:5], r5) and torch.equal(w6[:5], w5)


def test_kernel_refuses_too_many_epochs(card):
    epochs = np.concatenate([[0.0], np.geomspace(1.0, 1e6, 300)])
    B = 2
    r0 = torch.full((B, epochs.shape[0]), INITIAL_COAL_RATE, device=card)
    s = torch.ones((B, 185), device=card)
    with pytest.raises(ValueError, match="epochs exceed"):
        em_kernel.em_chunk(epochs, r0, s, s, K)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    from helpers.synth import make_fixture

    return make_fixture(str(tmp_path_factory.mktemp("cudamut")), n_per_chrom=3000, seed=5)


def _run(fix, out, *extra):
    argv = [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", "3,7,0.2", "--seed", "3",
        "--num_bootstraps", "16", "-o", out, *extra,
    ]
    assert cli.main(argv) == 0
    return CoalFile.read(out + ".coal").rates


def test_cli_on_the_card(card, fix, tmp_path):
    """auto (B=16: the native f64 EM) against float32 (the kernel) and
    float64 (torch on the card)."""
    native = _run(fix, str(tmp_path / "native"))
    before = em_kernel.launches
    f32 = _run(fix, str(tmp_path / "f32"), "--em_dtype", "float32", "--torch_device", "cuda")
    assert em_kernel.launches > before
    rel = np.abs(f32 - native) / np.maximum(np.abs(native), 1e-300)
    assert rel[native >= 1e-4].max() <= 1e-4
    assert rel[native >= 1e-6].max() <= 2e-2
    f64 = _run(fix, str(tmp_path / "f64"), "--em_dtype", "float64", "--torch_device", "cuda")
    # the .coal prints 6 significant digits; the f64 EMs agree to ~1e-12
    np.testing.assert_allclose(f64, native, rtol=1e-5)


def _bootstrap_counts(fix, B, seed):
    """Bootstrapped count matrices of a fixture, as mode mut makes them."""
    from colate_tpu.config import MutRunConfig
    from colate_tpu_torch.models.mut_em import bootstrap_counts, suffstats

    cfg = MutRunConfig(
        mut=fix["mut_prefix"], output=os.devnull, chr_list=fix["chroms"],
        target_tmp=fix["target"], reference_tmp=fix["reference"], bins="3,7,0.2",
        num_bootstrap=B,
    )
    return bootstrap_counts(cfg, suffstats(cfg, seed), seed)


def _tiers(rates, ref):
    rel = np.abs(rates - ref) / np.maximum(np.abs(ref), 1e-300)
    return rel[ref >= 1e-4].max(), rel[ref >= 1e-6].max()


def test_run_em_kernel_matches_native(card, tmp_path):
    """EM to convergence on the card against the host f64 EM, on the
    problem whose f32 contract tests/test_em_f32.py pins (its fixture,
    bootstrap count and seed): identified rates within 1e-4, weakly
    identified ones within 2e-2.  The weak tier is a property of the
    stopping rule on a nearly flat likelihood, so it is pinned on the
    reference's own problem; the per-step accuracy behind it is pinned by
    test_kernel_chunk_matches_f64."""
    from helpers.synth import make_fixture

    fix17 = make_fixture(str(tmp_path / "fix17"), n_per_chrom=3000, seed=17)
    sc, nc = _bootstrap_counts(fix17, 4, seed=2)
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    ref = run_em_native(epochs, init, sc, nc)[0]
    ours = em_kernel.run_em_kernel(
        epochs, init, torch.as_tensor(sc, device=card), torch.as_tensor(nc, device=card)
    )
    assert ours[0].device.type == "cuda"
    strong, weak = _tiers(ours[0].cpu().numpy(), ref)
    assert strong <= 1e-4
    assert weak <= 2e-2


def test_run_em_kernel_identified_rates_at_width(card, fix):
    """EM to convergence on the card at B=64 against the host f64 EM: the
    identified tier (rates >= 1e-4 within 1e-4).  On this problem every f32
    EM, the reference's XLA one included, misses the weak tier somewhere
    (the stopping rule on a nearly flat likelihood), so only the
    identified rates are held at this width."""
    sc, nc = _bootstrap_counts(fix, 64, seed=3)
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    ref = run_em_native(epochs, init, sc, nc)[0]
    ours = em_kernel.run_em_kernel(
        epochs, init, torch.as_tensor(sc, device=card), torch.as_tensor(nc, device=card)
    )
    strong, _ = _tiers(ours[0].cpu().numpy(), ref)
    assert (ref >= 1e-4).any(axis=1).all(), "every replicate must have an identified epoch"
    assert strong <= 1e-4


def test_kernel_chunk_matches_f64(card, fix):
    """One 8-iteration chunk from the host f64 EM's converged rates, the
    kernel against the torch f64 EM: within 1e-4 on every rate >= 1e-6,
    the per-chunk f32 contract of tests/test_em_pallas.py.  (The twin on
    the CPU gives 3e-7 on identified and 1.1e-5 on weak rates here.)"""
    sc, nc = _bootstrap_counts(fix, 16, seed=3)
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    ref = run_em_native(epochs, init, sc, nc)[0]
    B = ref.shape[0]
    state = (
        0, torch.as_tensor(ref), torch.full((B,), -np.inf, dtype=torch.float64),
        torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32),
    )
    r64 = run_em(epochs, init, sc, nc, max_iter=K, min_iter=K, check_every=K,
                 resume_state=state)[0].numpy()
    r32, _ = em_kernel.em_chunk(
        epochs, torch.as_tensor(ref, dtype=torch.float32, device=card),
        torch.as_tensor(sc, dtype=torch.float32, device=card),
        torch.as_tensor(nc, dtype=torch.float32, device=card), K,
    )
    strong, weak = _tiers(r32.cpu().numpy().astype(np.float64), r64)
    assert strong <= 1e-4
    assert weak <= 1e-4


# ---- the binning kernel ----


BIN_CASES = {  # name: (sites, age)
    "bench-1M-125": lambda: (bench_sites(1_000_000), 0.0),
    "age30": lambda: (synthetic_sites(age=30.0, seed=1), 30.0),
    "unsorted-4000": lambda: (synthetic_sites(n=4000, sorted_blocks=False), 0.0),
    "blocks-3000": lambda: (synthetic_sites(n=20000, nb=3000, seed=4), 0.0),
    "empty": lambda: (synthetic_sites(n=0, nb=0), 0.0),
    "three-sites": lambda: (synthetic_sites(n=3, nb=1, seed=5), 0.0),
    "beyond-table": lambda: (beyond_table_sites(), 0.0),
}


@pytest.mark.parametrize("name", list(BIN_CASES))
def test_bin_kernel_matches_plain_and_native(card, name):
    sites, age = BIN_CASES[name]()
    packed = bin_kernel.pack_sites(sites, age).to(card)
    before = bin_kernel.launches
    hk = bin_kernel.bin_chunks(packed)
    torch.cuda.synchronize()
    assert bin_kernel.launches == before + (packed.n_chunks > 0)
    hp = bin_kernel.bin_chunks_reference(packed)
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    assert hk.shape == (sites.num_blocks, 4, 185) and np.isfinite(hk).all()
    ours = [hk[:, j] for j in range(4)]
    assert hist_rel(ours, [hp[:, j] for j in range(4)]) <= 2e-5
    assert hist_rel(ours, bin_sites_analytic_native(sites, age)) <= 5e-5


def test_bin_kernel_split_at_a_block_boundary_is_bitwise(card):
    sites = bench_sites(200_000)
    whole = bin_sites_analytic(sites, 0.0, card)
    cut = int(np.searchsorted(sites.block_id, 60))
    halves = [bin_sites_analytic(JoinedSites(
        age_begin=sites.age_begin[lo:hi], age_end=sites.age_end[lo:hi],
        w_shared=sites.w_shared[lo:hi], w_notshared=sites.w_notshared[lo:hi],
        block_id=sites.block_id[lo:hi], num_blocks=sites.num_blocks,
    ), 0.0, card) for lo, hi in ((0, cut), (cut, len(sites)))]
    for w, a, b in zip(whole, *halves):
        np.testing.assert_array_equal(w, a + b)


def test_cli_binning_device_on_the_card(card, fix, tmp_path):
    """--binning device on the card against --binning auto (host f64
    binning), both with the f64 EM: identified rates within 1e-4, weak
    ones within 1e-3; --binning sharded writes the same bytes."""
    host = _run(fix, str(tmp_path / "host"), "--em_dtype", "float64", "--torch_device", "cuda")
    before = bin_kernel.launches
    dev = _run(fix, str(tmp_path / "dev"), "--em_dtype", "float64", "--torch_device", "cuda",
               "--binning", "device")
    assert bin_kernel.launches > before
    rel = np.abs(dev - host) / np.maximum(np.abs(host), 1e-300)
    assert rel[host >= 1e-4].max() <= 1e-4
    assert rel[host >= 1e-6].max() <= 1e-3
    _run(fix, str(tmp_path / "sharded"), "--em_dtype", "float64", "--torch_device", "cuda",
         "--binning", "sharded")
    assert filecmp.cmp(str(tmp_path / "dev.coal"), str(tmp_path / "sharded.coal"), shallow=False)
