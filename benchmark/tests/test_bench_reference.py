"""The plain reference agrees with the program at a small size on the CPU:
the same accepted sites, the same histograms, the same counts and epochs,
and EM rates whose likelihood matches."""

import numpy as np
import torch

from benchmark.harness import generate
from benchmark.reference import binning, bootstrap, compare, em, join

from .test_bench_generate import PAIR


def test_join_binning_bootstrap_match_the_program(tmp_path):
    from colate_tpu_torch.config import MutRunConfig
    from colate_tpu_torch.models import mut_em

    p = generate.make_pair(str(tmp_path), dict(PAIR, mut_rows_per_bp=2.2e-3), 21)
    cfg = MutRunConfig(mut=p.mut_prefix, output=str(tmp_path / "o"), chr_list=p.chroms,
                       target_tmp=p.target, reference_tmp=p.reference, bins="3,7,0.2",
                       num_bootstrap=12, seed=77)
    stats = mut_em.suffstats(cfg, 77, device="cpu")
    sites = join.join(p.chroms, p.muts, p.target_stream, p.reference_stream)
    assert (len(sites), sites.num_blocks) == stats[4:6]
    assert len(sites) > 10000
    hists = binning.bin_sites(sites.age_begin, sites.age_end, sites.w_shared, sites.w_notshared,
                              sites.block, sites.num_blocks)
    for ours, theirs in zip(hists, stats[:4]):
        assert np.allclose(ours, theirs, rtol=1e-10, atol=1e-9 * np.abs(theirs).max())
    w = bootstrap.block_weights(12, sites.num_blocks, 77)
    sc, nc = bootstrap.counts(hists, w, 0.0)
    psc, pnc = mut_em.bootstrap_counts(cfg, stats, 77)
    # the program's prefix-sum binning leaves residues of ~1e-10 of the
    # largest bin in bins that hold nothing
    for ours, theirs in ((sc, psc), (nc, pnc)):
        assert np.allclose(ours, theirs, rtol=1e-10, atol=1e-9 * np.abs(theirs).max())
    epochs, ep_null = bootstrap.epochs_from_bins("3,7,0.2", 28.0, 0.0)
    pe, _, pnull = mut_em.mut_epochs(cfg)
    assert np.array_equal(epochs, pe) and ep_null == pnull


def test_ancient_epochs_and_redistribution_match_the_program():
    from colate_tpu_torch.ops.bootstrap import redistribute_emp
    from colate_tpu_torch.ops.epochs import epochs_from_bins

    age = bootstrap.age_generations(8000, 28)
    for bins in ("3,7,0.2", "2,6,0.25", "4,7,0.1"):
        ours = bootstrap.epochs_from_bins(bins, 28.0, age)
        theirs = epochs_from_bins(bins, float(np.float32(28.0)), age)
        assert np.array_equal(ours[0], theirs[0]) and ours[1] == theirs[1]
    g = np.random.default_rng(4)
    sh, se, ne = (g.random((6, 185)) * (g.random((6, 185)) < 0.7) for _ in range(3))
    for a in (0.0, age):
        assert np.allclose(bootstrap.redistribute(sh, se, ne, a), redistribute_emp(sh, se, ne, a),
                           rtol=1e-12)


def test_em_matches_the_program_and_its_control_reads_higher():
    from colate_tpu_torch.ops.em import run_em

    g = np.random.default_rng(8)
    t = em.age_bin_centers()
    base_s = 1e4 * np.exp(-0.5 * ((np.log(t + 1e-9) - 7.0) / 2.0) ** 2)
    base_n = 3e4 * np.exp(-0.5 * ((np.log(t + 1e-9) - 8.5) / 2.5) ** 2)
    sc = np.round(base_s * g.gamma(20.0, 1 / 20.0, size=(4, 185)), 3)
    nc = np.round(base_n * g.gamma(20.0, 1 / 20.0, size=(4, 185)), 3)
    epochs, _ = bootstrap.epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, em.INITIAL_RATE)
    theirs, _, titers = run_em(epochs, init, sc, nc, dtype="float64", device="cpu")
    ours, iters = em.run_em(epochs, init, sc, nc)
    assert np.array_equal(iters, titers.numpy())
    gap, short = compare.rate_gap(epochs, sc, nc, theirs.numpy(), titers.numpy())
    assert gap < 1e-9 and short == 0
    low, n_low = em.run_em(epochs, init, sc, nc, dtype=torch.float32, tf32=True)
    assert compare.rate_gap(epochs, sc, nc, low, n_low)[0] > 1e-4
    # an answer that stopped far too early is held against the reference's
    # rates STOP_ALLOWANCE iterations before its stop
    early = em.run_em(epochs, init, sc, nc, at=np.full(4, 300))[2]
    assert compare.rate_gap(epochs, sc, nc, early, np.full(4, 300))[0] > 1e-2


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, 3.14159265], dtype=torch.float32)
    y = em.to_tf32(x)
    assert y[0] == 1.0 and y[1] in (1.0, 1.0 + 2**-10) and y[2] == 1.0 + 2**-10
    assert (y.view(torch.int32) & 0x1FFF == 0).all()
