"""The CUDA kernels of the port on the card (marker ``cuda``; skips without
a CUDA device).  Imports no JAX, so it also runs on a machine without it:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports JAX; ``--noconftest`` skips it.)

Tolerances: the EM kernel against its plain torch twin, both on the card,
those of tests/test_em_pallas.py (one 8-iteration chunk: rates 1e-4, f64
log-likelihood 3e-6; the two differ in reduction order and in CUDA's
against torch's expf/expm1f); runs to convergence against the host f64 EM
the f32 tiers of tests/test_em_f32.py:34-35.  The whole EM in one launch
against its plain version: identified rates (>= 1e-4) within 1e-4 and
iteration counts within 10%: the stopping rule on a nearly flat likelihood
turns those last-digit differences into when a replicate stops (PERF.md).
Against the kernel's own chunked route (the same float32 arithmetic, a
launch per chunk) it stops at the same chunk with bitwise equal rates,
f64 rounding of the per-chunk sums aside.  The binning kernel against
its plain version within 2e-5 of each histogram's max and against the host
f64 binning within 5e-5 (tests/test_bin_pallas.py's bounds: both bin in
float32 per site, in another order of sums).  The tree estimators'
programs (float64 torch, no atomics) on the card against the same
programs on the CPU at rtol 1e-12 (another order of sums), and two runs
bitwise equal; the two CLI modes on the card against ``--torch_device
cpu`` within 1e-5 (the goldens' tolerance: the ``.coal`` prints six
digits) with the same NaN pattern.  The byte-identity routes
(``--sampling mc_parity``, ``--em_dtype float64``) on the card against
``--torch_device cpu``, and the ``--checkpoint``, shard and rank paths
against their single uninterrupted runs: equal bytes, bitwise equal
histograms and rates.  Mode mut on BCF and BAM inputs: one launch of each
kernel a run, the ``.colate_mat`` of ``--binning auto`` equal to the
CPU's, identified rates within 1e-4 of the host f64 EM's.  The sampled
E-step (float64) on the card against the point E-step on the CPU at the
ages it drew: rtol 1e-12 with a norm-wise floor (tests/test_torch_em.py's
bound); mode tree on an SMC import with permuted labels as the CLI modes.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from colate_tpu_torch import cli
from colate_tpu_torch.config import INITIAL_COAL_RATE
from colate_tpu_torch.fixtures import (
    bench_sites, beyond_table_sites, hist_rel, make_fixture, synthetic_sites,
)
from colate_tpu_torch.formats.coal import CoalFile
from colate_tpu_torch.ops import bin_kernel, em_kernel
from colate_tpu_torch.ops.em import run_em, run_em_native
from colate_tpu_torch.ops.epochs import epochs_from_bins
from colate_tpu_torch.pipeline.binning import bin_sites_analytic, bin_sites_analytic_native
from colate_tpu_torch.pipeline.join import JoinedSites
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


def _state(B, E, card, init=INITIAL_COAL_RATE):
    """The loop state of a run's start: rates, ll -inf, none converged."""
    return (
        torch.full((B, E), init, device=card), torch.full((B,), -np.inf, dtype=torch.float64, device=card),
        torch.zeros(B, dtype=torch.bool, device=card), torch.zeros(B, dtype=torch.int32, device=card),
    )


def _counts_on(card, B, seed):
    sc, nc = _synthetic_counts(B, seed)
    return (torch.as_tensor(x, dtype=torch.float32, device=card) for x in (sc, nc))


@pytest.mark.parametrize("bins", ["3,7,0.2", "one-epoch", "3,7,0.05"])
def test_em_run_matches_reference(card, bins):
    """The whole EM in one launch against em_run_reference on the card,
    at E=23, E=1 and E=83 (three 32-epoch groups), cut at 1,600
    iterations."""
    epochs = np.zeros(1) if bins == "one-epoch" else epochs_from_bins(bins, 28.0, 0.0)[0]
    E = epochs.shape[0]
    s, n = _counts_on(card, 64, seed=21)
    args = (0, 1600, 200, K)
    before = em_kernel.launches
    ours = em_kernel.em_run(epochs, _state(64, E, card)[0], s, n, *_state(64, E, card)[1:], *args)
    torch.cuda.synchronize()
    assert em_kernel.launches == before + 1
    ref = em_kernel.em_run_reference(epochs, _state(64, E, card)[0], s, n, *_state(64, E, card)[1:], *args)
    r, rr = ours[0].double().cpu().numpy(), ref[0].double().cpu().numpy()
    assert np.isfinite(r).all()
    np.testing.assert_array_equal(r == 0, rr == 0)
    # identified rates; the one rate of a one-epoch EM always is
    ident = rr > 0 if E == 1 else rr >= 1e-4
    assert ident.sum() >= min(E, 4)
    assert (np.abs(r - rr)[ident] / rr[ident]).max() <= 1e-4
    it, it_ref = ours[3].cpu().numpy(), ref[3].cpu().numpy()
    assert (np.abs(it - it_ref) <= 0.1 * it_ref).all()
    conv = ours[2].cpu().numpy()
    assert (it[~conv] == 1600).all() and (it <= 1600).all()


def test_em_run_matches_the_chunked_route(card):
    """One launch against run_em with em_chunk as its step: the same
    float32 chunks, so the same stopping chunk and bitwise equal rates."""
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    s, n = _counts_on(card, 256, seed=22)
    one = em_kernel.run_em_kernel(epochs, init, s, n, max_iter=2400, min_iter=200)

    def step(rates, k):
        new, wsum = em_kernel.em_chunk(epochs, rates.contiguous(), s, n, k)
        return new, wsum.to(torch.float64).sum(1)

    chunked = run_em(epochs, init, s, n, dtype="float32", check_every=K, max_iter=2400,
                     min_iter=200, device=card, step=step)
    same = one[2] == chunked[2]
    assert same.float().mean() >= 0.99
    assert torch.equal(one[0][same], chunked[0][same])
    assert torch.equal(one[1][same], chunked[1][same])


def test_em_run_is_independent_of_batch(card):
    """Replicates 0..63 alone equal the same replicates in a run of 1024."""
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    s, n = _counts_on(card, 1024, seed=23)
    kw = dict(max_iter=1200, min_iter=200)
    whole = em_kernel.run_em_kernel(epochs, init, s, n, **kw)
    part = em_kernel.run_em_kernel(epochs, init, s[:64].contiguous(), n[:64].contiguous(), **kw)
    for a, b in zip(whole, part):
        assert torch.equal(a[:64], b)


def test_em_run_cut_and_resumed(card):
    """A run cut at max_iter returns ops/em.py:run_em's loop state, and
    resuming it equals the uncut run bitwise."""
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    s, n = _counts_on(card, 128, seed=24)
    kw = dict(min_iter=200, max_iter=8000)
    full = em_kernel.run_em_kernel(epochs, init, s, n, **kw)
    at = int(full[2].median()) // K * K  # about half the replicates still run there
    cut = em_kernel.run_em_kernel(epochs, init, s, n, min_iter=200, max_iter=at, return_state=True)
    it, _, _, conv, iters = cut
    assert it == at and (iters <= at).all()
    assert conv.any() and not conv.all(), "the cut must leave some replicates running"
    resumed = em_kernel.run_em_kernel(epochs, init, s, n, resume_state=cut, **kw)
    for a, b in zip(resumed, full):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
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
    """The host EM (auto at B=16 on the CPU) against float32 (the kernel)
    and float64 (torch on the card)."""
    native = _run(fix, str(tmp_path / "native"), "--torch_device", "cpu")
    before = em_kernel.launches
    f32 = _run(fix, str(tmp_path / "f32"), "--em_dtype", "float32", "--torch_device", "cuda")
    assert em_kernel.launches > before
    rel = np.abs(f32 - native) / np.maximum(np.abs(native), 1e-300)
    assert rel[native >= 1e-4].max() <= 1e-4
    assert rel[native >= 1e-6].max() <= 2e-2
    f64 = _run(fix, str(tmp_path / "f64"), "--em_dtype", "float64", "--torch_device", "cuda")
    # the .coal prints 6 significant digits; the f64 EMs agree to ~1e-12
    np.testing.assert_allclose(f64, native, rtol=1e-5)


def test_cli_auto_takes_the_kernel(card, fix, tmp_path, capsys):
    """--em_dtype auto on the card runs the CUDA EM kernel at B=16, where
    the CPU takes the host EM: identified rates within 1e-4 of it."""
    native = _run(fix, str(tmp_path / "native"), "--torch_device", "cpu")
    assert "provider=native " in capsys.readouterr().err
    before = em_kernel.launches
    auto = _run(fix, str(tmp_path / "auto"))
    assert em_kernel.launches == before + 1
    assert "provider=cuda-kernel:float32 " in capsys.readouterr().err
    rel = np.abs(auto - native) / np.maximum(np.abs(native), 1e-300)
    assert rel[native >= 1e-4].max() <= 1e-4


@pytest.mark.parametrize("extra", [("--sampling", "mc_parity"), ("--em_dtype", "float64")],
                         ids=["mc_parity", "float64"])
def test_f64_coal_on_the_card_is_the_cpu_bytes(card, fix, tmp_path, capsys, extra):
    """The byte-identity routes (--sampling mc_parity, --em_dtype float64)
    write the same .coal under --torch_device cuda as under cpu, where the
    CPU tests hold them byte-identical to python -m colate_tpu."""
    argv = ["--mode", "mut", "--mut", fix["mut_prefix"], "--target_tmp", fix["target"],
            "--reference_tmp", fix["reference"], "--chr", fix["chrfile"], "--bins", "3,7,0.2",
            "--seed", "3", "--num_bootstraps", "8", *extra]
    for device in ("cuda", "cpu"):
        assert cli.main(argv + ["-o", str(tmp_path / device), "--torch_device", device]) == 0
    err = capsys.readouterr().err
    providers = [ln.split("provider=")[1].split()[0] for ln in err.splitlines() if "mut_em " in ln]
    a, b = (str(tmp_path / f"{d}.coal") for d in ("cuda", "cpu"))
    if not filecmp.cmp(a, b, shallow=False):
        ra, rb = CoalFile.read(a).rates, CoalFile.read(b).rates
        rel = np.abs(ra - rb) / np.maximum(np.abs(rb), 1e-300)
        pytest.fail(f"{extra}: .coal bytes differ ({providers}): {int((ra != rb).sum())} of "
                    f"{ra.size} printed rates, max rel {rel.max():.3e}")


def _bootstrap_counts(fix, B, seed):
    """Bootstrapped count matrices of a fixture, as mode mut makes them."""
    from colate_tpu_torch.config import MutRunConfig
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
                 resume_state=state, device="cpu")[0].numpy()
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
    stream = bin_kernel.site_stream(sites, age, pin=True).to(card)
    before = bin_kernel.launches
    hk = bin_kernel.bin_chunks(stream)
    torch.cuda.synchronize()
    assert bin_kernel.launches == before + (stream.n_chunks > 0)
    hp = bin_kernel.bin_chunks_reference(stream)
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    assert hk.shape == (sites.num_blocks, 4, 185) and np.isfinite(hk).all()
    ours = [hk[:, j] for j in range(4)]
    assert hist_rel(ours, [hp[:, j] for j in range(4)]) <= 2e-5
    assert hist_rel(ours, bin_sites_analytic_native(sites, age)) <= 5e-5


def test_bin_kernel_is_bitwise_from_run_to_run(card):
    """No atomics: two launches on one input give bitwise equal sums, also
    with unsorted ids (blocks of several runs) and blocks of many
    segments."""
    for sites in (bench_sites(300_000, nb=7), synthetic_sites(n=40_000, sorted_blocks=False)):
        stream = bin_kernel.site_stream(sites).to(card)
        assert stream.n_segs > sites.num_blocks or stream.n_chunks > 2 * sites.num_blocks
        first = bin_kernel.bin_chunks(stream)
        assert torch.equal(first, bin_kernel.bin_chunks(stream))


def test_bin_kernel_refuses_a_malformed_stream(card):
    stream = bin_kernel.site_stream(synthetic_sites(n=1000, nb=2)).to(card)
    bad = bin_kernel.SiteStream(**{**stream.__dict__, "chunk_start": stream.chunk_start.int()})
    with pytest.raises(ValueError, match="chunk_start must be contiguous torch.int64"):
        bin_kernel.bin_chunks(bad)
    bad = bin_kernel.SiteStream(**{**stream.__dict__, "fv": stream.fv[:, :-1]})
    with pytest.raises(ValueError, match="fv must be contiguous|inconsistent shapes"):
        bin_kernel.bin_chunks(bad)


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


# ---- mode mut on BCF and BAM inputs ----

KINDS = ("bcf_bcf", "bcf_split", "bam_bcf", "bam_bcf_per_chr", "bam_bam")


@pytest.fixture(scope="module")
def bb(tmp_path_factory):
    from colate_tpu_torch.fixtures import make_bcf_bam_fixture

    return make_bcf_bam_fixture(str(tmp_path_factory.mktemp("bcfbam")))


def _bb_argv(bb, kind, out, *extra):
    return ["--mode", "mut", "--mut", bb["mut_prefix"], "--chr", bb["chrfile"], "--bins",
            "3,7,0.2", "--seed", "43", *bb["inputs"][kind], "-o", out, *extra]


@pytest.mark.parametrize("binning", ["auto", "device"])
@pytest.mark.parametrize("kind", KINDS)
def test_bcf_bam_inputs_on_the_card(card, bb, tmp_path, capsys, kind, binning):
    """Each input kind at B=16 on the card: one EM kernel launch, and under
    --binning device one binning kernel launch; the .colate_mat under auto
    is the one --torch_device cpu writes (host binning and bootstrap), and
    the identified rates within 1e-4 of the host f64 EM's."""
    ems, bins = em_kernel.launches, bin_kernel.launches
    out = str(tmp_path / "card")
    assert cli.main(_bb_argv(bb, kind, out, "--num_bootstraps", "16", "--binning", binning)) == 0
    err = capsys.readouterr().err
    assert em_kernel.launches == ems + 1
    assert bin_kernel.launches == bins + (binning == "device")
    assert "provider=cuda-kernel:float32 " in err
    assert f"binning={'cuda-kernel:float32' if binning == 'device' else 'native'} " in err
    host = str(tmp_path / "host")
    assert cli.main(_bb_argv(bb, kind, host, "--num_bootstraps", "16", "--binning", binning,
                             "--torch_device", "cpu", "--em_dtype", "float64")) == 0
    if binning == "auto":
        assert filecmp.cmp(out + ".colate_mat", host + ".colate_mat", shallow=False)
    a, b = CoalFile.read(out + ".coal").rates, CoalFile.read(host + ".coal").rates
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
    assert (b >= 1e-4).sum() >= 4 and rel[b >= 1e-4].max() <= 1e-4


@pytest.mark.parametrize("kind", ["bcf_split", "bam_bcf"])
def test_bcf_bam_parity_bytes_on_the_card(card, bb, tmp_path, kind):
    """--sampling mc_parity --em_dtype float64 at B=8: the .coal on the card
    is the CPU's bytes (which the CPU tests hold to python -m colate_tpu's)."""
    for device in ("cuda", "cpu"):
        assert cli.main(_bb_argv(bb, kind, str(tmp_path / device), "--num_bootstraps", "8",
                                 "--sampling", "mc_parity", "--em_dtype", "float64",
                                 "--torch_device", device)) == 0
    assert filecmp.cmp(str(tmp_path / "cuda.coal"), str(tmp_path / "cpu.coal"), shallow=False)


# ---- --checkpoint, shards and ranks on the card ----

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _subprocess_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, **extra)
    return env


def test_checkpoint_killed_and_resumed_on_the_card(card, fix, tmp_path):
    """--checkpoint on the card (the EM kernel, a launch per chunk): a
    process killed after its first 128-iteration chunk resumes from the
    saved state and writes the bytes of an uninterrupted card run, which
    are those of a run without --checkpoint."""
    import subprocess
    import sys

    plain = str(tmp_path / "plain")
    _run(fix, plain)
    before = em_kernel.launches
    _run(fix, str(tmp_path / "whole"), "--checkpoint")
    assert em_kernel.launches == before + 1
    assert filecmp.cmp(plain + ".coal", str(tmp_path / "whole.coal"), shallow=False)
    out = str(tmp_path / "killed")
    cmd = [sys.executable, "-m", "colate_tpu_torch", "--mode", "mut", "--mut", fix["mut_prefix"],
           "--target_tmp", fix["target"], "--reference_tmp", fix["reference"], "--chr",
           fix["chrfile"], "--bins", "3,7,0.2", "--seed", "3", "--num_bootstraps", "16",
           "--checkpoint", "-o", out]
    r = subprocess.run(cmd, env=_subprocess_env(COLATE_EM_CKPT_CHUNK="128",
                                                COLATE_EM_DIE_AFTER_CHUNKS="1"),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 17, r.stderr[-2000:]
    assert os.path.exists(out + ".emstate.npz")
    r = subprocess.run(cmd, env=_subprocess_env(COLATE_EM_CKPT_CHUNK="128"), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "provider=cuda-kernel:float32(checkpointed) " in r.stderr
    assert not os.path.exists(out + ".emstate.npz")
    assert filecmp.cmp(str(tmp_path / "whole.coal"), out + ".coal", shallow=False)


def test_four_shards_on_one_card(card):
    """sharded_bin_sites and sharded_run_em over [cuda:0] * 4 against one
    shard, bitwise: one bin kernel launch a non-empty shard, one EM
    launch a shard."""
    from colate_tpu_torch.parallel.mesh import sharded_bin_sites, sharded_run_em

    sites = bench_sites(300_000, nb=13)
    before = bin_kernel.launches
    four = sharded_bin_sites([card] * 4, sites)
    assert bin_kernel.launches == before + 4
    one = sharded_bin_sites([card], sites)
    for a, b in zip(four, one):
        np.testing.assert_array_equal(a, b)
    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    init = np.full(epochs.shape, INITIAL_COAL_RATE)
    sc, nc = _synthetic_counts(130, seed=25)
    before = em_kernel.launches
    four = sharded_run_em([card] * 4, epochs, init, sc, nc, max_iter=1600, min_iter=200)
    assert em_kernel.launches == before + 4
    one = sharded_run_em([card], epochs, init, sc, nc, max_iter=1600, min_iter=200)
    for a, b in zip(four, one):
        np.testing.assert_array_equal(a, b)


def test_two_ranks_on_one_card(card, fix, tmp_path):
    """Two ranks of the CLI share the card (gloo merge): rank 0 writes the
    single-process card run's bytes, under --binning auto and device."""
    import socket
    import subprocess
    import sys

    for binning in ("auto", "device"):
        single = str(tmp_path / f"single_{binning}")
        _run(fix, single, "--binning", binning)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        multi = str(tmp_path / f"multi_{binning}")
        cmd = [sys.executable, "-m", "colate_tpu_torch", "--mode", "mut", "--mut",
               fix["mut_prefix"], "--target_tmp", fix["target"], "--reference_tmp",
               fix["reference"], "--chr", fix["chrfile"], "--bins", "3,7,0.2", "--seed", "3",
               "--num_bootstraps", "16", "--binning", binning, "-o", multi, "--coordinator",
               f"127.0.0.1:{port}", "--num_processes", "2"]
        procs = [subprocess.Popen(cmd + ["--process_id", str(i)], env=_subprocess_env(),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for i in range(2)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=600)
                assert p.returncode == 0, err[-2000:]
                assert "device=cuda:0 " in err
        finally:
            for p in procs:
                p.kill()
                p.wait(timeout=30)
        assert filecmp.cmp(single + ".coal", multi + ".coal", shallow=False)


# ---- the tree estimators' programs ----


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two chromosomes of 120 trees of 16 haplotypes (the port's writer of
    tests/helpers/synth_anc.py's fixture), one with ancient samples, and
    4-column and segment poplabels."""
    from colate_tpu_torch.fixtures import make_anc_mut, write_segment_poplabels

    root = str(tmp_path_factory.mktemp("cudatree"))
    prefix = os.path.join(root, "trees")
    maxpos = []
    for i, c in enumerate(["1", "2"]):
        _, mut = make_anc_mut(prefix, c, N=16, num_trees=120, snps_per_tree=4, seed=7 + i)
        maxpos.append(int(mut.pos[-1]))
    old = os.path.join(root, "old")
    make_anc_mut(old, "1", N=16, num_trees=120, snps_per_tree=4, seed=9,
                 sample_ages=[0.0] * 12 + [40.0, 0.0, 125.0, 7.5])
    with open(os.path.join(root, "chr.txt"), "w") as fh:
        fh.write("1\n2\n")
    with open(os.path.join(root, "pop4.poplabels"), "w") as fh:
        fh.write("sample population group sex\n")
        fh.writelines(f"S{i} {'A' if i < 3 else 'B' if i < 6 else 'C'} G NA\n" for i in range(8))
    write_segment_poplabels(os.path.join(root, "seg.poplabels"), ["1", "2"], maxpos, 16, 30, seed=4)
    return dict(root=root, prefix=prefix, old=old, chrfile=os.path.join(root, "chr.txt"))


def _tree_inputs(trees, src):
    from colate_tpu_torch.formats.anc import AncFile, node_ages
    from colate_tpu_torch.formats.mut import MutTable
    from colate_tpu_torch.models.tree_coal import epochs_from_bins_tree, tree_spans

    anc = AncFile.read(src + "_chr1.anc", columns="tree")
    spans = np.float32(tree_spans(anc, MutTable.read(src + "_chr1.mut"))).astype(np.float64)
    coords = node_ages(anc)
    T = coords.shape[0]
    blocks = (np.arange(T) // 25).astype(np.int32)  # 5 blocks
    return coords, spans, blocks, epochs_from_bins_tree("1,6,0.25", 28.0), anc.n_hap, T // 25 + 1


@pytest.mark.parametrize("form", ["general", "sorted", "general-ancient"])
def test_populate_on_the_card(card, trees, monkeypatch, form):
    from colate_tpu_torch.ops import tree_kernel

    coords, *rest = _tree_inputs(trees, trees["old"] if form.endswith("ancient") else trees["prefix"])
    if form == "sorted":
        # the parsed internal ages, in the order the .anc gives them
        assert tree_kernel.leaf_zero_applicable(coords, rest[3])
    fn = tree_kernel.populate_device_sorted if form == "sorted" else tree_kernel.populate_device
    runs = tree_kernel.program_runs
    ours = fn(coords, *rest, card)
    assert tree_kernel.program_runs == runs + 1
    cpu = fn(coords, *rest, "cpu")
    for a, b in zip(ours, cpu):
        assert np.isfinite(a).all() and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)
    again = fn(coords, *rest, card)
    monkeypatch.setattr(tree_kernel, "SLAB", 37)
    split = fn(coords, *rest, card)
    for a, b, c in zip(ours, again, split):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _la_inputs(trees, seg: bool):
    from colate_tpu_torch.formats.anc import AncFile
    from colate_tpu_torch.formats.mut import MutTable
    from colate_tpu_torch.models.local_ancestry import CoalLA, _read_la_poplabels
    from colate_tpu_torch.models.tree_coal import epochs_from_bins_tree

    anc = AncFile.read(trees["prefix"] + "_chr1.anc", columns="tree")
    mut = MutTable.read(trees["prefix"] + "_chr1.mut")
    if seg:
        groups, rows = _read_la_poplabels(os.path.join(trees["root"], "seg.poplabels"))
        segs = [(bp, grp) for ch, bp, grp in rows if ch == "1"]
    else:
        groups = ["A", "B", "C"]
        lab = np.repeat(np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32), 2)
        segs = [(0, lab), (int(mut.pos[-1] + 1e6), lab)]
    est = CoalLA(epochs_from_bins_tree("1,6,0.25", 28.0), len(groups), device="cpu")
    return est.modern_inputs(anc, mut, segs)


@pytest.mark.parametrize("seg", [False, True], ids=["G3", "segments-G2"])
def test_la_program_on_the_card(card, trees, monkeypatch, seg):
    from colate_tpu_torch.ops import la_kernel

    args = _la_inputs(trees, seg)
    runs = la_kernel.program_runs
    ours = la_kernel.la_accumulate_device(*args, device=card)
    assert la_kernel.program_runs == runs + 1
    for a, b in zip(ours, la_kernel.la_accumulate_device(*args, device="cpu")):
        assert np.isfinite(a).all() and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for a, b in zip(ours, la_kernel.la_accumulate_native(*args)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    again = la_kernel.la_accumulate_device(*args, device=card)
    monkeypatch.setattr(la_kernel, "SLAB", 41)
    split = la_kernel.la_accumulate_device(*args, device=card)
    for a, b, c in zip(ours, again, split):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _coal_rates(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return np.array([[float(x) for x in ln.split()[2:]] for ln in lines[2:]])


@pytest.mark.parametrize("case", ["tree", "tree-ancient", "la-4col", "la-segments"])
def test_tree_modes_on_the_card(card, trees, tmp_path, capsys, case):
    """Both CLI modes on the card against --torch_device cpu: rates within
    1e-5, the same NaN pattern, and the device route in the log."""
    root = trees["root"]
    if case.startswith("tree"):
        src = trees["old"] if case == "tree-ancient" else trees["prefix"]
        chrfile = os.path.join(root, "one.txt")
        with open(chrfile, "w") as fh:
            fh.write("1\n")
        argv = ["--mode", "tree", "-i", src, "--chr", chrfile if case == "tree-ancient" else trees["chrfile"],
                "--bins", "1,6,0.25", "--num_bootstraps", "4"]
    else:
        pop = "seg.poplabels" if case == "la-segments" else "pop4.poplabels"
        argv = ["--mode", "local_ancestry", "-i", trees["prefix"], "--chr", trees["chrfile"],
                "--poplabels", os.path.join(root, pop), "--bins", "1,6,0.25", "--num_bootstraps", "4"]
    assert cli.main(argv + ["-o", str(tmp_path / "cpu"), "--torch_device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(argv + ["-o", str(tmp_path / "card")]) == 0
    assert "device" in capsys.readouterr().err.split("_done ")[-1].split("route=")[1].split()[0]
    ref, ours = _coal_rates(str(tmp_path / "cpu.coal")), _coal_rates(str(tmp_path / "card.coal"))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    ok = np.isfinite(ref)
    assert ok.sum() > 10
    np.testing.assert_allclose(ours[ok], ref[ok], rtol=1e-5)


# ---- the host modes on a card machine -------------------------------------------

def host_mode_outputs(root: str, main=cli.main) -> dict:
    """print_tmp on tests/test_cli.py's fixture and CondCoalRates on
    tests/test_aux_modes.py's cond_fixture layout (four bootstraps, the
    analytic walk and the replay), through ``main`` (the port's CLI under
    its default --torch_device); the sha256 of each output."""
    import hashlib

    from colate_tpu_torch.fixtures import make_anc_mut

    f = make_fixture(os.path.join(root, "tmp"), n_per_chrom=800, seed=31)
    prefix = os.path.join(root, "trees")
    for i, c in enumerate(["1", "2"]):
        make_anc_mut(prefix, c, N=12, num_trees=19, seed=61 + i)
    pop = os.path.join(root, "pop.poplabels")
    with open(pop, "w") as fh:
        fh.write("sample population group sex\n")
        fh.writelines(f"S{i} {'FOC' if i < 2 else 'CON' if i < 4 else 'OTH'} G1 NA\n"
                      for i in range(6))
    runs = {"print_tmp": ["--mode", "print_tmp", "--mut", f["mut_prefix"], "--target_tmp",
                          f["target"], "--chr", f["chrfile"]]}
    for sampling in ("analytic", "mc_parity"):
        runs[f"CondCoalRates-{sampling}"] = [
            "--mode", "CondCoalRates", "-i", prefix, "--chr", f["chrfile"], "--poplabels", pop,
            "--groups", "FOC,CON", "--bins", "2,6,0.5", "--seed", "7", "--num_bootstraps", "4",
            "--sampling", sampling]
    out = {}
    for name, argv in runs.items():
        path = os.path.join(root, name + ".txt")
        assert main(argv + ["-o", path]) == 0
        with open(path, "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


# host_mode_outputs of python -m colate_tpu on the CPU
# (tests/test_torch_host_modes.py holds it)
HOST_MODE_SHA256 = {
    "print_tmp": "405bf4de832507de81130fd9df27e6cfb58b1d31e22ad86265e177df84124b81",
    "CondCoalRates-analytic": "65c966c0722b1d6be8a09bebfc4a66d5aa2557fcb389780e56d65af7ed9e0ffe",
    "CondCoalRates-mc_parity": "2130a3213141dde7cb62205f3cd1571291e4c4e4fef76d981b76e95712e9b182",
}


def test_host_modes_on_a_card_machine_write_the_cpu_bytes(card, tmp_path):
    assert host_mode_outputs(str(tmp_path)) == HOST_MODE_SHA256


def test_tf32_stays_off_after_mode_tree_on_the_card(card, trees, tmp_path, capsys):
    assert cli.main(["--mode", "tree", "-i", trees["prefix"], "--chr", trees["chrfile"],
                     "--bins", "1,6,0.25", "-o", str(tmp_path / "t")]) == 0
    assert "device" in capsys.readouterr().err.split("route=")[-1]
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_trace_of_the_em_on_the_card(card, fix, tmp_path, monkeypatch):
    """COLATE_TPU_TRACE=<dir> on the card: the trace holds the EM kernel's
    launch on the device, and the .coal is a run's without it."""
    import json

    _run(fix, str(tmp_path / "plain"))
    monkeypatch.setenv("COLATE_TPU_TRACE", str(tmp_path / "trace"))
    _run(fix, str(tmp_path / "traced"))
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert filecmp.cmp(str(tmp_path / "plain.coal"), str(tmp_path / "traced.coal"), shallow=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_e_step_sampled_on_the_card(card, seed):
    """The Monte-Carlo E-step in float64 on the card: each age in its
    interval; the six outputs within rtol 1e-12 (plus a norm-wise floor of
    1e-12 times the output's largest magnitude) of the port's point E-step
    on the CPU at the ages it drew (CUDA's and the CPU's exp/expm1/log
    differ in the last ulp, which the closed forms' cancellations grow);
    two generators of one seed bitwise equal."""
    from colate_tpu_torch.config import age_bin_edges
    from colate_tpu_torch.ops.em import e_step_all_bins, e_step_sampled

    epochs, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
    E = epochs.shape[0]
    g = np.random.default_rng(seed)
    rates = INITIAL_COAL_RATE * np.exp(g.uniform(-2.0, 2.0, E))
    edges = age_bin_edges()
    a, b = np.tile(edges[:-1], 64), np.tile(edges[1:], 64)
    on = [torch.as_tensor(x, device=card) for x in (epochs, rates, a, b)]
    draw = lambda: e_step_sampled(on[0], on[1], torch.Generator(device=card).manual_seed(seed),
                                  on[2], on[3])
    out, again = draw(), draw()
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    t = out[-1].cpu()
    assert out[0].device.type == card.type
    assert bool(((t >= torch.from_numpy(a)) & (t <= torch.from_numpy(b))).all())
    ep = torch.from_numpy(epochs)
    k = torch.clamp(torch.searchsorted(ep, t, right=True) - 1, 0, E - 1)
    ref = e_step_all_bins(ep, torch.from_numpy(rates)[None], t, k)
    for x, y in zip(out[:-1], ref):
        y = y[0].numpy()
        np.testing.assert_allclose(x.cpu().numpy(), y, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(y).max()))


def test_tree_mode_on_an_smc_import_on_the_card(card, tmp_path, capsys):
    """Mode tree on the card on an ARGweaver SMC import whose internal
    labels were permuted (parents not numbered after their children):
    the device route, rates within 1e-5 of --torch_device cpu, the same
    NaN pattern."""
    from colate_tpu_torch.fixtures import make_anc_mut, write_genealogy
    from colate_tpu_torch.formats.anc import read_argweaver_smc

    src, mut = make_anc_mut(str(tmp_path / "src"), "1", N=16, num_trees=60, seed=9)
    write_genealogy(str(tmp_path / "g.smc"), src, "smc", seed=4)
    imported = read_argweaver_smc(str(tmp_path / "g.smc"))
    imported.write(str(tmp_path / "imp_chr1.anc"))
    mut.write(str(tmp_path / "imp_chr1.mut"))
    with open(tmp_path / "chr.txt", "w") as fh:
        fh.write("1\n")
    argv = ["--mode", "tree", "-i", str(tmp_path / "imp"), "--chr", str(tmp_path / "chr.txt"),
            "--bins", "1,6,0.25", "--num_bootstraps", "3"]
    for device in ("cuda", "cpu"):
        assert cli.main(argv + ["-o", str(tmp_path / device), "--torch_device", device]) == 0
        err = capsys.readouterr().err
        assert ("route=device-sorted:cuda" in err) == (device == "cuda")
    r, ref = _coal_rates(str(tmp_path / "cuda.coal")), _coal_rates(str(tmp_path / "cpu.coal"))
    assert r.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(r), np.isnan(ref))
    ok = np.isfinite(ref)
    assert ok.sum() > 10
    np.testing.assert_allclose(r[ok], ref[ok], rtol=1e-5)
