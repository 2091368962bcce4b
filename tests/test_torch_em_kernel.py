"""The fused f32 EM step of the port (colate_tpu_torch/ops/em_kernel.py)
on the CPU, where em_chunk runs the kernel's plain torch twin, against the
Pallas kernel it replaces (colate_tpu/ops/em_pallas.py) in interpret mode.

Tolerances are those of tests/test_em_pallas.py, for the same reasons:
both sides are f32 E-steps with f64 log-likelihood sums whose reduction
orders and 1-exp(-x) evaluations differ (the twin uses expm1, Pallas a
Taylor series), so one 8-iteration chunk agrees to 1e-4 in the rates and
3e-6 in the log-likelihood, and a run to convergence to the f32 tiers.
The CUDA kernel itself is held to the twin in tests/test_torch_cuda.py
and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from colate_tpu.config import INITIAL_COAL_RATE
from colate_tpu.ops.em_pallas import _bin_constants, run_em_pallas
from colate_tpu.ops.epochs import epochs_from_bins
from colate_tpu_torch.ops import em_kernel
from test_em_pallas import _synthetic_counts

# tensors here are small: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (a 100x slowdown otherwise)
torch.set_num_threads(1)

EPOCHS, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
E = EPOCHS.shape[0]
INIT = np.full(E, INITIAL_COAL_RATE)


@pytest.fixture(scope="module")
def counts():
    return _synthetic_counts(B=5, seed=11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_bin_constants_match_pallas():
    ours = em_kernel.bin_constants(EPOCHS)
    ref = {k: np.asarray(v) for k, v in _bin_constants(EPOCHS.tobytes(), E).items() if k != "N"}
    for name in ("t", "tmk", "tk1", "epochs", "dt", "enext"):
        np.testing.assert_array_equal(ours[name], ref[name][:, 0], err_msg=name)
    k = ours["k"]
    np.testing.assert_array_equal((k < E - 1).astype(np.float32), ref["klt"][:, 0])
    np.testing.assert_array_equal(np.arange(E)[None, :] == k[:, None], ref["onehot"] > 0)
    np.testing.assert_array_equal(np.arange(E)[None, :] < k[:, None], ref["m_lt"] > 0)
    np.testing.assert_array_equal(np.arange(E)[None, :] > k[:, None], ref["m_gt"] > 0)


def test_fixed_chunk_matches_pallas(counts):
    sc, nc = counts
    kw = dict(max_iter=8, min_iter=8, check_every=8)
    r_p, ll_p, it_p = (np.asarray(x) for x in run_em_pallas(EPOCHS, INIT, sc, nc, interpret=True, **kw))
    r_t, ll_t, it_t = (x.numpy() for x in em_kernel.run_em_kernel(EPOCHS, INIT, _t(sc), _t(nc), **kw))
    np.testing.assert_array_equal(it_t, it_p)
    nz = r_p != 0
    rel = np.abs(r_t[nz] - r_p[nz]) / np.abs(r_p[nz])
    assert rel.max() < 1e-4, f"8-iteration chunk deviates {rel.max():.2e}"
    np.testing.assert_array_equal(r_t == 0, r_p == 0)
    assert (np.abs(ll_t - ll_p) / np.abs(ll_p)).max() < 3e-6


def test_convergence_matches_pallas_tiers(counts):
    sc, nc = counts
    a = np.asarray(run_em_pallas(EPOCHS, INIT, sc, nc, check_every=8, interpret=True)[0])
    b = em_kernel.run_em_kernel(EPOCHS, INIT, _t(sc), _t(nc))[0].numpy()
    rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-300)
    strong, weak = a >= 1e-4, a >= 1e-6
    assert strong.sum() >= 4, "problem must have identified epochs"
    assert rel[strong].max() <= 1e-4, f"identified rates deviate {rel[strong].max():.2e}"
    assert rel[weak].max() <= 2e-2, f"weak rates deviate {rel[weak].max():.2e}"
    np.testing.assert_array_equal(a == 0.0, b == 0.0)


def test_twin_is_independent_of_batch(counts):
    """B=6 against B=5: each replicate's chunk is bitwise the same."""
    sc, nc = counts
    sc6, nc6 = np.concatenate([sc, sc[:1]]), np.concatenate([nc, nc[:1]])
    r5, w5 = em_kernel.em_chunk_reference(EPOCHS, _t(np.broadcast_to(INIT, (5, E))), _t(sc), _t(nc), 8)
    r6, w6 = em_kernel.em_chunk_reference(EPOCHS, _t(np.broadcast_to(INIT, (6, E))), _t(sc6), _t(nc6), 8)
    assert torch.equal(r6[:5], r5)
    assert torch.equal(w6[:5], w5)


def test_em_chunk_on_cpu_is_the_twin(counts):
    sc, nc = counts
    rates = _t(np.broadcast_to(INIT, (5, E)))
    before = em_kernel.launches
    r, w = em_kernel.em_chunk(EPOCHS, rates, _t(sc), _t(nc), 8)
    r_ref, w_ref = em_kernel.em_chunk_reference(EPOCHS, rates, _t(sc), _t(nc), 8)
    assert torch.equal(r, r_ref) and torch.equal(w, w_ref)
    assert em_kernel.launches == before  # the twin is not a launch
    assert r.shape == (5, E) and w.shape == (5, 185)
    assert torch.isfinite(r).all() and torch.isfinite(w).all()


@pytest.mark.parametrize("bad", ["float64", "meta", "shape", "epochs"])
def test_em_chunk_rejects_what_the_kernel_does_not_take(counts, bad):
    sc, nc = (_t(x) for x in counts)
    rates = _t(np.broadcast_to(INIT, (5, E)))
    epochs = EPOCHS
    err = ValueError
    if bad == "float64":
        rates, err = rates.double(), TypeError
    elif bad == "meta":
        rates, sc, nc = rates.to("meta"), sc.to("meta"), nc.to("meta")
    elif bad == "shape":
        sc = sc[:, :100].contiguous()
    else:
        epochs = EPOCHS[:-1]
    with pytest.raises(err):
        em_kernel.em_chunk(epochs, rates, sc, nc, 8)


# ---- the whole run: em_run and its plain version ----


def _run_problem():
    """Four replicates of tests/test_torch_em.py's counts, two of them
    bootstrap-jittered: at min_iter=200 they stop after 264 to 752
    iterations, each at its own chunk."""
    from test_torch_em import _counts

    sc, nc = _counts()
    g = np.random.default_rng(5)
    sc = np.concatenate([sc, sc * g.gamma(20, 1 / 20, sc.shape)])
    nc = np.concatenate([nc, nc * g.gamma(20, 1 / 20, nc.shape)])
    return _t(sc), _t(nc)


def _chunked(sc, nc, **kw):
    """ops/em.py:run_em with em_chunk_reference as its chunk step."""
    from colate_tpu_torch.ops.em import run_em

    def step(rates, K):
        new, wsum = em_kernel.em_chunk_reference(EPOCHS, rates.contiguous(), sc, nc, K)
        return new, wsum.to(torch.float64).sum(1)

    return run_em(EPOCHS, INIT, sc, nc, dtype="float32", check_every=8, step=step, device="cpu",
                  **kw)


def test_em_run_reference_matches_the_chunked_run():
    """Each replicate stopping on its own gives, bitwise, what the host
    loop of ops/em.py:run_em gives with the same chunks."""
    sc, nc = _run_problem()
    ours = em_kernel.run_em_kernel(EPOCHS, INIT, sc, nc, min_iter=200)
    ref = _chunked(sc, nc, min_iter=200)
    assert len(set(ours[2].tolist())) == 4, "replicates must stop at different chunks"
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_em_run_resumes_a_cut_run():
    """A run cut at max_iter=400 returns the state of ops/em.py:run_em's
    loop, and resuming it gives the uncut run bitwise."""
    sc, nc = _run_problem()
    full = em_kernel.run_em_kernel(EPOCHS, INIT, sc, nc, min_iter=200)
    state = em_kernel.run_em_kernel(EPOCHS, INIT, sc, nc, min_iter=200, max_iter=400,
                                    return_state=True)
    ref_state = _chunked(sc, nc, min_iter=200, max_iter=400, return_state=True)
    assert state[0] == ref_state[0] == 400
    assert 0 < int(state[3].sum()) < 4
    for a, b in zip(state[1:], ref_state[1:]):
        assert torch.equal(a, b)
    resumed = em_kernel.run_em_kernel(EPOCHS, INIT, sc, nc, min_iter=200, resume_state=state)
    for a, b in zip(resumed, full):
        assert torch.equal(a, b)


def test_em_run_on_cpu_is_the_reference():
    sc, nc = _run_problem()
    B = sc.shape[0]
    state = (
        _t(np.broadcast_to(INIT, (B, E))), torch.full((B,), -np.inf, dtype=torch.float64),
        torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32),
    )
    before = em_kernel.launches
    ours = em_kernel.em_run(EPOCHS, state[0], sc, nc, *state[1:], 0, 304, 8, 8)
    ref = em_kernel.em_run_reference(EPOCHS, state[0], sc, nc, *state[1:], 0, 304, 8, 8)
    assert em_kernel.launches == before
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)
    assert ours[2].tolist() == [False, True, False, False]
    assert ours[3].tolist() == [304, 264, 304, 304]
    with pytest.raises(ValueError, match="em_run: ll"):
        em_kernel.em_run(EPOCHS, state[0], sc, nc, state[1].float(), *state[2:])


def test_hazard_prefix_is_the_warp_scan():
    """The plain version's hazard prefix is the kernel's: per 32-epoch
    group a Hillis-Steele scan over lanes (each lane adds the value `off`
    lanes below it, off = 1, 2, 4, 8, 16), shifted by one lane, plus the
    groups before; within float32 rounding of the sequential sum."""
    g = np.random.default_rng(2)
    dH = g.uniform(0.0, 3.0, (3, 83)).astype(np.float32)
    dH[:, -1] = 0.0
    ours = em_kernel._hazard_prefix(torch.from_numpy(dH)).numpy()
    want = np.zeros_like(dH)
    for b in range(dH.shape[0]):
        carry = np.float32(0.0)
        for e0 in range(0, dH.shape[1], 32):
            x = np.zeros(32, np.float32)
            w = min(32, dH.shape[1] - e0)
            x[:w] = dH[b, e0 : e0 + w]
            for off in (1, 2, 4, 8, 16):
                x = np.concatenate([x[:off], x[off:] + x[:-off]]).astype(np.float32)
            excl = np.concatenate([[np.float32(0.0)], x[:-1]]).astype(np.float32)
            want[b, e0 : e0 + w] = (carry + excl)[:w]
            carry = np.float32(carry + x[31])
    np.testing.assert_array_equal(ours, want)
    seq = np.concatenate([np.zeros((3, 1)), np.cumsum(dH[:, :-1].astype(np.float64), 1)], 1)
    np.testing.assert_allclose(ours, seq, rtol=2e-6)


@pytest.mark.parametrize("bins", ["one-epoch", "3,7,0.05"])
def test_chunk_at_one_and_many_epochs(bins):
    """E=1 and E=83 (three 32-epoch groups): one 8-iteration chunk of the
    plain version against the torch f32 EM of ops/em.py from the same
    rates, within the per-chunk contract of tests/test_em_pallas.py (1e-4
    on nonzero rates).  (Against the f64 EM the open last epoch of E=83,
    which no count identifies, moves 0.64 in every f32 EM.)"""
    from colate_tpu_torch.ops.em import run_em

    epochs = np.zeros(1) if bins == "one-epoch" else epochs_from_bins(bins, 28.0, 0.0)[0]
    n_ep = epochs.shape[0]
    sc, nc = _synthetic_counts(3, seed=7)
    init = np.full(n_ep, INITIAL_COAL_RATE)
    r32, w = em_kernel.em_chunk_reference(epochs, _t(np.broadcast_to(init, (3, n_ep))),
                                          _t(sc), _t(nc), 8)
    ref = run_em(epochs, init, sc.astype(np.float32), nc.astype(np.float32), dtype="float32",
                 max_iter=8, min_iter=8, check_every=8, device="cpu")[0].numpy()
    assert r32.shape == (3, n_ep) and torch.isfinite(r32).all() and torch.isfinite(w).all()
    nz = ref != 0
    assert nz.sum() >= 3 * min(n_ep, 4)
    np.testing.assert_array_equal(r32.numpy() == 0, ~nz)
    rel = np.abs(r32.numpy()[nz] - ref[nz]) / ref[nz]
    assert rel.max() <= 1e-4, f"{bins}: {rel.max():.2e}"
