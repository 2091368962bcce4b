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
