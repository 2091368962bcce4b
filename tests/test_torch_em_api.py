"""The port's dormant E-steps against colate_tpu's, on the CPU:
``ops/em.py:e_step_interval`` (host float64 numpy), ``e_step_sampled``
(torch, draws from a ``torch.Generator``) and ``ops/em_tree.py``
(float64 numpy).  Inputs are made with numpy from seeds.

Tolerances, and why:

- ``e_step_interval`` and ``em_tree_*``: bitwise equal to the JAX
  package's (the same numpy code).  ``e_step_interval`` also against the
  exact mpmath oracle with tests/test_em_oracle.py's bounds (rtol 1e-6;
  absolute floors 1e-12 on posteriors, 1e-4/1e-6 on exposures).
- ``e_step_sampled``: the JAX key's bits cannot be reproduced, so it is
  held through the ages it returns: each in [age_begin, age_end], and the
  six outputs within rtol 1e-12 (plus a norm-wise floor of 1e-12 times the
  largest magnitude of that output) of ``colate_tpu.ops.em._e_step_all_bins``
  under x64 at those ages: tests/test_torch_em.py's bound for the point
  E-step, whose arithmetic this is.  Against the port's own point E-step at
  those ages: bitwise.
- ``em_tree_shared`` at num_lins = DAF = 1 and a point age against the
  port's point E-step: rtol 2e-3 (tests/test_em_tree.py's bound: the tree
  E-step quantises epochs to the age grid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colate_tpu.ops import em as jem
from colate_tpu.ops import em_tree as jax_em_tree
from colate_tpu_torch.config import AGE_BIN_C, NUM_AGE_BINS, age_bin_edges
from colate_tpu_torch.ops import em as tem
from colate_tpu_torch.ops import em_tree
from colate_tpu_torch.ops.epochs import epochs_from_bins
from helpers.em_oracle import em_oracle
from test_em_oracle import _age_bins_c5, _cmp, _ref_test_epochs

# tensors here are small: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores
torch.set_num_threads(1)

EPOCHS, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
E = EPOCHS.shape[0]
MAGNITUDES = [1e-6, 1e-3, 1e-1]


def _interval_inputs(mag):
    """tests/test_em_oracle.py's interval sweep: piecewise rates around
    mag, every 7th bin against every 11th above it."""
    epochs = _ref_test_epochs()
    g = np.random.default_rng(int(1 / mag) % 2**31)
    rates = mag * np.exp(g.uniform(-1.5, 1.5, epochs.shape[0]))
    ages = _age_bins_c5()
    pairs = [(b1, b2) for b1 in range(0, ages.shape[0], 7)
             for b2 in range(b1 + 1, ages.shape[0], 11)]
    a = np.array([ages[b1] for b1, _ in pairs])
    b = np.array([ages[b2] for _, b2 in pairs])
    return epochs, rates, a, b


# ---- e_step_interval ------------------------------------------------------------

@pytest.mark.parametrize("case", MAGNITUDES + ["all_pairs"])
def test_e_step_interval_is_the_reference(case):
    if case == "all_pairs":
        # the negativity sweep's inputs: every (b1 <= b2) pair, points included
        epochs = _ref_test_epochs()
        rates = np.full(epochs.shape[0], 1e-4)
        ages = _age_bins_c5()
        b1, b2 = np.triu_indices(ages.shape[0])
        a, b = ages[b1], ages[b2]
    else:
        epochs, rates, a, b = _interval_inputs(case)
    ours = tem.e_step_interval(epochs, rates, a, b)
    ref = jem.e_step_interval(epochs, rates, a, b)
    for x, y in zip(ours, ref):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("mag", MAGNITUDES)
def test_e_step_interval_against_the_exact_oracle(mag):
    epochs, rates, a, b = _interval_inputs(mag)
    ns, ds, ls, nn, dn, ln_ = tem.e_step_interval(epochs, rates, a, b)
    for i in range(a.shape[0]):
        o_ns, o_ds, o_ls = em_oracle(epochs, rates, a[i], b[i], True)
        o_nn, o_dn, o_ln = em_oracle(epochs, rates, a[i], b[i], False)
        _cmp(ns[i], o_ns, 1e-6, 1e-12)
        _cmp(ds[i], o_ds, 1e-6, 1e-4)
        assert abs(ls[i] - o_ls) < 1e-6 * max(1.0, abs(o_ls))
        _cmp(nn[i], o_nn, 1e-6, 1e-12)
        _cmp(dn[i], o_dn, 1e-6, 1e-6)
        assert abs(ln_[i] - o_ln) < 1e-6 * max(1.0, abs(o_ln))


# ---- e_step_sampled -------------------------------------------------------------

def _sampled_inputs(seed, draws=4):
    """Rates of a fitted-looking profile; each of the 185 age bins' edge
    intervals ``draws`` times, and a few points (age_begin == age_end)."""
    g = np.random.default_rng(seed)
    rates = 1e-4 * np.exp(g.uniform(-2.0, 2.0, E))
    edges = age_bin_edges()
    a = np.tile(edges[:-1], draws)
    b = np.tile(edges[1:], draws)
    pts = g.uniform(1.0, 1e5, 16)
    return rates, np.concatenate([a, pts]), np.concatenate([b, pts])


def _sampled(rates, a, b, seed):
    gen = torch.Generator().manual_seed(seed)
    return tem.e_step_sampled(torch.from_numpy(EPOCHS), torch.from_numpy(rates), gen,
                              torch.from_numpy(a), torch.from_numpy(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_e_step_sampled_against_the_reference_at_its_ages(seed):
    rates, a, b = _sampled_inputs(seed)
    out = _sampled(rates, a, b, seed)
    t = out[-1].numpy()
    assert t.dtype == np.float64 and t.shape == a.shape
    assert np.all((t >= a) & (t <= b))
    np.testing.assert_array_equal(t[a == b], a[a == b])
    k = np.clip(np.searchsorted(EPOCHS, t, side="right") - 1, 0, E - 1)
    ref = jem._e_step_all_bins(jnp.asarray(EPOCHS), jnp.asarray(rates), jnp.asarray(t),
                               jnp.asarray(k, dtype=jnp.int32))
    point = tem.e_step_all_bins(torch.from_numpy(EPOCHS), torch.from_numpy(rates)[None],
                                out[-1], torch.from_numpy(k))
    names = ("num_s", "den_s", "logl_s", "num_n", "den_n", "logl_n")
    for name, x, y, z in zip(names, out[:-1], ref, point):
        x, y = x.numpy(), np.asarray(y)
        assert x.shape == y.shape and np.isfinite(x).all(), name
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12 * float(np.abs(y).max()),
                                   err_msg=name)
        assert torch.equal(torch.from_numpy(x), z[0]), name


def test_e_step_sampled_draws_from_its_generator():
    rates, a, b = _sampled_inputs(3)
    one, again, other = _sampled(rates, a, b, 7), _sampled(rates, a, b, 7), _sampled(rates, a, b, 8)
    assert all(torch.equal(x, y) for x, y in zip(one, again))
    assert not torch.equal(one[-1], other[-1])


# ---- em_tree ----------------------------------------------------------------------

def _grid_edges():
    t = np.zeros(NUM_AGE_BINS)
    t[1:] = np.exp((np.arange(1, NUM_AGE_BINS) - 1.0) / AGE_BIN_C) / 10.0
    return t


def _tree_inputs(seed):
    """Epochs off the age grid, lineage counts decaying with age, a DAF
    that is 0 above a random bin, and grid-aligned ages."""
    g = np.random.default_rng(seed)
    t = _grid_edges()
    epochs = np.concatenate([[0.0], np.sort(g.uniform(10.0, 1e6, 5))])
    rates = np.exp(g.uniform(np.log(1e-5), np.log(3e-3), epochs.shape[0]))
    k = np.maximum(1.0, g.uniform(10, 40) * np.exp(-np.arange(NUM_AGE_BINS) / 40.0))
    top = int(g.integers(60, 150))
    daf = np.zeros(NUM_AGE_BINS, np.float32)
    daf[:top] = g.uniform(0.1, 1.0, top).astype(np.float32)
    lo = int(g.integers(20, top - 10))
    return epochs, rates, k.astype(np.float32), daf, t[lo], t[int(g.integers(lo, top))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grid_and_epoch_index_is_the_reference(seed):
    epochs = _tree_inputs(seed)[0]
    for x, y in zip(em_tree.grid_and_epoch_index(epochs), jax_em_tree.grid_and_epoch_index(epochs)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("side", ["shared", "notshared"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("ages", ["interval", "point", "zero"])
def test_em_tree_is_the_reference(side, seed, ages):
    epochs, rates, k, daf, a, b = _tree_inputs(seed)
    if ages == "point":
        b = a
    elif ages == "zero":
        a = b = 0.0
    fn = f"em_tree_{side}"
    num, den, logz = getattr(em_tree, fn)(epochs, rates, k, daf, a, b)
    rnum, rden, rlogz = getattr(jax_em_tree, fn)(epochs, rates, k, daf, a, b)
    assert np.array_equal(num, rnum) and np.array_equal(den, rden)
    assert logz == rlogz or (np.isnan(logz) and np.isnan(rlogz))


def test_em_tree_reduces_to_the_point_e_step():
    """tests/test_em_tree.py's degenerate case against the port's own
    point E-step: one lineage and DAF 1 in every bin, epochs on grid
    edges, a grid-aligned point age."""
    t = _grid_edges()
    epochs = np.array([0.0, t[40], t[80], t[120], t[160]])
    rates = np.array([1e-3, 3e-4, 1e-4, 5e-5, 1e-4])
    ones = np.ones(NUM_AGE_BINS, np.float32)
    a = t[100]
    num, den, logz = em_tree.em_tree_shared(epochs, rates, ones, ones, a, a)
    k = np.clip(np.searchsorted(epochs, [a], side="right") - 1, 0, epochs.shape[0] - 1)
    ns, ds, ls, *_ = tem.e_step_all_bins(torch.from_numpy(epochs),
                                         torch.from_numpy(rates)[None],
                                         torch.tensor([a], dtype=torch.float64),
                                         torch.from_numpy(k))
    np.testing.assert_allclose(num, ns[0, 0].numpy(), rtol=2e-3, atol=1e-9)
    np.testing.assert_allclose(den, ds[0, 0].numpy(), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(logz, float(ls[0, 0]), rtol=1e-3)
