"""The torch EM of the port (colate_tpu_torch/ops/em.py) against the JAX
reference (colate_tpu/ops/em.py), on the CPU.

Every input is made with numpy from a seed and handed to both packages.
Tolerances, and why:

- f64 E-step: rtol 1e-12, plus an absolute floor of 1e-12 times the
  largest magnitude of that output.  The reference's closed forms cancel
  where lambda*t << 1 (T1 - t*P), so a one-ulp difference between XLA's
  and torch's exp/expm1 grows there; measured on these inputs the worst
  norm-wise error is ~1e-13.  The floor also absorbs the subnormals that
  XLA's CPU backend flushes to zero and torch keeps.
- f64 run_em: iteration counts equal, rates rtol 1e-9, logl rtol 1e-12 —
  the bounds tests/test_em.py holds the native C++ EM to: reduction orders
  differ and weakly identified epochs amplify ulp differences.
- f32 run_em: the tiers of tests/test_em_f32.py:34-35 (identified rates
  >= 1e-4 within 1e-4, rates >= 1e-6 within 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colate_tpu.config import INITIAL_COAL_RATE, age_bin_centers
from colate_tpu.ops import em as jem
from colate_tpu.ops.epochs import epochs_from_bins
from colate_tpu_torch.ops import em as tem

# tensors here are small: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (a 100x slowdown otherwise)
torch.set_num_threads(1)

EPOCHS, _ = epochs_from_bins("3,7,0.2", 28.0, 0.0)
E = EPOCHS.shape[0]
INIT = np.full(E, INITIAL_COAL_RATE)


def _rates(case: str) -> np.ndarray:
    """[4, E] rates for one E-step scenario."""
    g = np.random.default_rng(sum(map(ord, case)))
    r = np.exp(g.uniform(np.log(1e-5), np.log(1e-2), (4, E)))
    if case == "zero_rates":
        r[0, :3] = 0.0
        r[1, 5:9] = 0.0
        r[2, :] = 0.0
    elif case == "last_epoch_zero":
        r[:, -1] = 0.0
        r[1, -2] = 0.0
    elif case == "underflow":
        # cumulative hazards past exp(-745): survival underflows to 0
        r[0, :] = 0.5
        r[1, 10:] = 5.0
        r[2, -3:] = 1e3
    return r


def _bins():
    t = age_bin_centers()
    k = np.clip(np.searchsorted(EPOCHS, t, side="right") - 1, 0, E - 1)
    return t, k.astype(np.int32)


@pytest.mark.parametrize("case", ["realistic", "zero_rates", "last_epoch_zero", "underflow"])
def test_e_step_f64_matches_jax(case):
    rates = _rates(case)
    t, k = _bins()
    ours = tem.e_step_all_bins(
        torch.from_numpy(EPOCHS), torch.from_numpy(rates),
        torch.from_numpy(t), torch.from_numpy(k).long(),
    )
    ref = jax.vmap(
        lambda r: jem._e_step_all_bins(jnp.asarray(EPOCHS), r, jnp.asarray(t), jnp.asarray(k))
    )(jnp.asarray(rates))
    names = ("num_s", "den_s", "logl_s", "num_n", "den_n", "logl_n")
    for name, a, b in zip(names, ref, ours):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, name
        assert np.isfinite(b).all(), name
        # rtol 1e-12 with a norm-wise floor: see the module docstring
        np.testing.assert_allclose(
            b, a, rtol=1e-12, atol=1e-12 * float(np.abs(a).max()), err_msg=f"{case}: {name}"
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_m_step_matches_jax(seed):
    g = np.random.default_rng(seed)
    B = 5
    num = g.uniform(0, 10, (B, E))
    den = g.uniform(0, 10, (B, E))
    old = g.uniform(0, 1e-3, (B, E))
    num[num < 3] = 0.0  # num == 0 fills forward
    den[den < 2] = 0.0  # den == 0 keeps the old rate
    num[0, :4] = 0.0    # leading num == 0 gives 0
    num[1, :] = 1e-12   # below the floor after the division
    ref = np.stack([
        np.asarray(jem._m_step(jnp.asarray(old[b]), jnp.asarray(num[b]), jnp.asarray(den[b])))
        for b in range(B)
    ])
    ours = tem.m_step(torch.from_numpy(old), torch.from_numpy(num), torch.from_numpy(den))
    # elementwise division, floor and copies only: bit-exact
    np.testing.assert_array_equal(ours.numpy(), ref)


def _counts():
    """Counts drawn around a constant rate of 3e-4 over a broad age
    profile, bootstrap-jittered: 17 of 23 epochs identified (>= 1e-4)."""
    g = np.random.default_rng(3)
    t = age_bin_centers()
    w = 1e3 * np.exp(-0.5 * ((np.log(t + 1e-9) - 7.5) / 2.0) ** 2)
    p = 1.0 - np.exp(-3e-4 * t)
    sc = w * p * g.gamma(20.0, 1 / 20.0, (2, t.shape[0]))
    nc = w * (1.0 - p) * g.gamma(20.0, 1 / 20.0, (2, t.shape[0]))
    sc[:, :7] = 0.0  # empty young bins, as in real data
    return sc, nc


# this problem converges right after min_iter; 1100 keeps a state taken at
# max_iter=1024 in the middle of the run
MIN_ITER = 1100


@pytest.fixture(scope="module")
def jax_f64():
    sc, nc = _counts()
    args = (jnp.asarray(EPOCHS), jnp.asarray(INIT), jnp.asarray(sc), jnp.asarray(nc))
    kw = dict(dtype="float64", min_iter=MIN_ITER)
    full = [np.asarray(x) for x in jem.run_em(*args, **kw)]
    state = [np.asarray(x) for x in jem.run_em(*args, **kw, max_iter=1024, return_state=True)]
    return full, state


def _assert_f64_close(ours, ref):
    r, ll, it = (x.numpy() for x in ours)
    np.testing.assert_array_equal(it, ref[2])
    np.testing.assert_allclose(r, ref[0], rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(ll, ref[1], rtol=1e-12)


def test_run_em_f64_matches_jax(jax_f64):
    sc, nc = _counts()
    ours = tem.run_em(EPOCHS, INIT, sc, nc, dtype="float64", min_iter=MIN_ITER, device="cpu")
    assert ours[0].dtype == torch.float64
    _assert_f64_close(ours, jax_f64[0])


def test_resume_from_jax_state(jax_f64):
    """A JAX mid-run state, taken at max_iter=1024, resumed by the port:
    the same result as JAX's uninterrupted run."""
    full, state = jax_f64
    assert int(state[0]) == 1024 and not state[3].any()
    sc, nc = _counts()
    ours = tem.run_em(
        EPOCHS, INIT, sc, nc, min_iter=MIN_ITER, resume_state=tem.state_from_jax(state),
        device="cpu",
    )
    _assert_f64_close(ours, full)


def test_return_state_matches_jax(jax_f64):
    """The port's own loop state at max_iter=1024 matches JAX's, and
    resuming it gives the same result as resuming JAX's state."""
    full, state = jax_f64
    sc, nc = _counts()
    st = tem.run_em(EPOCHS, INIT, sc, nc, min_iter=MIN_ITER, max_iter=1024, return_state=True,
                    device="cpu")
    assert st[0] == 1024
    np.testing.assert_allclose(st[1].numpy(), state[1], rtol=1e-9)
    np.testing.assert_allclose(st[2].numpy(), state[2], rtol=1e-12)
    np.testing.assert_array_equal(st[3].numpy(), state[3])
    np.testing.assert_array_equal(st[4].numpy(), state[4])
    _assert_f64_close(tem.run_em(EPOCHS, INIT, sc, nc, min_iter=MIN_ITER, resume_state=st,
                                 device="cpu"), full)


def test_run_em_f32_matches_jax_tiers():
    sc, nc = (x.astype(np.float32) for x in _counts())
    ref = np.asarray(
        jem.run_em(jnp.asarray(EPOCHS), jnp.asarray(INIT), jnp.asarray(sc), jnp.asarray(nc), dtype="float32")[0]
    )
    ours = tem.run_em(EPOCHS, INIT, sc, nc, dtype="float32", device="cpu")[0].numpy()
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-300)
    strong, weak = ref >= 1e-4, ref >= 1e-6
    assert strong.sum() >= 4, "problem must have identified epochs"
    assert rel[strong].max() <= 1e-4, f"identified rates deviate {rel[strong].max():.2e}"
    assert rel[weak].max() <= 2e-2, f"weak rates deviate {rel[weak].max():.2e}"
    np.testing.assert_array_equal(ours == 0.0, ref == 0.0)


def test_run_em_native_wrapper_matches_reference_wrapper():
    """The port's ctypes wrapper calls the same C function as the
    reference's: bit-identical results."""
    sc, nc = _counts()
    ours = tem.run_em_native(EPOCHS, INIT, sc, nc)
    ref = jem.run_em_native(EPOCHS, INIT, sc, nc)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
