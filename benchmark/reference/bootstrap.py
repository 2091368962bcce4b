"""The block bootstrap, the emp redistribution and the epoch grid of
Colate's mode ``mut``, in numpy.

- Replicate ``b`` draws ``num_blocks`` blocks with replacement and sums the
  block histograms with those multiplicities (coal/coal.cpp:3350-3390); the
  draws are those of ``numpy.random.default_rng(seed)``, ``num_blocks``
  integers a replicate in turn, which is how a run given ``--seed`` draws
  them; one replicate takes every block once.
- The shared mass of the emp sites is moved into the shared histogram in
  proportion to F(bin) = shared_emp / (shared_emp + notshared_emp) times
  the bin's width, from the first bin above the target's age, with
  Colate's index shift: the width of bin b + 1 scales F[b], and the last
  bin keeps its unscaled ratio (coal/coal.cpp:3392-3451).
- ``--bins x,y,step``: epoch boundaries 10^x .. 10^y years by ``step`` in
  log10 (parsed as float32), over the years a generation, after 0; an
  ancient target's age is spliced in, and the boundaries below it are
  counted (``ep_null``, zeroed in the output); the last epoch starts at
  max(1e8, 10 times the last boundary) years (coal/coal.cpp:3503-3646).
"""

from __future__ import annotations

import numpy as np

NUM_AGE_BINS = 185


def block_weights(num_bootstrap: int, num_blocks: int, seed: int) -> np.ndarray:
    """[B, num_blocks] multiplicities."""
    if num_bootstrap == 1:
        return np.ones((1, num_blocks))
    g = np.random.default_rng(seed)
    w = np.zeros((num_bootstrap, num_blocks))
    for b in range(num_bootstrap):
        w[b] = np.bincount(g.integers(0, num_blocks, num_blocks), minlength=num_blocks)
    return w


def age_bin_centers() -> np.ndarray:
    b = np.arange(1, NUM_AGE_BINS, dtype=np.float64)
    return np.concatenate([[0.0], np.exp((b - 1.0) / 10.0) / 10.0])


def redistribute(shared, shared_emp, notshared_emp, age: float) -> np.ndarray:
    """``shared`` [B, 185] plus the emp sites' shared mass."""
    centre = age_bin_centers()
    start = int(np.argmax(centre > age))
    se, ne = shared_emp[:, start:], notshared_emp[:, start:]
    F = np.zeros_like(shared)
    with np.errstate(invalid="ignore", divide="ignore"):
        F[:, start:] = np.where(se > 0, se / (se + ne), 0.0)
    lo = max(start - 1, 0)
    F[:, lo:NUM_AGE_BINS - 1] *= centre[lo + 1:] - centre[lo:NUM_AGE_BINS - 1]
    norm = F.sum(1, keepdims=True)
    total = se.sum(1, keepdims=True)
    F = np.where(norm != 0.0, F / np.where(norm != 0.0, norm, 1.0) * total, 0.0)
    return shared + np.maximum(F, 0.0)


def counts(hists, weights, age: float):
    """The shared and notshared count matrices [B, 185] of the block
    histograms ``hists`` (shared, notshared, shared_emp, notshared_emp)."""
    sh, ns, se, ne = (weights @ h for h in hists)
    return redistribute(sh, se, ne, age), ns


def epochs_from_bins(bins: str, years_per_gen: float, age: float):
    """(epochs [E] float64, ep_null) of ``--bins``; ``age`` in generations."""
    lower, upper, step = (float(np.float32(x)) for x in bins.split(",")[:3])
    ypg = float(np.float32(years_per_gen))
    log_age = np.log(age * ypg) / np.log(10.0) if age > 0 else -np.inf
    epochs, ep_null, placed = [0.0], 0, False
    if log_age < lower and age != 0.0:
        epochs.append(age)
        placed = True
    b = lower
    while b < upper:
        if not placed and b > log_age:
            epochs.append(age)
            if b - log_age < 0.25 * step:
                b += step
            placed = True
        else:
            if not placed:
                ep_null += 1
            epochs.append(np.exp(np.log(10.0) * b) / ypg)
        b += step
    epochs.append(np.exp(np.log(10.0) * upper) / ypg)
    epochs.append(max(1e8, 10.0 * epochs[-1]) / ypg)
    return np.asarray(epochs, np.float64), ep_null


def age_generations(target_age: float, years_per_gen: float) -> float:
    """The target's age in generations, from years parsed as float32."""
    return float(np.float32(target_age)) / float(np.float32(years_per_gen))
