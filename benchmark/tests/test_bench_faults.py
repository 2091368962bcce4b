"""A run with the timed path broken underneath comes out not correct: the
harness runs on the CPU (the program's plain versions), skipping its look
for a card, at a small size where every replicate of two jobs is compared.
One chip, so no exchange between chips can be left out."""

import numpy as np
import pytest

from benchmark.harness import cell
from benchmark.harness.spec import Spec

CELLS = ("mut_modern_pair.auto", "mut_ancient_panel.rerun")


def _run(repo, name, seed=2**31 + 17):
    import time

    return cell.run(Spec(repo), name, seed, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_repo, name):
    r = _run(small_repo, name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 2


def _unchanged(real):
    def em(epochs, init_rates, sc, nc):
        B = np.asarray(sc).shape[0]
        return np.tile(init_rates, (B, 1)), np.zeros(B), np.ones(B, np.int32)
    return em


def _half_batch(real):
    def em(epochs, init_rates, sc, nc):
        half = np.asarray(sc).shape[0] // 2
        rates, logl, iters = real(epochs, init_rates, sc[:half], nc[:half])
        fill = np.tile(rates.mean(0), (sc.shape[0] - half, 1))
        return (np.concatenate([rates, fill]), np.concatenate([logl, logl[:1].repeat(len(fill))]),
                np.concatenate([iters, iters[:1].repeat(len(fill))]))
    return em


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_broken_em_is_not_correct(small_repo, monkeypatch, name, fault):
    from colate_tpu_torch.models import mut_em

    monkeypatch.setattr(mut_em, "run_em_native", fault(mut_em.run_em_native))
    r = _run(small_repo, name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(small_repo, monkeypatch, name):
    from colate_tpu_torch.models import mut_em

    real = mut_em.write_mut_coal

    def write(path, epochs, rates, **kw):
        rates = np.array(rates)
        rates[3, rates.shape[1] // 2] *= 2.0
        real(path, epochs, rates, **kw)

    monkeypatch.setattr(mut_em, "write_mut_coal", write)
    r = _run(small_repo, name)
    assert not r["correct"], r["checks"]


def test_half_the_sites_left_out_is_not_correct(small_repo, monkeypatch):
    import json
    import os

    from colate_tpu_torch.models import mut_em

    # twelve blocks, so that no replicate draws only blocks that are dropped
    path = os.path.join(small_repo, "benchmark", "configs", "mut_modern_pair.json")
    with open(path) as fh:
        cfg = json.load(fh)
    cfg.update(chromosomes={str(c): 60_000_000 for c in range(1, 7)}, mut_rows_per_bp=1e-4)
    with open(path, "w") as fh:
        json.dump(cfg, fh)

    real = mut_em.fused_tmptmp_stream

    def stream(*a, **kw):
        hists, n, nb = real(*a, **kw)
        # every other block dropped, the rest counted twice
        return tuple(h * (np.arange(nb) % 2 == 0)[:, None] * 2.0 for h in hists), n, nb

    monkeypatch.setattr(mut_em, "fused_tmptmp_stream", stream)
    r = _run(small_repo, "mut_modern_pair.auto")
    assert not r["correct"], r["checks"]


def test_a_failed_job_is_not_correct(small_repo, monkeypatch):
    from colate_tpu_torch.models import mut_em

    real, calls = mut_em.run_mut, []

    def run_mut(cfg, device):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("a lost job")
        return real(cfg, device)

    monkeypatch.setattr(mut_em, "run_mut", run_mut)
    r = _run(small_repo, "mut_ancient_panel.rerun")
    assert not r["correct"] and r["failed"] == 1
