"""``--checkpoint`` of the port's mode mut against colate_tpu's, on the CPU.

Under ``--torch_device cpu`` the checkpointed EM is the torch f64 EM, as
the reference's is its JAX f64 EM on the CPU (``--em_dtype auto`` picks
f64 there), so the ``.coal`` must be byte-identical to ``python -m
colate_tpu --checkpoint``.  A run killed after a saved EM chunk and run
again must write the bytes of an uninterrupted run; a rerun on unchanged
inputs must skip parse and binning (``<output>.suffstats.npz``).
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from colate_tpu import cli as jax_cli
from colate_tpu.utils import checkpoint as jax_checkpoint
from colate_tpu_torch import cli
from colate_tpu_torch.models import mut_em
from colate_tpu_torch.utils.checkpoint import input_fingerprint, load_suffstats, save_suffstats
from test_torch_mut import REPO, load_native

# small tensors: one intra-op thread per test process (see test_torch_mut.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    from colate_tpu_torch.fixtures import make_fixture

    load_native()
    return make_fixture(str(tmp_path_factory.mktemp("ckpt")), n_per_chrom=2500, seed=31)


def _argv(fix, out, *extra):
    return [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", "3,7,0.5", "--seed", "3", "--num_bootstraps", "2",
        "--checkpoint", "-o", out, *extra,
    ]


def _port(fix, out, *extra):
    assert cli.main(_argv(fix, out, "--torch_device", "cpu", *extra)) == 0
    return out + ".coal"


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("em_dtype", ["auto", "float64"])
def test_checkpoint_coal_matches_the_reference(fix, tmp_path, capsys, em_dtype):
    ref = str(tmp_path / "jax")
    assert jax_cli.main(_argv(fix, ref, "--em_dtype", em_dtype)) == 0
    capsys.readouterr()
    ours = _port(fix, str(tmp_path / "torch"), "--em_dtype", em_dtype)
    assert "provider=torch:float64(cpu)(checkpointed) " in capsys.readouterr().err
    assert filecmp.cmp(ref + ".coal", ours, shallow=False)
    assert os.path.exists(str(tmp_path / "torch.suffstats.npz"))
    assert not os.path.exists(str(tmp_path / "torch.emstate.npz"))


def test_suffstats_round_trip(fix, tmp_path):
    """The port's cache file round-trips, a stale fingerprint misses, and
    it is the reference's format: the same fingerprint of the same inputs,
    and each package reads the other's file."""
    g = np.random.default_rng(0)
    arrs = [g.random((7, 185)) for _ in range(4)]
    paths = [fix["target"], None, fix["reference"], str(tmp_path / "missing")]
    fp = input_fingerprint(paths, extra={"age": 0.0, "ref_age": 0.0})
    assert fp == jax_checkpoint.input_fingerprint(paths, extra={"age": 0.0, "ref_age": 0.0})
    ours = str(tmp_path / "s.suffstats.npz")
    save_suffstats(ours, fp, *arrs, num_sites=123)
    for load in (load_suffstats, jax_checkpoint.load_suffstats):
        hit = load(ours, fp)
        assert hit[4] == 123
        for a, b in zip(hit[:4], arrs):
            np.testing.assert_array_equal(a, b)
        assert load(ours, "deadbeef" * 4) is None
    theirs = str(tmp_path / "r.suffstats.npz")
    jax_checkpoint.save_suffstats(theirs, fp, *arrs, num_sites=9)
    assert load_suffstats(theirs, fp)[4] == 9


def _count_suffstats(monkeypatch):
    calls = []
    real = mut_em.compute_suffstats

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mut_em, "compute_suffstats", counting)
    return calls


def test_cache_hit_skips_parse_and_binning(fix, tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "run")
    first = _bytes(_port(fix, out))

    def refuse(*a, **k):
        raise AssertionError("compute_suffstats ran on a cache hit")

    monkeypatch.setattr(mut_em, "compute_suffstats", refuse)
    capsys.readouterr()
    assert _bytes(_port(fix, out)) == first
    done = [ln for ln in capsys.readouterr().err.splitlines() if "mut_done " in ln]
    assert len(done) == 1 and "'binning': 0.0" in done[0]


def test_stale_fingerprint_recomputes(fix, tmp_path, monkeypatch):
    """An input whose mtime moved makes the cached histograms stale: the
    rerun parses and bins again, writes the same bytes, and caches again."""
    import shutil

    local = dict(fix)
    local["target"] = str(tmp_path / "target.colate.in")
    shutil.copy(fix["target"], local["target"])
    out = str(tmp_path / "run")
    first = _bytes(_port(local, out))
    with np.load(out + ".suffstats.npz") as z:
        fp0 = z["fingerprint"].tobytes()
    st = os.stat(local["target"])
    os.utime(local["target"], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    calls = _count_suffstats(monkeypatch)
    assert _bytes(_port(local, out)) == first
    assert calls == [1]
    with np.load(out + ".suffstats.npz") as z:
        assert z["fingerprint"].tobytes() != fp0
    _port(local, out)
    assert calls == [1]


def test_killed_run_resumes_to_the_same_bytes(fix, tmp_path):
    """A process killed (exit 17) after the first saved 128-iteration
    chunk leaves ``.emstate.npz``; run again, it resumes from it and
    writes the bytes of an uninterrupted run, then removes the state."""
    whole = _port(fix, str(tmp_path / "whole"))
    out = str(tmp_path / "killed")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", COLATE_EM_CKPT_CHUNK="128")
    cmd = [sys.executable, "-m", "colate_tpu_torch", *_argv(fix, out, "--torch_device", "cpu")]
    r = subprocess.run(cmd, env=dict(env, COLATE_EM_DIE_AFTER_CHUNKS="1"), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 17, r.stderr[-2000:]
    assert os.path.exists(out + ".emstate.npz") and not os.path.exists(out + ".coal")
    with np.load(out + ".emstate.npz") as z:
        assert int(z["it"]) == 128 and not z["conv"].any()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not os.path.exists(out + ".emstate.npz")
    assert filecmp.cmp(whole, out + ".coal", shallow=False)


class Killed(Exception):
    pass


def test_emstate_of_another_provider_is_not_resumed(fix, tmp_path, monkeypatch):
    """The kernel and its plain version are both float32 and not bitwise
    equal, so the state's fingerprint names the EM that wrote it.  A state
    written under the card's provider (``cuda-kernel:float32``), then
    altered to mark every replicate converged at iteration 128, is resumed
    by that provider (the run stops there) and ignored by the CPU's plain
    version, which writes the bytes of an uninterrupted run."""
    whole = _bytes(_port(fix, str(tmp_path / "whole"), "--em_dtype", "float32"))
    out = str(tmp_path / "run")

    def exit_raises(code):
        raise Killed(code)

    def as_card(em_dtype, B, parity, device):
        return "cuda-kernel:float32"

    with monkeypatch.context() as m:
        m.setattr(mut_em, "em_provider", as_card)
        m.setattr(os, "_exit", exit_raises)
        m.setenv("COLATE_EM_DIE_AFTER_CHUNKS", "1")
        m.setenv("COLATE_EM_CKPT_CHUNK", "128")
        with pytest.raises(Killed):
            _port(fix, out, "--em_dtype", "float32")
    state = out + ".emstate.npz"
    with np.load(state) as z:
        saved = {k: z[k] for k in z.files}
    saved["conv"][:] = True
    with open(state, "wb") as fh:
        np.savez(fh, **saved)
    altered = _bytes(state)

    with monkeypatch.context() as m:
        m.setattr(mut_em, "em_provider", as_card)
        resumed = _bytes(_port(fix, out, "--em_dtype", "float32"))
    assert resumed != whole, "the altered state was not resumed by its own provider"

    with open(state, "wb") as fh:
        fh.write(altered)
    assert _bytes(_port(fix, out, "--em_dtype", "float32")) == whole
    assert not os.path.exists(state)
