"""Mode mut through the port's CLI (python -m colate_tpu_torch) against
the reference CLI (python -m colate_tpu), on the CPU.

The f64 EM of the port follows the reference expression for expression,
so f64 and mc_parity runs must write a byte-identical ``.coal``; the
``auto`` run at B=1 takes the same native host EM in both.  The f32 run
is the kernel's torch twin against the reference's XLA f32 EM, held to
the tiers of tests/test_em_f32.py:34-35.

Every test here that runs mode mut waits for colate_tpu's native library
first (:func:`load_native`): pytest workers that start together race to
build it, and a worker that loses sees no library for good.
"""

import filecmp
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from colate_tpu import cli as jax_cli
from colate_tpu.formats.coal import CoalFile
from colate_tpu_torch import cli

# tensors here are small: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (a 100x slowdown otherwise)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_native(timeout: float = 900.0, quiet: float = 3.0):
    """colate_tpu's native library, loaded in this process.

    colate_tpu/native builds ``libcolate_io.so`` in place at the first
    ``load()`` of any process, so pytest workers that start together race:
    one may load a file another is still writing, and ``load()`` then
    returns None for the rest of that process (``_tried`` is latched).
    While the file is being written this waits until nobody has written
    it for ``quiet`` seconds; then it clears the latch and loads again.
    It raises at once when the file is absent (the build failed) or when
    a load of a finished file fails."""
    from colate_tpu import native

    so = os.environ.get("COLATE_NATIVE_SO", native._SO)
    deadline = time.monotonic() + timeout
    finished = False  # a load was retried on a file nobody was writing
    while (lib := native.load()) is None:
        failed = RuntimeError(f"native library failed to build or load: {so}")
        if not os.path.exists(so):
            raise failed
        if time.time() - os.path.getmtime(so) > quiet:
            if finished:
                raise failed
            finished = True
        while time.time() - os.path.getmtime(so) <= quiet:
            if time.monotonic() >= deadline:
                raise failed
            time.sleep(0.5)
        native._lib, native._tried = None, False
    return lib


@pytest.fixture(scope="module")
def native_lib():
    return load_native()


@pytest.fixture(scope="module")
def fix(tmp_path_factory, native_lib):
    from helpers.synth import make_fixture

    return make_fixture(str(tmp_path_factory.mktemp("torchmut")), n_per_chrom=3000, seed=5)


def _argv(fix, out, *extra):
    return [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", "3,7,0.2", "--seed", "3",
        "-o", out, *extra,
    ]


def _both(fix, tmp_path, capsys, *extra):
    """Runs both CLIs; returns (reference .coal, port .coal, port stderr)."""
    ref = str(tmp_path / "jax")
    ours = str(tmp_path / "torch")
    assert jax_cli.main(_argv(fix, ref, *extra)) == 0
    capsys.readouterr()
    assert cli.main(_argv(fix, ours, *extra, "--torch_device", "cpu")) == 0
    return ref + ".coal", ours + ".coal", capsys.readouterr().err


@pytest.mark.parametrize("extra, provider", [
    (("--em_dtype", "float64", "--num_bootstraps", "8"), "torch:float64(cpu)"),
    (("--sampling", "mc_parity", "--num_bootstraps", "4"), "torch:float64(cpu)"),
    ((), "native"),
], ids=["float64-B8", "mc_parity-B4", "auto-B1"])
def test_coal_byte_identical(fix, tmp_path, capsys, extra, provider):
    ref, ours, err = _both(fix, tmp_path, capsys, *extra)
    assert f"provider={provider} " in err
    assert filecmp.cmp(ref, ours, shallow=False)


def test_float32_within_tiers(fix, tmp_path, capsys):
    ref, ours, err = _both(fix, tmp_path, capsys, "--em_dtype", "float32", "--num_bootstraps", "8")
    assert "provider=torch-twin:float32(cpu) " in err
    a = CoalFile.read(ref).rates
    b = CoalFile.read(ours).rates
    assert a.shape == b.shape == (8, 23)
    rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-300)
    strong, weak = a >= 1e-4, a >= 1e-6
    assert strong.sum() >= 4, "fixture must have identified epochs"
    assert rel[strong].max() <= 1e-4, f"identified rates deviate {rel[strong].max():.2e}"
    assert rel[weak].max() <= 2e-2, f"weak rates deviate {rel[weak].max():.2e}"
    np.testing.assert_array_equal(a == 0.0, b == 0.0)


def test_recovers_from_a_latched_native_load(fix, tmp_path, capsys, monkeypatch):
    """A worker whose first load() lost the build race (library file
    present, ``_lib`` None, ``_tried`` True) runs mode mut once
    :func:`load_native` has reloaded the library."""
    from colate_tpu import native

    assert os.path.exists(os.environ.get("COLATE_NATIVE_SO", native._SO))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert native.load() is None
    assert load_native() is not None
    ref, ours, err = _both(fix, tmp_path, capsys)
    assert "provider=native " in err
    assert filecmp.cmp(ref, ours, shallow=False)


@pytest.mark.parametrize("state", ["absent", "broken"])
def test_load_native_raises_at_once_without_a_library(tmp_path, monkeypatch, state):
    """No wait when the library is absent or a finished file does not load."""
    from colate_tpu import native

    so = tmp_path / "libcolate_io.so"
    if state == "broken":
        so.write_bytes(b"not a shared library")
        os.utime(so, (time.time() - 60, time.time() - 60))
    monkeypatch.setenv("COLATE_NATIVE_SO", str(so))
    monkeypatch.delenv("COLATE_NATIVE_REQUIRED", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="native library failed to build or load") as exc:
        load_native()
    assert str(so) in str(exc.value)
    assert time.monotonic() - t0 < 5


def test_suffstats_names_a_missing_native_library(fix, monkeypatch):
    from colate_tpu import native
    from colate_tpu_torch.models.mut_em import suffstats

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    cfg = cli.mut_config(cli.build_parser().parse_args(_argv(fix, os.devnull)))
    with pytest.raises(RuntimeError, match="native library failed to build or load") as exc:
        suffstats(cfg, 3, device="cpu")
    assert os.environ.get("COLATE_NATIVE_SO", native._SO) in str(exc.value)


def test_port_never_loads_jax(fix, tmp_path):
    """Importing the port and running mode mut in a fresh interpreter, with
    the EM's and the binning's plain torch versions, leaves jax out of
    sys.modules."""
    out = str(tmp_path / "nojax")
    code = (
        "import sys\n"
        "import colate_tpu_torch, colate_tpu_torch.cli as c\n"
        "import colate_tpu_torch.ops.em, colate_tpu_torch.ops.em_kernel\n"
        "import colate_tpu_torch.ops.bin_kernel, colate_tpu_torch.pipeline.binning\n"
        "import colate_tpu_torch.models.mut_em\n"
        f"rc = c.main({_argv(fix, out, '--torch_device', 'cpu', '--em_dtype', 'float32')!r})\n"
        "assert rc == 0, rc\n"
        f"rc = c.main({_argv(fix, out + '_dev', '--torch_device', 'cpu', '--binning', 'device')!r})\n"
        "assert rc == 0, rc\n"
        "print('JAX_LOADED' if 'jax' in sys.modules else 'JAX_ABSENT')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "JAX_ABSENT"
    assert os.path.exists(out + ".coal")
    assert "binning=torch-twin:float32(cpu)" in r.stderr
    assert os.path.exists(out + "_dev.coal")


def test_no_jax_import_in_port_sources():
    pkg = os.path.join(REPO, "colate_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not (s.startswith("import jax") or s.startswith("from jax")), name


def test_cuda_without_a_card_raises(fix, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(fix, str(tmp_path / "x"), "--torch_device", "cuda"))
    assert not os.path.exists(str(tmp_path / "x.coal"))


@pytest.mark.parametrize("extra", [
    ("--devices", "2"),
    ("--checkpoint",),
    ("--coordinator", "localhost:1234", "--num_processes", "2", "--process_id", "0"),
], ids=["devices", "checkpoint", "multiprocess"])
def test_unported_flags_exit_nonzero(fix, tmp_path, capsys, extra):
    out = str(tmp_path / "x")
    assert cli.main(_argv(fix, out, "--torch_device", "cpu", *extra)) != 0
    assert "ROADMAP" in capsys.readouterr().err
    assert not os.path.exists(out + ".coal")


@pytest.mark.parametrize("mode", ["tree", "make_tmp", "CondCoalRates"])
def test_unported_modes_exit_nonzero(tmp_path, capsys, mode):
    assert cli.main(["--mode", mode, "-o", str(tmp_path / "x"), "--torch_device", "cpu"]) != 0
    assert "ROADMAP" in capsys.readouterr().err
