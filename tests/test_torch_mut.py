"""Mode mut through the port's CLI (python -m colate_tpu_torch) against
the reference CLI (python -m colate_tpu), on the CPU.

The f64 EM of the port follows the reference expression for expression,
so f64 and mc_parity runs must write a byte-identical ``.coal``; the
``auto`` run at B=1 takes the same native host EM in both.  The f32 run
is the kernel's torch twin against the reference's XLA f32 EM, held to
the tiers of tests/test_em_f32.py:34-35.

Every test here that runs the reference's mode mut waits for colate_tpu's
native library first (:func:`load_native`): pytest workers that start
together race to build it, and a worker that loses sees no library for
good.  The port builds its own copy of that library
(colate_tpu_torch/native), atomically and under a lock; the loader tests
here hold that.
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
    """The port's loader latches no failure: after a load that failed, the
    next load gives the library, and mode mut runs byte-identically to the
    reference."""
    from colate_tpu_torch import native

    broken = tmp_path / "libcolate_io.so"
    broken.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native library failed to build or load"):
        native.load(str(broken))
    assert native.load() is not None
    ref, ours, err = _both(fix, tmp_path, capsys)
    assert "provider=native " in err
    assert filecmp.cmp(ref, ours, shallow=False)


def test_native_loaders_race_on_an_empty_build_dir(tmp_path):
    """Four processes that load together on an empty build directory all
    load one whole library: one builds it under the lock, into a temporary
    file renamed into place, and the others wait and load it."""
    code = (
        "import sys\n"
        "from colate_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "lib = native.load()\n"
        "assert lib.cn_em_run is not None\n"
        "print(native.library_path())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e[-2000:] for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    so = paths.pop()
    assert os.path.dirname(so) == str(tmp_path)
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(so), os.path.basename(so) + ".lock"])


@pytest.mark.parametrize("state", ["absent", "broken"])
def test_load_native_raises_at_once_without_a_library(tmp_path, state):
    """The port's loader raises at once, naming the path, when the library
    it is given is absent or does not load."""
    from colate_tpu_torch import native

    so = tmp_path / "libcolate_io.so"
    if state == "broken":
        so.write_bytes(b"not a shared library")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="native library failed to build or load") as exc:
        native.load(str(so))
    assert str(so) in str(exc.value)
    assert time.monotonic() - t0 < 5


def test_suffstats_names_a_missing_native_library(fix, tmp_path, monkeypatch):
    """A build that leaves no loadable library makes the port's suffstats
    raise, naming the library's path."""
    from colate_tpu_torch import native
    from colate_tpu_torch.models.mut_em import suffstats

    def broken_build(so):
        with open(so, "wb") as fh:
            fh.write(b"not a shared library")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_build", broken_build)
    cfg = cli.mut_config(cli.build_parser().parse_args(_argv(fix, os.devnull)))
    with pytest.raises(RuntimeError, match="native library failed to build or load") as exc:
        suffstats(cfg, 3, device="cpu")
    assert native.library_path() in str(exc.value)
    assert native.library_path().startswith(str(tmp_path))


def test_port_never_loads_jax(fix, tmp_path):
    """Importing the port, its fixture module and chip_smoke.py and running
    mode mut under ``--binning auto``, ``device``, ``--sampling mc_parity``
    and ``--checkpoint --devices 2 --binning sharded``, on a single BCF and
    on two BAMs, ``make_tmp`` on a BAM, mode tree (the native walk, and the
    torch program with ancient leaves) and mode local_ancestry (native, and
    the torch program) in a fresh interpreter, with the plain torch
    versions of the kernels, leaves jax and every module of colate_tpu out
    of sys.modules."""
    out = str(tmp_path / "nojax")
    trees = str(tmp_path / "trees")
    tree_argv = ["-i", trees, "--chr", fix["chrfile"], "--bins", "2,6,0.5", "-o", out + "_t",
                 "--torch_device", "cpu"]
    la_argv = ["--mode", "local_ancestry", "-i", trees, "--chr", fix["chrfile"], "--bins",
               "2,6,0.5", "--poplabels", trees + ".poplabels", "--torch_device", "cpu"]
    code = (
        "import importlib.util, sys\n"
        "import colate_tpu_torch, colate_tpu_torch.cli as c\n"
        "import colate_tpu_torch.ops.em, colate_tpu_torch.ops.em_kernel\n"
        "import colate_tpu_torch.ops.bin_kernel, colate_tpu_torch.pipeline.binning\n"
        "import colate_tpu_torch.models.mut_em, colate_tpu_torch.fixtures\n"
        "import colate_tpu_torch.parallel.mesh, colate_tpu_torch.parallel.multihost\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"rc = c.main({_argv(fix, out, '--torch_device', 'cpu', '--em_dtype', 'float32')!r})\n"
        "assert rc == 0, rc\n"
        f"rc = c.main({_argv(fix, out + '_dev', '--torch_device', 'cpu', '--binning', 'device')!r})\n"
        "assert rc == 0, rc\n"
        f"rc = c.main({_argv(fix, out + '_par', '--torch_device', 'cpu', '--sampling', 'mc_parity')!r})\n"
        "assert rc == 0, rc\n"
        f"rc = c.main({_argv(fix, out + '_mesh', '--torch_device', 'cpu', '--checkpoint', '--devices', '2', '--binning', 'sharded')!r})\n"
        "assert rc == 0, rc\n"
        "from colate_tpu_torch.fixtures import make_anc_mut, write_segment_poplabels\n"
        f"make_anc_mut({trees!r}, '1', N=8, num_trees=12, seed=3)\n"
        f"make_anc_mut({trees!r}, '2', N=8, num_trees=12, seed=4, sample_ages=[0, 0, 9, 0, 0, 0, 0, 0])\n"
        f"write_segment_poplabels({trees + '.poplabels'!r}, ['1', '2'], [9000, 9000], 8, 5, seed=1)\n"
        f"assert c.main({['--mode', 'tree'] + tree_argv!r}) == 0\n"
        f"assert c.main({la_argv + ['-o', out + '_la']!r}) == 0\n"
        "from colate_tpu_torch.models.local_ancestry import local_ancestry_estimate\n"
        f"est = local_ancestry_estimate(c.build_parser().parse_args({la_argv + ['-o', out + '_lad']!r}), backend='device')[0]\n"
        "assert est.routes == ['device:cpu', 'numpy-ancient'], est.routes\n"
        "from colate_tpu_torch.fixtures import make_bcf_bam_fixture\n"
        f"bb = make_bcf_bam_fixture({str(tmp_path / 'bb')!r}, n_rows=300, reads_per_contig=1500)\n"
        "base = ['--mut', bb['mut_prefix'], '--chr', bb['chrfile'], '--torch_device', 'cpu']\n"
        "for kind in ('bcf_split', 'bam_bam'):\n"
        f"    assert c.main(['--mode', 'mut', '--bins', '3,7,0.5', *base, *bb['inputs'][kind], '-o', {out!r} + kind]) == 0\n"
        f"assert c.main(['--mode', 'make_tmp', '--target_bam', bb['target_bam'], '--ref_genome', bb['rg_prefix'], *base, '-o', {out!r} + '_mt']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'colate_tpu'))\n"
        "print('LOADED ' + ' '.join(bad) if bad else 'NONE_LOADED')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "NONE_LOADED"
    assert os.path.exists(out + ".coal")
    assert "binning=torch-twin:float32(cpu)" in r.stderr
    assert "binning=mc_parity(host)" in r.stderr
    assert all(os.path.exists(out + x + ".coal") for x in ("_dev", "_par", "_mesh"))
    assert os.path.exists(out + "_mesh.suffstats.npz") and "provider=mesh[2]:torch:float64(cpu) " in r.stderr
    assert "tree_done " in r.stderr and "route=device:cpu,native" in r.stderr
    assert "la_done " in r.stderr and "route=native" in r.stderr
    assert all(os.path.exists(out + x + ".coal") for x in ("_t", "_la"))
    assert all(os.path.exists(out + k + ".colate_mat") for k in ("bcf_split", "bam_bam"))
    assert os.path.exists(out + "_mt.colate.in")


def test_no_jax_import_in_port_sources():
    """No .py file of the port, and not chip_smoke.py, has an import line
    naming jax or colate_tpu (or a module of either)."""
    import re

    bad = re.compile(r"^\s*(import|from)\s+(jax|colate_tpu)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "colate_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                assert not bad.match(line), f"{path}:{i}: {line.strip()}"


@pytest.mark.parametrize("sampling", ["analytic", "mc_parity"])
def test_suffstats_match_the_reference(fix, sampling):
    """The port's compute_suffstats gives the reference's histograms
    exactly: the fused native path under ``auto``, the draw replay under
    ``mc_parity``."""
    from colate_tpu.config import MutRunConfig as JaxConfig
    from colate_tpu.hostrng import MT19937 as JaxMT
    from colate_tpu.models import mut_em as jax_mut
    from colate_tpu_torch.hostrng import MT19937
    from colate_tpu_torch.models import mut_em

    argv = _argv(fix, os.devnull, "--sampling", sampling)
    cfg = cli.mut_config(cli.build_parser().parse_args(argv))
    parity = sampling == "mc_parity"
    ours = mut_em.compute_suffstats(
        cfg, *mut_em.resolve_tmp_inputs(cfg), 0.0, 0.0, parity,
        MT19937(3) if parity else None, 3, {}, "cpu",
    )
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    ref = jax_mut.compute_suffstats(
        jcfg, *jax_mut.resolve_tmp_inputs(jcfg), 0.0, 0.0, parity,
        JaxMT(3) if parity else None, 3, {},
    )
    assert ours[4:] == ref[4:] and ours[4] > 1000
    for a, b in zip(ours[:4], ref[:4]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_fixture_writer_matches_the_reference(tmp_path):
    """colate_tpu_torch.fixtures.make_fixture writes the bytes of
    tests/helpers/synth.make_fixture for the same seed."""
    from colate_tpu_torch.fixtures import make_fixture
    from helpers.synth import make_fixture as ref_fixture

    kw = dict(chroms=("1", "2", "X"), n_per_chrom=1500, seed=41, top_bin_frac=0.01)
    ours = make_fixture(str(tmp_path / "ours"), **kw)
    ref = ref_fixture(str(tmp_path / "ref"), **kw)
    names = sorted(os.listdir(ref["root"]))
    assert names == sorted(os.listdir(ours["root"])) and len(names) == 6
    for name in names:
        assert filecmp.cmp(os.path.join(ours["root"], name), os.path.join(ref["root"], name),
                           shallow=False), name


@pytest.mark.parametrize("em_dtype, B, parity, device, provider", [
    ("auto", 1, False, "cuda", "cuda-kernel:float32"),
    ("auto", 800, False, "cuda", "cuda-kernel:float32"),
    ("auto", 1024, False, "cuda", "cuda-kernel:float32"),
    ("auto", 1, False, "cpu", "native"),
    ("auto", 800, False, "cpu", "native"),
    ("auto", 801, False, "cpu", "torch:float64(cpu)"),
    ("auto", 16, True, "cuda", "torch:float64(cuda)"),
    ("float32", 16, False, "cpu", "torch-twin:float32(cpu)"),
])
def test_em_dispatch(em_dtype, B, parity, device, provider):
    """--em_dtype auto takes the host EM on the CPU only (B <= 800, not
    parity); on a card it takes the CUDA kernel at every B."""
    from colate_tpu_torch.models.mut_em import em_provider

    assert em_provider(em_dtype, B, parity, torch.device(device)) == provider


def test_cuda_without_a_card_raises(fix, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(fix, str(tmp_path / "x"), "--torch_device", "cuda"))
    assert not os.path.exists(str(tmp_path / "x.coal"))


# the 11 modes of --mode's help, and the function of the port that runs each
MODES = {
    "mut": ("colate_tpu_torch.cli", "_run_mut"),
    "make_tmp": ("colate_tpu_torch.models.make_tmp", "run_make_tmp"),
    "preprocess_mut": ("colate_tpu_torch.models.preprocess_mut", "run_preprocess_mut"),
    "print_tmp": ("colate_tpu_torch.models.print_tmp", "run_print_tmp"),
    "compare_tmp": ("colate_tpu_torch.models.compare_tmp", "run_compare_tmp"),
    "count_topo": ("colate_tpu_torch.models.compare_tmp", "run_count_topo"),
    "calc_depth": ("colate_tpu_torch.models.bam_stats", "run_calc_depth"),
    "get_deam": ("colate_tpu_torch.models.bam_stats", "run_get_deam"),
    "CondCoalRates": ("colate_tpu_torch.models.cond_coal", "run_cond_coal"),
    "tree": ("colate_tpu_torch.models.tree_coal", "run_tree_mode"),
    "local_ancestry": ("colate_tpu_torch.models.local_ancestry", "run_local_ancestry"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_every_mode_is_ported(tmp_path, capsys, monkeypatch, mode):
    """Each mode of --help's list reaches its runner through the port's
    parser (the runner stubbed to record its arguments), and none exits
    with a "not ported" error."""
    import importlib

    help_modes = [a for a in cli.build_parser()._actions if a.dest == "mode"][0].help
    assert [m.strip() for m in help_modes.split(",")] == list(MODES)
    module, name = MODES[mode]
    seen = []
    monkeypatch.setattr(importlib.import_module(module), name, lambda args: seen.append(args) or 0)
    assert cli.main(["--mode", mode, "-o", str(tmp_path / "x"), "--torch_device", "cpu"]) == 0
    assert len(seen) == 1 and seen[0].mode == mode and seen[0].output == str(tmp_path / "x")
    assert "not ported" not in capsys.readouterr().err
    assert not hasattr(cli, "NOT_PORTED")


def test_trace_of_the_em(fix, tmp_path, monkeypatch, capsys):
    """COLATE_TPU_TRACE=<dir> writes a torch.profiler trace of the EM there
    and the .coal bytes of a run without it; unset, nothing is written."""
    trace = tmp_path / "trace"
    argv = ["--num_bootstraps", "4", "--torch_device", "cpu"]  # the host EM: quick to trace
    assert cli.main(_argv(fix, str(tmp_path / "plain"), *argv)) == 0
    assert not trace.exists()
    monkeypatch.setenv("COLATE_TPU_TRACE", str(trace))
    assert cli.main(_argv(fix, str(tmp_path / "traced"), *argv)) == 0
    capsys.readouterr()
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    import json

    with open(trace / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert isinstance(events, list)
    assert filecmp.cmp(str(tmp_path / "plain.coal"), str(tmp_path / "traced.coal"), shallow=False)
