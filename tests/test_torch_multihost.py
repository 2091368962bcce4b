"""Mode mut of the port as one process per rank (parallel/multihost.py),
on the CPU: ranks joined over gloo on localhost, each binning its
chromosomes, the histograms merged with one all_reduce.

The ranks' block ranges are disjoint, so the merge is exact and rank 0's
``.coal`` must be byte-identical to the single-process port's and to
``python -m colate_tpu``'s.  Every process here runs under a subprocess
timeout, and the process group under its own (multihost.TIMEOUT), so a
dead rank fails the test instead of hanging it.
"""

import filecmp
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from colate_tpu import cli as jax_cli
from colate_tpu.parallel import multihost as jax_multihost
from colate_tpu_torch import cli
from colate_tpu_torch.parallel import multihost
from test_torch_mut import REPO, load_native

# small tensors: one intra-op thread per test process (see test_torch_mut.py)
torch.set_num_threads(1)

TIMEOUT = 300  # seconds a rank may take


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    from colate_tpu_torch.fixtures import make_fixture

    load_native()
    return make_fixture(str(tmp_path_factory.mktemp("mh")), chroms=("1", "2"), n_per_chrom=2500,
                        seed=42)


def _argv(fix, out, *extra):
    return [
        "--mode", "mut", "--mut", fix["mut_prefix"],
        "--target_tmp", fix["target"], "--reference_tmp", fix["reference"],
        "--chr", fix["chrfile"], "--bins", "3,7,0.25", "--num_bootstraps", "3",
        "-o", out, *extra,
    ]


def _port_argv(fix, out, *extra):
    return _argv(fix, out, "--torch_device", "cpu", *extra)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _ranks(cmd_of_rank, n: int) -> list[str]:
    """Runs n processes together; returns their standard outputs."""
    procs = [subprocess.Popen(cmd_of_rank(i), env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, se[-2000:]
            outs.append(so)
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return outs


def _cli_ranks(fix, out, n, *extra):
    port = _free_port()
    _ranks(lambda i: [sys.executable, "-m", "colate_tpu_torch", *_port_argv(fix, out, *extra),
                      "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(n),
                      "--process_id", str(i)], n)


@pytest.mark.parametrize("n", [2, 3], ids=["2-ranks", "3-ranks-2-chromosomes"])
def test_ranks_write_the_single_process_coal(fix, tmp_path, n):
    """2 ranks bin a chromosome each; 3 ranks on 2 chromosomes leave rank
    0 an empty shard.  Rank 0's .coal is the single-process port's and
    colate_tpu's, byte for byte."""
    multi = str(tmp_path / "multi")
    _cli_ranks(fix, multi, n, "--seed", "7")
    single = str(tmp_path / "single")
    assert cli.main(_port_argv(fix, single, "--seed", "7")) == 0
    ref = str(tmp_path / "jax")
    assert jax_cli.main(_argv(fix, ref, "--seed", "7")) == 0
    assert filecmp.cmp(single + ".coal", multi + ".coal", shallow=False)
    assert filecmp.cmp(ref + ".coal", multi + ".coal", shallow=False)


_WORKER = textwrap.dedent(
    """
    import hashlib, json, sys
    from colate_tpu_torch import cli
    from colate_tpu_torch.parallel.multihost import init_distributed, run_mut_multihost
    rank, n, port, argv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4:]
    init_distributed(f"127.0.0.1:{port}", n, rank)
    res = run_mut_multihost(cli.mut_config(cli.build_parser().parse_args(argv)), "cpu")
    print(json.dumps({"rank": rank, "sites": res.num_sites, "blocks": res.num_blocks,
                      "rates": hashlib.sha256(res.rates.tobytes()).hexdigest()}))
    """
)


def test_ranks_agree_without_a_seed(fix, tmp_path):
    """With --seed omitted every rank takes seed 1 (a seed drawn per rank
    from time and pid would give each rank its own bootstrap): the ranks'
    rates are bitwise equal, and rank 0's .coal is a --seed 1 run's."""
    out = str(tmp_path / "noseed")
    port = _free_port()
    outs = _ranks(lambda i: [sys.executable, "-c", _WORKER, str(i), "2", str(port),
                             *_port_argv(fix, out)], 2)
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert res[0]["sites"] == res[1]["sites"] > 1000 and res[0]["blocks"] == res[1]["blocks"] > 1
    assert res[0]["rates"] == res[1]["rates"]
    single = str(tmp_path / "seed1")
    assert cli.main(_port_argv(fix, single, "--seed", "1")) == 0
    assert filecmp.cmp(single + ".coal", out + ".coal", shallow=False)


def test_partition_chromosomes_matches_the_reference():
    for n_chroms in range(0, 8):
        chroms = [str(c) for c in range(n_chroms)]
        for nproc in range(1, 6):
            for pid in range(nproc):
                assert multihost.partition_chromosomes(chroms, nproc, pid) == \
                    jax_multihost.partition_chromosomes(chroms, nproc, pid)
