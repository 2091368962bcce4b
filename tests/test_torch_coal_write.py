"""The port's ``.coal`` writers (formats/coal.py: ``write_mut_coal`` and
``CoalFile.write``, whose values the native ``io.cpp:cn_coal_rows`` formats)
against the JAX package's writers (colate_tpu/formats/coal.py, Python's
``f"{x:g}"`` a value), byte for byte: the modern and the ancient layouts,
one row, a rerun's 1,024 rows and a number between,
one epoch and 23; rates over exponents 1e-300 to 1e300 and the values
where ``%g`` turns (zeros of both signs, infinities, NaNs of both signs,
the smallest denormal, ties and rounding boundaries).  An unwritable path
raises OSError; the counters the writer gives its recorder match the
file."""

from __future__ import annotations

import os

import numpy as np
import pytest

from colate_tpu.formats.coal import CoalFile as JaxCoalFile
from colate_tpu.formats.coal import write_mut_coal as jax_write_mut_coal
from colate_tpu_torch import native
from colate_tpu_torch.formats.coal import CoalFile, format_rows, write_mut_coal
from colate_tpu_torch.utils.progress import StageTimer

EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 5e-324, 1234565.0, 123456.5,
                  999999.5, 9.999995e-5, 1e-5, 1e16])
# is_ancient, ep_null (None: E - 2)
LAYOUTS = {"modern": (False, 0), "ancient0": (True, 0), "ancient5": (True, 5),
           "ancient_e2": (True, None)}


def random_values(rng, shape):
    """Normals scaled by 10^-300 to 10^300, with the edge values down the
    last column and across the last row."""
    v = rng.standard_normal(shape) * 10.0 ** rng.uniform(-300, 300, shape)
    k1, k2 = min(len(EDGES), shape[0]), min(len(EDGES), shape[1])
    v[-k1:, -1] = EDGES[:k1]
    v[-1, -k2:] = EDGES[:k2]
    return v


def layouts():
    for E in (1, 23):
        for name, (anc, ep_null) in LAYOUTS.items():
            if ep_null is None:
                if E < 3:
                    continue  # E - 2 would not be a later epoch than the first
                ep_null = E - 2
            yield pytest.param(E, anc, ep_null, id=f"{name}-E{E}")


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("B", [1, 300, 1024])
@pytest.mark.parametrize("E,is_ancient,ep_null", list(layouts()))
def test_write_mut_coal_bytes_are_the_jax_writers(tmp_path, B, E, is_ancient, ep_null):
    rng = np.random.default_rng(B * 100 + E * 10 + ep_null)
    epochs = np.concatenate([[0.0], random_values(rng, (1, E))[0, 1:]])
    rates = random_values(rng, (B, E))
    kept = rates.copy()
    write_mut_coal(str(tmp_path / "port.coal"), epochs, rates, is_ancient, ep_null)
    jax_write_mut_coal(str(tmp_path / "jax.coal"), epochs, rates, is_ancient, ep_null)
    assert read(tmp_path / "port.coal") == read(tmp_path / "jax.coal")
    np.testing.assert_array_equal(rates, kept)  # the caller's rates are not zeroed


@pytest.mark.parametrize("is_ancient,ep_null", [(False, 0), (True, 5)])
def test_every_edge_value_in_every_printed_column(tmp_path, is_ancient, ep_null):
    """Each edge value in each column: the rows are the edges rotated."""
    n = len(EDGES)
    rates = np.stack([np.roll(EDGES, k) for k in range(n)])
    epochs = np.roll(EDGES, 3)
    write_mut_coal(str(tmp_path / "port.coal"), epochs, rates, is_ancient, ep_null)
    jax_write_mut_coal(str(tmp_path / "jax.coal"), epochs, rates, is_ancient, ep_null)
    assert read(tmp_path / "port.coal") == read(tmp_path / "jax.coal")
    assert b"-nan" not in read(tmp_path / "port.coal")


def test_float32_rates_print_as_the_jax_writer_prints_them(tmp_path):
    rng = np.random.default_rng(4)
    rates = (10.0 ** rng.uniform(-30, 30, (64, 23))).astype(np.float32)
    epochs = np.linspace(0.0, 7.0, 23).astype(np.float32)
    write_mut_coal(str(tmp_path / "port.coal"), epochs, rates, True, 5)
    jax_write_mut_coal(str(tmp_path / "jax.coal"), epochs, rates, True, 5)
    assert read(tmp_path / "port.coal") == read(tmp_path / "jax.coal")


@pytest.mark.parametrize("rows", [0, 1, 300])
@pytest.mark.parametrize("E", [1, 23])
def test_coal_file_write_bytes_are_the_jax_writers(tmp_path, rows, E):
    rng = np.random.default_rng(rows + E)
    labels = [(int(g), int(i)) for g, i in zip(rng.integers(0, 3, rows), range(rows))]
    if rows:
        labels[0] = (-(2**63), 2**63 - 1)
    groups = ["0", "pop_a", "pop_b"]
    epochs = random_values(rng, (1, E))[0]
    rates = random_values(rng, (rows, E)) if rows else np.array([], np.float64)
    CoalFile(groups, epochs, rates, labels).write(str(tmp_path / "port.coal"))
    JaxCoalFile(groups, epochs, rates, labels).write(str(tmp_path / "jax.coal"))
    assert read(tmp_path / "port.coal") == read(tmp_path / "jax.coal")


def test_coal_file_round_trips(tmp_path):
    rng = np.random.default_rng(9)
    rates = np.round(10.0 ** rng.uniform(-6, -2, (5, 23)), 9)
    cf = CoalFile(["0"], np.linspace(0.0, 7.0, 23), rates, [(0, i) for i in range(5)])
    cf.write(str(tmp_path / "a.coal"))
    back = CoalFile.read(str(tmp_path / "a.coal"))
    assert back.row_labels == cf.row_labels
    back.write(str(tmp_path / "b.coal"))
    assert read(tmp_path / "a.coal") == read(tmp_path / "b.coal")


@pytest.mark.parametrize("where", ["missing_dir", "a_directory"])
def test_an_unwritable_path_raises_oserror(tmp_path, where):
    path = str(tmp_path / "absent" / "x.coal") if where == "missing_dir" else str(tmp_path)
    with pytest.raises(OSError):
        write_mut_coal(path, np.zeros(3), np.ones((2, 3)))
    with pytest.raises(OSError):
        CoalFile(["0"], np.zeros(3), np.ones((2, 3)), [(0, 0), (0, 1)]).write(path)


@pytest.mark.parametrize("is_ancient,ep_null", [(False, 0), (True, 5)])
@pytest.mark.parametrize("B", [1, 1024])
def test_counters_match_the_file(tmp_path, B, is_ancient, ep_null):
    """``coal_bytes`` is the file's size; ``coal_values`` the numbers in
    it but the first line, the ancient epoch row's leading ``0`` and each
    row's two labels."""
    rng = np.random.default_rng(B)
    path = str(tmp_path / "c.coal")
    st = StageTimer()
    write_mut_coal(path, np.linspace(0.0, 7.0, 23), random_values(rng, (B, 23)), is_ancient,
                   ep_null, recorder=st)
    lines = read(path).decode().splitlines()
    values = len(lines[1].split()) - is_ancient + sum(len(ln.split()) - 2 for ln in lines[2:])
    assert st.counters["coal_bytes"] == os.path.getsize(path)
    assert st.counters["coal_values"] == values == 23 - is_ancient * (ep_null + 1) + B * (
        23 - is_ancient * ep_null)


@pytest.mark.parametrize("rows", [1, 1024])
def test_the_native_formatter_refuses_a_short_buffer(rows):
    """One byte short of the rows' size, the native call writes nothing
    past its buffer and returns -1."""
    v = np.full((rows, 23), -1.23456e-300)
    labels = np.full((rows, 2), -(2**63), np.int64)
    want, _ = format_rows(v, labels=labels)
    lib = native.load()
    out = np.zeros(want.size + 64, np.uint8)
    n = lib.cn_coal_rows(v.ctypes.data, rows, 23, 0, labels.ctypes.data, out.ctypes.data,
                         want.size - 1)
    assert n == -1
    assert not out[want.size - 1:].any()
    n = lib.cn_coal_rows(v.ctypes.data, rows, 23, 0, labels.ctypes.data, out.ctypes.data,
                         want.size)
    assert n == want.size and bytes(out[:n]) == bytes(want)
