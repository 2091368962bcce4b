"""The port's ``.colate_mat`` reader (formats/colate_mat.py, one call of
native/io.cpp:cn_colate_mat_read) against ``np.loadtxt`` with the row loop
the JAX package's reader runs, and against that reader itself
(colate_tpu/formats/colate_mat.py): bit for bit (NaN as NaN), on files of
the port's ``%g`` writer, of the benchmark's ``d.ddddde+XX`` cells, of
C++'s default stream output and of ``%.17g``/``%.20e`` round trips; with
values at the edges of a double, line-end and separator variants, fewer
and more replicates than asked for; at one worker and at several.  Files
that are not a matrix of numbers raise ValueError naming the file and the
line.  A rerun's ``colate_mat_workers`` counter: tests/test_torch_spans.py."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

from colate_tpu.formats.colate_mat import read_colate_mat as jax_read_colate_mat
from colate_tpu_torch.config import NUM_AGE_BINS, age_bin_centers
from colate_tpu_torch.formats.colate_mat import read_colate_mat, write_colate_mat
from colate_tpu_torch.utils.progress import StageTimer

EDGES = np.array([0.0, -0.0, 5e-324, 2.2250738585072009e-308, 2.2250738585072014e-308, 1e-300,
                  1e300, 1.7976931348623157e308, np.inf, -np.inf, np.nan, -1.5, 1e-5, 123456.7])


def loadtxt_read(path, num_bootstrap):
    """The reader the port had: ``np.loadtxt``, then a replicate's two rows
    where both are there."""
    vals = np.loadtxt(path, dtype=np.float64, ndmin=2)
    nb = vals.shape[1]
    shared = np.zeros((num_bootstrap, nb), np.float64)
    notshared = np.zeros((num_bootstrap, nb), np.float64)
    for i in range(num_bootstrap):
        if 1 + 2 * i + 1 < vals.shape[0]:
            shared[i] = vals[1 + 2 * i]
            notshared[i] = vals[2 + 2 * i]
    return vals[0], shared, notshared


def assert_same_bits(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        nan = np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), nan)
        np.testing.assert_array_equal(a[~nan].view(np.uint64), b[~nan].view(np.uint64))


def cpp_default(x: float) -> str:
    """``std::ostream << double`` at its default precision (printf's %g;
    glibc writes a NaN with its sign bit as ``-nan``)."""
    if np.isnan(x):
        return "-nan" if np.signbit(x) else "nan"
    return "%g" % x


def write_rows(path, rows, fmt, sep=" ", end=" \n", last_newline=True):
    text = "".join(sep.join(fmt(float(v)) for v in row) + end for row in rows)
    if not last_newline:
        text = text.rstrip("\n")
    with open(path, "w", newline="") as fh:
        fh.write(text)


def counts(seed, reps, nb):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 3.0, (2 * reps, nb)) * 10.0 ** rng.integers(-8, 4, (2 * reps, nb))
    vals[rng.random(vals.shape) < 0.2] = 0.0
    return vals


def read_all(path, num_bootstrap):
    st = StageTimer()
    got = read_colate_mat(str(path), num_bootstrap, recorder=st)
    return got, st.counters["colate_mat_workers"]


FORMATS = {
    "port_g": None,  # formats/colate_mat.py:write_colate_mat
    "sci6": lambda x: "%.5e" % x,  # the benchmark's d.ddddde+XX cells
    "cpp_default": cpp_default,
    "repr17": lambda x: "%.17g" % x,
    "long20": lambda x: "%.20e" % x,
}


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("reps,B", [(3, 3), (2, 5), (6, 2), (1024, 1024)])
def test_bitwise_loadtxt_and_jax_reader(tmp_path, fmt, reps, B):
    """Each writer's file, read with as many, more and fewer replicates
    than it holds; the 1,024-replicate file is the benchmark's shape, read
    by several workers where the process may use several CPUs."""
    path = str(tmp_path / "m.colate_mat")
    vals = counts(reps + B, reps, NUM_AGE_BINS)
    if reps < 1024:
        vals[0, :EDGES.size] = EDGES
    if FORMATS[fmt] is None:
        write_colate_mat(path, age_bin_centers(), vals[0::2], vals[1::2])
    else:
        write_rows(path, np.vstack([age_bin_centers(), vals]), FORMATS[fmt])
    got, workers = read_all(path, B)
    assert_same_bits(got, loadtxt_read(path, B))
    assert_same_bits(got, jax_read_colate_mat(path, B))
    cpus = len(os.sched_getaffinity(0))
    if reps < 1024:
        assert workers == 1
    else:
        assert 1 < workers <= cpus or workers == cpus == 1


TOKENS = ["0", "-0", "+0", "-0.0", "5e-324", "4.9e-324", "2.4703282292062328e-324",
          "2.4703282292062327e-324", "2e-324", "1e-400", "-1e-400", "1e400", "-1e400",
          "1.7976931348623158e308", "1.7976931348623159e308", "2.2250738585072011e-308",
          "1e-300", "1e300", "inf", "-inf", "+inf", "Infinity", "INF", "-Infinity", "nan", "-nan",
          "+nan", "NaN", "NAN", "+1.5", ".5", "5.", "-.5e-3", "1E5", "007", "1e+06", "1.5e-07",
          "0.1", "0.30000000000000004", "9007199254740993", "123456789012345678901234567890",
          "0." + "0" * 300 + "1"]


@pytest.mark.parametrize("layout", ["plain", "no_last_newline", "crlf", "tabs", "lone_cr",
                                    "blank_lines", "ragged_spacing"])
def test_edge_tokens_and_layouts(tmp_path, layout):
    """Edge values written as text, in each line layout np.loadtxt takes."""
    n = len(TOKENS)
    rows = [TOKENS, TOKENS[::-1], TOKENS[1:] + TOKENS[:1], TOKENS[2:] + TOKENS[:2],
            TOKENS[3:] + TOKENS[:3]]
    sep, end = {"tabs": ("\t", "\t\n"), "crlf": (" ", " \r\n"), "lone_cr": (" ", "\r"),
                "ragged_spacing": ("  \t ", " \x0b\x0c \n")}.get(layout, (" ", "\n"))
    text = "".join(sep.join(r) + end for r in rows)
    if layout == "no_last_newline":
        text = text.rstrip("\n")
    if layout == "blank_lines":
        text = "\n  \n" + text.replace("\n", "\n\t\n", 2) + "\n\n"
    path = tmp_path / "edges.colate_mat"
    path.write_bytes(text.encode())
    for B in (1, 2, 3):
        got, workers = read_all(path, B)
        assert got[0].shape == (n,) and workers == 1
        assert_same_bits(got, loadtxt_read(str(path), B))
        assert_same_bits(got, jax_read_colate_mat(str(path), B))


def test_a_missing_not_shared_row_drops_its_replicate(tmp_path):
    """Row 1+2i without row 2+2i: replicate i stays zero, as before."""
    path = tmp_path / "odd.colate_mat"
    path.write_text("1 2\n3 4\n5 6\n7 8\n")
    got, _ = read_all(path, 3)
    assert_same_bits(got, loadtxt_read(str(path), 3))
    assert got[1][1].tolist() == [0.0, 0.0] and got[2][0].tolist() == [5.0, 6.0]


@pytest.mark.parametrize("text,line,what", [
    ("", 1, "no data"),
    (" \n\t\n", 1, "no data"),
    ("1 2 3\n4 5\n6 7 8\n", 2, "2 values, where line 1 has 3"),
    ("1 2\n3 4\n5 6 7\n", 3, "3 values, where line 1 has 2"),
    ("\n1 2\n\n3 4 5\n", 4, "3 values, where line 2 has 2"),
    ("1 2\n3 abc\n", 2, "'abc' is not a number"),
    ("1 2\n3 4 # a comment\n", 2, "'#' is not a number"),
    ("# a comment\n1 2\n", 1, "'#' is not a number"),
    ("1 2\n3 1e\n", 2, "'1e' is not a number"),
    ("1 2\n+-3 4\n", 2, "'+-3' is not a number"),
    ("1 2\n0x10 4\n", 2, "'0x10' is not a number"),
    ("1 2\n1_0 4\n", 2, "'1_0' is not a number"),
    ("1 2\nnan(1) 4\n", 2, "'nan(1)' is not a number"),
    ("1 2\n1.0d5 4\n", 2, "'1.0d5' is not a number"),
    ("1 2\r3 x\r", 2, "'x' is not a number"),
])
def test_not_a_matrix_of_numbers_raises(tmp_path, text, line, what):
    path = tmp_path / "bad.colate_mat"
    path.write_bytes(text.encode())
    with pytest.raises(ValueError) as err:
        read_colate_mat(str(path), 2)
    assert str(err.value) == f"{path}: line {line}: {what}"
    if "#" not in text and text.strip():
        with pytest.raises(ValueError):  # np.loadtxt refused these too
            np.loadtxt(str(path), ndmin=2)


def test_the_first_bad_line_is_named_at_several_workers(tmp_path):
    """Failures in rows that different workers parse: the first line is
    named, whichever worker met it."""
    path = str(tmp_path / "big.colate_mat")
    rows = np.vstack([age_bin_centers(), counts(3, 1024, NUM_AGE_BINS)])
    lines = [" ".join("%g" % v for v in r) + " \n" for r in rows]
    lines[1900] = lines[1900].replace(" ", " oops ", 1)
    lines[700] = " ".join(lines[700].split()[:-1]) + "\n"
    lines[1300] = lines[1300].replace(" ", " x ", 1)
    with open(path, "w") as fh:
        fh.writelines(lines)
    with pytest.raises(ValueError, match=f"^{re.escape(path)}: line 701: 184 values, where line 1 has 185$"):
        read_colate_mat(path, 1024)


def test_a_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="absent.colate_mat"):
        read_colate_mat(str(tmp_path / "absent.colate_mat"), 2)

