"""Reader/writer for the ``.colate_mat`` sufficient-statistic cache.

Layout (reference coal/coal.cpp:3437-3470, text, space-separated):
row 0: the 185 age-bin representative ages; then per bootstrap two rows,
age_shared_count and age_notshared_count (each already divided by
norm=1e3).  The reference reloads this to skip the parse stage
(coal.cpp:3471-3499); we honour the same cache.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from colate_tpu_torch.config import NUM_AGE_BINS


def write_colate_mat(
    path: str,
    age_bins: np.ndarray,
    shared: np.ndarray,
    notshared: np.ndarray,
) -> None:
    """shared/notshared: [num_bootstrap, num_age_bins], already normalised."""

    def fmt(x: float) -> str:
        return f"{x:g}"

    with open(path, "w") as fh:
        fh.write(" ".join(fmt(a) for a in age_bins) + " \n")
        for i in range(shared.shape[0]):
            fh.write(" ".join(fmt(v) for v in shared[i]) + " \n")
            fh.write(" ".join(fmt(v) for v in notshared[i]) + " \n")


def read_colate_mat(path: str, num_bootstrap: int, recorder=None):
    """Returns (age_bins, shared [B,bins], notshared [B,bins]).

    One call of the native reader (``native/io.cpp:cn_colate_mat_read``),
    which parses the rows on as many workers as the file's size and the
    CPUs the process may use allow, straight into these arrays: the values
    of ``np.loadtxt``, bit for bit.  Replicates the file lacks (or holds
    only the shared row of) stay zero; rows past ``2 * num_bootstrap`` are
    dropped.  Raises FileNotFoundError where the file cannot be opened,
    and ValueError, naming the file and the line, where the file is
    empty, a row has another number of values than row 0, or a token is
    not a number (``#`` too).  A ``recorder`` (``StageTimer``) gets the counter ``colate_mat_workers``.
    """
    from colate_tpu_torch import native

    lib = native.load()
    errbuf = ctypes.create_string_buffer(1024)
    width = ctypes.c_int64(NUM_AGE_BINS)
    workers = 0
    while workers == 0:  # 0: row 0 is not as wide as asked; width holds its width
        nb = width.value
        age_bins = np.empty(nb, np.float64)
        shared = np.zeros((num_bootstrap, nb), np.float64)
        notshared = np.zeros((num_bootstrap, nb), np.float64)
        workers = lib.cn_colate_mat_read(
            os.fsencode(path), num_bootstrap, nb, age_bins.ctypes.data, shared.ctypes.data,
            notshared.ctypes.data, ctypes.byref(width), errbuf, len(errbuf))
    if workers < 0:
        msg = errbuf.value.decode(errors="replace")
        raise FileNotFoundError(msg) if workers == -1 else ValueError(msg)
    if recorder is not None:
        recorder.count("colate_mat_workers", workers)
    return age_bins, shared, notshared
