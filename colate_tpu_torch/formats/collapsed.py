"""CollapsedMatrix binary interchange (relate_lib infra parity).

The reference's ``CollapsedMatrix<T>`` (src/collapsed_matrix.hpp:12-302)
is a flattened vector-of-vectors with binary ``DumpToFile`` /
``ReadFromFile``: ``(uint64 rows, uint64 cols, T data[rows*cols])``
(collapsed_matrix.hpp:201-209, 257-270).  The TPU framework's in-memory
equivalent is just a 2-D numpy array; this module provides the
byte-compatible dump/read of the rectangular form so files written by
Relate tooling can be exchanged.
"""

from __future__ import annotations

import numpy as np

_SIZE_T = np.uint64


def write_collapsed(fh, mat: np.ndarray) -> None:
    """Append one matrix in CollapsedMatrix binary layout to an open
    binary file object (collapsed_matrix.hpp:201-209)."""
    mat = np.ascontiguousarray(mat)
    if mat.ndim != 2:
        raise ValueError("CollapsedMatrix dump needs a 2-D array")
    np.asarray([mat.shape[0], mat.shape[1]], _SIZE_T).tofile(fh)
    mat.tofile(fh)


def read_collapsed(fh, dtype=np.float32) -> np.ndarray:
    """Read one matrix written by DumpToFile / write_collapsed
    (collapsed_matrix.hpp:257-270).  ``dtype`` is the element type the
    writer used (the format does not self-describe it, exactly like the
    C++ template)."""
    hdr = np.fromfile(fh, _SIZE_T, 2)
    if hdr.shape[0] != 2:
        raise EOFError("truncated CollapsedMatrix header")
    rows, cols = int(hdr[0]), int(hdr[1])
    data = np.fromfile(fh, dtype, rows * cols)
    if data.shape[0] != rows * cols:
        raise EOFError("truncated CollapsedMatrix payload")
    return data.reshape(rows, cols)
