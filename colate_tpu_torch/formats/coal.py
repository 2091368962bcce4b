"""Reader/writer for ``.coal`` output files.

Layout written by mode mut (reference coal/coal.cpp:3660-3846)::

    0
    <epoch_0> <epoch_1> ... <epoch_{E-1}>
    0 0 <rate_0> ... <rate_{E-1}>
    0 1 <rate_0> ... <rate_{E-1}>        # one row per bootstrap
    ...

For ancient samples (is_ancient) the epoch row is ``0 <epochs[ep_null+1:]>``
and rate rows print from index ep_null with rates[0..ep_null] zeroed.
The tree estimator's Dump (coal_tree.cpp:265-293) uses the same shape with
a group row first.  Values use C++ default formatting (6 significant digits),
printed by the native library.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the most bytes a value takes ("-1.23457e-308") and a label ("-9223372036854775808")
_VALUE_BYTES = 13
_LABEL_BYTES = 20


def format_rows(values: np.ndarray, first: int = 0, labels: np.ndarray | None = None):
    """The rows of ``values`` ([R, C]) as the ``.coal`` prints them, in one
    call of the native formatter (``native/io.cpp:cn_coal_rows``): for each
    row, its two ``labels`` ([R, 2] integers, where given) and a space each,
    then the row's values from column ``first`` on, each as ``f"{x:g}"``
    prints it, joined by single spaces, then ``" \n"``.  Returns (a uint8
    array of the bytes, the values formatted)."""
    from colate_tpu_torch import native

    v = np.ascontiguousarray(values, dtype=np.float64)
    rows, cols = v.shape
    n = max(cols - first, 0)
    if labels is not None:
        labels = np.ascontiguousarray(labels, dtype=np.int64)
        if labels.shape != (rows, 2):
            raise ValueError(f"labels of shape {labels.shape} for {rows} rows")
    cap = rows * (2 * (_LABEL_BYTES + 1) + n * (_VALUE_BYTES + 1) + 2)
    out = np.empty(cap, np.uint8)
    nbytes = native.load().cn_coal_rows(
        v.ctypes.data, rows, cols, first, None if labels is None else labels.ctypes.data,
        out.ctypes.data, cap)
    if nbytes < 0:
        raise RuntimeError(f"cn_coal_rows: {rows} rows did not fit in {cap} bytes")
    return out[:nbytes], rows * n


@dataclasses.dataclass
class CoalFile:
    groups: list[str]
    epochs: np.ndarray  # float64 [E']
    rates: np.ndarray  # float64 [num_rows, E']
    row_labels: list[tuple[int, int]]  # (group, bootstrap/iteration) per row

    @classmethod
    def read(cls, path: str) -> "CoalFile":
        with open(path) as fh:
            lines = [ln.rstrip("\n") for ln in fh]
        groups = lines[0].split()
        epochs = np.array([float(x) for x in lines[1].split()], dtype=np.float64)
        rates = []
        labels = []
        for ln in lines[2:]:
            if not ln.strip():
                continue
            parts = ln.split()
            labels.append((int(parts[0]), int(parts[1])))
            rates.append([float(x) for x in parts[2:]])
        return cls(
            groups=groups,
            epochs=epochs,
            rates=np.array(rates, dtype=np.float64),
            row_labels=labels,
        )

    def write(self, path: str) -> None:
        n = min(len(self.row_labels), len(self.rates))
        epochs, _ = format_rows(np.reshape(self.epochs, (1, -1)))
        with open(path, "wb") as fh:
            fh.write((" ".join(self.groups) + "\n").encode())
            fh.write(epochs)
            if n:
                rows, _ = format_rows(self.rates[:n], labels=np.asarray(self.row_labels[:n]))
                fh.write(rows)


def write_mut_coal(
    path: str,
    epochs: np.ndarray,
    rates: np.ndarray,
    is_ancient: bool = False,
    ep_null: int = 0,
    recorder=None,
) -> None:
    """Write mode-mut output byte-compatibly with coal.cpp:3660-3672/3830-3846.

    rates: [num_bootstrap, E].  The rows are formatted in one native call
    and written at once.  A ``recorder`` (``StageTimer``) gets the counters
    ``coal_bytes`` (the file's bytes) and ``coal_values`` (the values the
    native formatter printed: the epochs' and the rates').
    """
    first = ep_null if is_ancient else 0
    rows = np.array(rates, dtype=np.float64)  # a copy: the ancient rows are zeroed below
    if is_ancient:
        rows[:, : ep_null + 1] = 0.0
    labels = np.zeros((rows.shape[0], 2), np.int64)
    labels[:, 1] = np.arange(rows.shape[0])
    head, n_head = format_rows(
        np.reshape(epochs, (1, -1)), first=ep_null + 1 if is_ancient else 0)
    body, n_body = format_rows(rows, first=first, labels=labels)
    with open(path, "wb") as fh:
        fh.write(b"0\n0 " if is_ancient else b"0\n")
        fh.write(head)
        fh.write(body)
    if recorder is not None:
        recorder.count("coal_bytes", (4 if is_ancient else 2) + head.size + body.size)
        recorder.count("coal_values", n_head + n_body)
