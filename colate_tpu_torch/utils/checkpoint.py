"""Checkpoint/resume for the sufficient-statistic pipeline (copied whole
from colate_tpu/utils/checkpoint.py).

The reference has exactly one resume mechanism: mode `mut` caches its
post-parse count matrix to ``<out>.colate_mat`` and reloads it on rerun
(coal/coal.cpp:3169-3171, 3471-3499).  That text cache is kept for
format parity (formats/colate_mat.py).  This module generalises it the
engine way: the full per-block histograms (shared / notshared /
shared_emp / notshared_emp) are saved as one ``.npz`` keyed by a
fingerprint of the inputs, so an interrupted or re-run job skips the
parse+binning stages entirely — per shard, idempotently — and bootstrap
or EM settings can change without re-parsing.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

FORMAT_VERSION = 1


def input_fingerprint(paths: list[str | None], extra: dict | None = None) -> str:
    """Stable hash over input file identities (path, size, mtime_ns) and
    run parameters that affect the histograms."""
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION}".encode())
    for p in paths:
        if p is None:
            h.update(b"\x00none")
            continue
        try:
            st = os.stat(p)
            h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}".encode())
        except OSError:
            h.update(f"{p}|missing".encode())
    for k in sorted(extra or {}):
        h.update(f"{k}={extra[k]}".encode())
    return h.hexdigest()[:32]


def save_suffstats(
    path: str,
    fingerprint: str,
    shared: np.ndarray,
    notshared: np.ndarray,
    shared_emp: np.ndarray,
    notshared_emp: np.ndarray,
    num_sites: int,
) -> None:
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        fingerprint=np.frombuffer(fingerprint.encode(), np.uint8),
        shared=shared,
        notshared=notshared,
        shared_emp=shared_emp,
        notshared_emp=notshared_emp,
        num_sites=np.int64(num_sites),
    )
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_suffstats(path: str, fingerprint: str):
    """(shared, notshared, shared_emp, notshared_emp, num_sites) or None
    when absent/stale."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            fp = z["fingerprint"].tobytes().decode()
            if fp != fingerprint:
                return None
            return (
                z["shared"],
                z["notshared"],
                z["shared_emp"],
                z["notshared_emp"],
                int(z["num_sites"]),
            )
    except Exception:
        return None
