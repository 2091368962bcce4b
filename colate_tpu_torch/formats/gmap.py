"""Recombination-map loader (reference src/data.cpp:135-206): 3 columns
``pos rate gen_pos`` with one header line, optionally gzipped.  Copied
from colate_tpu/formats/gmap.py."""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np


@dataclasses.dataclass
class RecombMap:
    bp: np.ndarray  # int64
    gen_pos: np.ndarray  # float64

    @classmethod
    def load(cls, path: str) -> "RecombMap":
        try:
            with gzip.open(path, "rt") as fh:
                data = fh.read()
        except (OSError, gzip.BadGzipFile):
            with open(path) as fh:
                data = fh.read()
        toks = data.split()
        toks = toks[3:]  # header
        bp = np.array([int(float(x)) for x in toks[0::3]], np.int64)
        gen = np.array([float(x) for x in toks[2::3]], np.float64)
        return cls(bp=bp, gen_pos=gen)
