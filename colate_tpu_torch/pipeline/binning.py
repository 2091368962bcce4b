"""Site evidence to per-block age-bin histograms, on a torch device.

Port of colate_tpu/pipeline/binning.py:bin_sites_analytic.  The host packs
the site stream (ops/bin_kernel.py:pack_sites), copies it to ``device``
once, and the device bins it: the CUDA kernel on a card, its plain torch
version on the CPU.  The reference's slab streaming and pooled,
pre-faulted pack buffers worked around a ~30 ms cost per host-to-device
transfer of the TPU host and are not carried over.

The host C++ binning in float64, ``bin_sites_analytic_native``, is
colate_tpu's and is used as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from colate_tpu.pipeline.binning import bin_sites_analytic_native  # noqa: F401  (reused)
from colate_tpu_torch.ops.bin_kernel import bin_chunks, pack_sites


def bin_sites_analytic(sites, age: float = 0.0, device: str | torch.device = "cpu"):
    """The four [num_blocks, 185] float64 histograms (shared, notshared,
    shared_emp, notshared_emp) of a colate_tpu ``JoinedSites``, binned on
    ``device``.  Raises past MAX_BLOCKS blocks, as the reference does."""
    packed = pack_sites(sites, age).to(torch.device(device))
    hists = bin_chunks(packed).cpu().numpy()
    return tuple(np.ascontiguousarray(hists[:, j]) for j in range(4))
