"""colate_tpu_torch — the PyTorch/CUDA port of colate_tpu.

Runs every mode of colate_tpu's CLI, mode ``mut`` and the tree
estimators with PyTorch on an NVIDIA GPU.  It carries its own copy of
colate_tpu's host layer (parsers, native C++, bootstrap, epochs, file
formats, the host modes) and replaces its JAX programs: the EM in plain
torch (ops/em.py), the float32 EM as a hand-written CUDA kernel
(ops/em_kernel.py, csrc/em_step.cu), the analytic binning as another
(ops/bin_kernel.py, csrc/bin_hist.cu) and the tree programs as torch
programs (ops/tree_kernel.py, ops/la_kernel.py).  It imports nothing of
JAX or of colate_tpu.

Importing the package does not import torch: the modules that compute
with torch take it from ``_torch.py``, which turns TF32 off, and the host
modes never reach them.
"""

__version__ = "0.1.0"
