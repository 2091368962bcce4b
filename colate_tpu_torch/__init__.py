"""colate_tpu_torch — the PyTorch/CUDA port of colate_tpu.

Runs mode ``mut`` end to end with PyTorch on an NVIDIA GPU, reusing
colate_tpu's host layer (parsers, native C++, bootstrap, epochs, file
formats) and replacing its JAX programs: the EM in plain torch
(ops/em.py) and the fused float32 EM step as a hand-written CUDA kernel
(ops/em_kernel.py, csrc/em_step.cu).  It never imports JAX.
"""

import torch

# the reference pins Precision.HIGHEST on every f32 contraction
# (colate_tpu/ops/em_pallas.py); TF32 would cut operands to 10 mantissa bits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
