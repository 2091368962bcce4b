"""torch for the port's device code, with TF32 off.

The reference pins ``Precision.HIGHEST`` on every f32 contraction
(colate_tpu/ops/em_pallas.py); TF32 would cut operands to 10 mantissa
bits.  Every module of the port that computes with torch takes torch
from here (``from colate_tpu_torch._torch import torch``), so the switches
hold on every such path, while the host modes, which import none of those
modules, never load torch.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
