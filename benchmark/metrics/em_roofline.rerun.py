"""The EM kernel's share of its roofline over the traced window: the least
time the card could take for the reruns' EMs (the larger of their float32
operations over 67 TFLOP/s and their bytes over 3.35 TB/s, H100 SXM) over
the device time of the kernel (``em_kernel``) in the trace, in %."""

import numpy as np

from benchmark.metrics._em_ops import bound_s, em_bytes, em_ops, bin_epochs


def read(ctx):
    if ctx.kind != "rerun" or ctx.trace is None:
        return None
    kernel = sum(b - a for name, a, b in ctx.trace.ops if "em_kernel" in name)
    least = 0.0
    for j in ctx.jobs:
        if not j.ok:
            continue
        res = j.result
        B, E = res.rates.shape
        sc, nc = ctx.inputs.shared[j.pair], ctx.inputs.notshared[j.pair]
        ops = em_ops(bin_epochs(res.epochs), E, np.float32(sc), np.float32(nc), res.iterations)
        least += bound_s(ops, em_bytes(B, E))
    if kernel <= 0 or least <= 0:
        return None
    return 100.0 * least / kernel
