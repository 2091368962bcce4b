"""The binning kernel's share of its roofline over the traced window: the
least time the card could take for the jobs' binnings (the larger of
their float32 operations over 67 TFLOP/s and their bytes over 3.35 TB/s,
H100 SXM; ``_bin_ops``), counted on the reference's join of the inputs,
which each job's joined sites equal (the check's ``site_gap``), over the
device time of the binning kernels (``seg_hist_kernel`` and
``block_sum_kernel``, csrc/bin_hist.cu) in the trace, in %."""

from benchmark.metrics._bin_ops import bin_bytes, bin_ops
from benchmark.metrics._em_ops import bound_s
from benchmark.reference import join

KERNELS = ("seg_hist_kernel", "block_sum_kernel")


def read(ctx):
    if ctx.kind != "first_pass" or ctx.trace is None:
        return None
    kernel = sum(b - a for name, a, b in ctx.trace.ops if any(k in name for k in KERNELS))
    done = sum(j.ok for j in ctx.jobs)
    if kernel <= 0 or not done:
        return None
    p = ctx.inputs
    sites = join.join(p.chroms, p.muts, p.target_stream, p.reference_stream)
    # the program bins at age 0 on every .colate.in route
    least = bound_s(bin_ops(sites, 0.0), bin_bytes(sites.block, sites.num_blocks))
    return 100.0 * done * least / kernel
