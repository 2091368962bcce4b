"""Set-up: from the process's start to the window's (imports, the inputs
made from the seed, the CUDA context, the kernels' builds, the warm job)."""


def read(ctx):
    return ctx.setup_s
