"""Mean of a rerun's wall time outside its EM (the ``.colate_mat`` read,
the epochs, the ``.coal`` write, the driver), in ms."""


def read(ctx):
    vals = [j.wall - j.timings["em"] for j in ctx.jobs if j.ok and "em" in j.timings]
    if ctx.kind != "rerun" or not vals:
        return None
    return sum(vals) / len(vals) * 1e3
