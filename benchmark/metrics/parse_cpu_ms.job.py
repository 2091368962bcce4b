"""Mean over first-pass jobs of the CPU time of the parse's native workers:
the thread CPU time of the spans that the program's recorder holds from
the ``.mut`` prefilter and the ``.colate.in`` join+bin (``MutResult.spans``
named ``prefilter.*`` and ``join_bin.*``), in ms.  Divided by
``parse_ms.job`` it is how many cores the parse kept busy.  None for a
program whose results carry no such spans."""


def read(ctx):
    vals = []
    for j in ctx.jobs:
        spans = getattr(j.result, "spans", None) if j.ok else None
        cpu = [s.cpu_ns for s in spans or ()
               if s.cpu_ns is not None and s.name.startswith(("prefilter.", "join_bin."))]
        if cpu:
            vals.append(sum(cpu))
    if ctx.kind != "first_pass" or not vals:
        return None
    return sum(vals) / len(vals) / 1e6
