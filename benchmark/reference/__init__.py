"""The plain reference of the benchmark: what the program's answers are held
against.  Plain numpy and plain torch (float64), written from Colate's
semantics; imports nothing of the program under test and takes nothing it
made.

- :mod:`.join`: the ``.mut`` row filters and the consumed-record cursor
  join of two ``.colate.in`` streams (Colate's ``parse_tmptmp``);
- :mod:`.binning`: the analytic age-bin histograms of the joined sites;
- :mod:`.bootstrap`: the block bootstrap, the emp redistribution and the
  epoch grid;
- :mod:`.em`: the EM, and its TF32 control;
- :mod:`.compare`: the numbers that decide ``correct``.
"""
