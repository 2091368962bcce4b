"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Nothing here is specific to a cell.  A configuration
(``benchmark/configs/<config>.json``), a traffic mix
(``benchmark/traffic/<traffic>.json``), a per-cell set of limits
(``benchmark/limits/<cell>.json``) and each metric
(``benchmark/metrics/<metric>.py``) are found by the names
``BENCHMARK.json`` gives them.
"""
