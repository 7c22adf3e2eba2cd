"""The benchmark of ``tpu_pattern_matching_torch``: the grep CLI's
streaming scan path, timed on the card and held to a plain reference.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

Cells, metrics and bounds are listed in ``BENCHMARK.json`` at the root of
the checkout; each configuration, traffic mix and metric has a file of its
own under ``perfbench/`` that the harness finds by its name.
"""
