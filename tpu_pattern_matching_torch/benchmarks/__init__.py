"""The port's counterparts of the reference's ``benchmarks/`` scripts:
``run_configs`` (the five BASELINE configs and the feed-only baseline),
``match_dense_bench``, ``bench_ushort``, ``bench_100k``,
``prefix_sum_bench`` and ``exp_bloom`` (the prototype bloom probe, a
kernel of its own). Each runs as ``python -m
tpu_pattern_matching_torch.benchmarks.<name>`` on the card, or with
``--device cpu`` on the plain versions."""
