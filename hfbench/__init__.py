"""The benchmark of ``pytorchhessianfree_tpu_torch`` on one NVIDIA card.

``python3 hfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Configurations, traffic mixes, model families, program entries and
per-layer metrics live in files of their own under this folder, found by the
names that ``BENCHMARK.json`` gives them.
"""
