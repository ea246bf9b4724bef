"""gpbench: the benchmark of abstractgps_tpu_torch on NVIDIA GPUs.

``python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON result line. Every
piece of a cell is found by the names in ``BENCHMARK.json``: a
configuration's file, its family's port adapter (``families/``), plain
reference (``reference/``) and operation counts (``counts/``), a traffic
mix's data file (``traffic/``) and the generator it names
(``generators/``), a cell's limits (``limits/``), and one reader per
per-layer metric (``metrics/``).
"""
