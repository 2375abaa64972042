"""swarmbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 swarmbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card. See
``swarmbench/README.md``.
"""
