"""cfbench: the benchmark of ``mymedialite_tpu_torch``, driven by data.

``python3 -m cfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card; see
``cfbench/README.md``.
"""
