"""The benchmark of ``ssd_keras_torch`` on one NVIDIA H100.

``python -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``README.md``.
"""
