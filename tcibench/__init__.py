"""The benchmark of ``tci_tpu_torch``: closed-loop TCI solves, one cell of
``BENCHMARK.json`` a run (``python3 tcibench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``)."""
