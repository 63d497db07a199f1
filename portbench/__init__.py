"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  A cell's configuration,
traffic and per-layer metrics are data and small readers found by name:
``configs/<config>.json``, ``workloads/<cell>.json`` and
``metrics/<metric>.py``.
"""
