"""The benchmark of the PyTorch/CUDA port (``bsi_torch``) on one H100.

Run one cell as ``python -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
names the cells. Everything that belongs to one configuration, model kind,
traffic mix, driver or per-layer metric sits in a file of its own
(``configs/``, ``reference/<kind>.py``, ``workloads/``, ``drivers/``,
``metrics/``, ``limits/``) that the harness finds by its name. ``reference/``
is the plain PyTorch reference that decides ``correct``; it imports nothing
of the port.
"""
