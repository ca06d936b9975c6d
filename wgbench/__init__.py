"""The benchmark of ``wholegraph_tpu_torch`` on one NVIDIA H100.

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

  python3 -m wgbench.run --workload sage-products.train --seed 7 --seconds 10 --trace 0

A cell names a configuration (``wgbench/configs/<name>.json``), which
names the build that makes its inputs and the port's objects
(``wgbench/builds/<build>.py``), and a traffic mix
(``wgbench/workloads/<name>.json``), which names its mode
(``wgbench/modes/<mode>.py``); a per-layer metric is a reader of its own
(``wgbench/metrics/<name>.py``); a cell's correctness limits are
``wgbench/limits/<cell>.json``. The harness finds each by the name
``BENCHMARK.json`` gives it. Nothing here imports JAX or the JAX
package, and ``wgbench/reference/`` imports nothing of the port.
"""
