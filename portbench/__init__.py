"""The benchmark of the PyTorch/CUDA port (``pose_estimation_amitai_torch``).

One command runs one cell once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the repository root:

* a configuration is ``configs/<config>.json`` (sizes, route, the port's
  ``Config`` fields) and names a model family, whose plain reference and
  work counts are ``families/<family>.py``;
* a traffic mix is ``traffic/<traffic>.json`` (parameters only) and names
  the driver that feeds it to the port's public entry point,
  ``drivers/<driver>.py``;
* a cell's limits for ``correct`` are ``workloads/<cell>.json``;
* a per-layer metric is read by ``layer_metrics/<metric>.py``.

Nothing here imports JAX or the JAX package; the plain references import
nothing of the port.
"""
