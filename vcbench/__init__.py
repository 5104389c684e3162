"""The benchmark of ``seedvc_tpu_torch`` on one NVIDIA H100.

``python -m vcbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every
part a cell names is a file of its own, found by name: the configuration
(``configs/<name>.json`` and the builder it names in ``builders/``), the
traffic mix (``traffic/<name>.json``, read by :mod:`vcbench.traffic`), the
driver of the entry the window drives (``drivers/<kind>.py``) and each
per-layer metric (``metrics/<metric name>.py``). ``ref/`` is the frozen plain
reference the outputs are held against.

Nothing here imports ``jax``, ``flax`` or the JAX package ``seedvc_tpu``.
"""
