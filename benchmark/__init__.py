"""The benchmark of ``gppe_tpu_torch`` on one NVIDIA H100.

One run is one cell (a configuration under a traffic mix) for a fixed
number of seconds: ``python3 -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything a cell
needs is found by the names in ``BENCHMARK.json``: its configuration under
``configs/``, its traffic under ``traffic/``, its limits under ``limits/``
and the controls they were read against under ``controls/``, the entry its
traffic drives under ``entries/``, the operator its configuration names
under ``operators/``, that operator's plain reference under ``reference/``
and its least-work count under ``work/``, and each per-layer metric's
reader under ``metrics/``. A later cell, mix or metric is
new files and new entries; no file here needs an edit for it.

Nothing here imports ``jax``, ``jaxlib`` or the JAX package ``gppe_tpu``; the
reference imports nothing of ``gppe_tpu_torch``.
"""
