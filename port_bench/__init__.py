"""The benchmark of ``photon_tpu_torch`` on one NVIDIA H100.

``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name: its configuration
(``configs/``), its traffic mix (``mixes/``, which names the window's entry
in ``entries/``), the limits of its correctness checks (``limits/``) and
one reader per metric (``metrics/``). The inputs come from ``gen/``, the
work counts and the H100's peaks from ``counts/``, and the plain PyTorch
reference that decides ``correct`` from ``reference/``. Nothing here
imports JAX or the JAX package; only ``entries/`` imports the port.
"""
