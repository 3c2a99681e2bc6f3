"""The benchmark of vnl_tpu_torch on NVIDIA H100s.

One command runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line:

  python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(parameters read by the one generator, ``loops.py``), each per-layer
metric's reader in ``metrics/<metric>.py``.  ``counts/`` holds the work
counts and the published peaks, ``reference/`` the plain reference that
decides ``correct`` (``judge.py``), ``tests/`` the CPU tests.  Nothing here
imports the JAX package or JAX.
"""
