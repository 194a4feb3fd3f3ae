"""The benchmark of ``repro_torch``, the PyTorch port of FPsPIN.

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell needs is found by name: its workload (``workloads/<cell>.json``), its
configuration (``configs/<config>.json``), its driver
(``drivers/<driver>.py``) and one reader per metric
(``metrics/<metric>.py``).  ``ref/`` holds the yardstick: frozen copies of
the DDT and SLMP framing, the corpus and its packetizer, a plain float32
mamba2, and the FLOP counts and peaks the metrics are read against.  None
of it imports ``jax``, the JAX package or anything of ``repro_torch``.
"""
