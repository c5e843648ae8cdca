"""The benchmark of the PyTorch/CUDA port of the EAE image codec.

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 -m codec_bench.run --workload eae_learned_bw.serve --seed 7 \
        --seconds 20 --trace 0

A cell's files are found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``driver`` names
``drivers/<driver>.py``), ``limits/<cell>.json`` and, for each per-layer
metric, ``metrics/<metric>.py``. The plain reference that decides
``correct`` is ``reference/``; it imports nothing of the port.
"""
