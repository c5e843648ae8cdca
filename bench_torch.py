#!/usr/bin/env python3
"""Serving bench of the PyTorch/CUDA port: Kodak-24 encode + decode
throughput (Mpix/s) on one NVIDIA GPU, per serving variant, with the
0.05 dB fidelity gate and the true-bitstream serving rows.

    python3 bench_torch.py [--device cuda] [--repeats 5]

prints one JSON object on its last line (the keys of ``bench.py``'s
line, plus ``device`` and ``scan_graph_vs_eager``); see
``autoencoder_based_image_compression_tpu_torch/eval/serving_bench.py``
for what each number is. Without a card it exits 1, unless
``--device cpu`` is given: with ``AEIC_BENCH_SMOKE=1`` that runs every
code path at a tiny size in seconds (numbers meaningless, metric renamed
``SMOKE_...``).
"""

import sys

from autoencoder_based_image_compression_tpu_torch.eval.serving_bench import main

if __name__ == "__main__":
    sys.exit(main())
