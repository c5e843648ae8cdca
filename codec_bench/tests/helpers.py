"""A benchmark checkout in a temporary folder, with the serving cells held
back and tiny traffic, for runs on the CPU."""

import json
import os
import shutil

from codec_bench import harness

# Each traffic mix cut to a size the CPU runs in a second or two.
TINY = {
    "serve": {"images_per_request": 2, "height": 64, "width": 96, "pool_images": 4,
              "batch_size": 2, "warmup_requests": 1, "kept_share": 0.5, "trace_seconds": 0.3},
    "train": {"batch_size": 2, "crop": 32, "crops": 8, "trace_seconds": 0.3},
    "ladder_train": {"batch_size": 2, "crop": 32, "crops": 8, "trace_seconds": 0.3},
}


def checkout(folder, tiny=True):
    """A copy of the benchmark under ``folder`` whose ``BENCHMARK.json``
    also holds the serving cells' entries (``serving_cells.json``: the
    cells held back, which come back as entries alone), its traffic mixes
    cut to :data:`TINY` unless ``tiny`` is false; returns its
    :class:`harness.Registry`."""
    bench = os.path.join(folder, "codec_bench")
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(harness.ROOT, "results"), os.path.join(folder, "results"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as file:
        benchmark = json.load(file)
    with open(os.path.join(bench, "serving_cells.json")) as file:
        for (group, entries) in json.load(file).items():
            benchmark[group] = entries + benchmark[group]
    with open(os.path.join(folder, "BENCHMARK.json"), "w") as file:
        json.dump(benchmark, file)
    for (name, sizes) in TINY.items() if tiny else ():
        path = os.path.join(bench, "traffic", f"{name}.json")
        with open(path) as file:
            traffic = json.load(file)
        traffic.update(sizes)
        with open(path, "w") as file:
            json.dump(traffic, file)
    return harness.Registry(root=folder)


def tiny_checkout(folder):
    return checkout(folder, tiny=True)
