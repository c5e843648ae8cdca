"""Runs one cell of ``BENCHMARK.json`` on the card and prints its result.

    python3 -m codec_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared with the reference beside its limit; the same numbers
end standard error. Exits non-zero, printing no result, without enough
cards, when the port cannot be imported, and when JAX or the JAX
package was loaded.
"""

import os
import time


def _process_start():
    """``time.time()`` at which this process started (from ``/proc``),
    else now."""
    try:
        with open("/proc/self/stat") as file:
            ticks = int(file.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as file:
            boot = next(int(line.split()[1]) for line in file if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from codec_bench import harness  # noqa: E402

# The program's kernel build directories are its own, inside the
# checkout; these fix the caches a PyTorch process may write besides.
_CACHE = os.path.join(harness.ROOT, "build", "codec_bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")

import torch  # noqa: E402


def _arguments(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def device_description(device):
    """The result's ``device`` for the card in use: its name, the count,
    and the power limit, which bounds every rate."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": limit}


def execute(registry, cell_name, seed, seconds, trace, device, started):
    """Runs the cell and returns ``(result line, stderr lines)``."""
    cell = registry.cell(cell_name)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    context = harness.Context(cell=cell_name, config=config, traffic=traffic, seed=seed,
                              seconds=seconds, trace=bool(trace), device=device,
                              started=started, root=registry.root)
    run = registry.driver(traffic["driver"]).run(context)
    (correct, checks) = harness.judge(run, registry.limits(cell_name))
    line = harness.result_line(run, registry, cell_name, trace, device_description(device),
                               correct, checks)
    return (line, harness.describe_checks(checks))


def main(argv=None):
    args = _arguments(argv)
    registry = harness.Registry()
    chips = registry.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}.", file=sys.stderr)
        return 2
    (line, described) = execute(registry, args.workload, args.seed, args.seconds, args.trace,
                                "cuda", STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}, which the benchmark forbids.",
              file=sys.stderr)
        return 3
    for text in described:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
