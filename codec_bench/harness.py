"""What every cell shares: finding a cell's files by name, the record a
driver fills, the comparison against the limits, the result line.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` is made of files
found by name under the benchmark's folder:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  model, where its trained parameters are, the precision it is served
  and trained in;
- ``traffic/<traffic>.json``: the traffic's parameters and the
  ``driver`` that runs it, ``drivers/<driver>.py`` (a ``run(context)``
  that returns a :class:`Run`);
- ``limits/<cell>.json``: the limit of each number compared with the
  reference;
- ``metrics/<metric>.py`` for each per-layer metric, or for a metric
  split by the end-to-end metric it moves (``<base>.<split>``) the
  ``metrics/<base>.py`` its splits share: a ``read(run)`` that returns
  the number, or None where the run has nothing to read.

Adding a cell, a traffic mix or a per-layer metric adds such files and
entries, and edits none.
"""

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that must never be loaded in a run: JAX and the
# JAX package the port was made from (compared whole: the port's own
# name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "autoencoder_based_image_compression_tpu")
PORT = "autoencoder_based_image_compression_tpu_torch"


def _load_json(path):
    with open(path) as file:
        return json.load(file)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Registry:
    """The files of one benchmark folder: ``root`` holds ``BENCHMARK.json``
    and ``bench_dir`` the cells' files (``codec_bench/`` of ``root``
    unless given)."""

    def __init__(self, root=ROOT, bench_dir=None):
        self.root = root
        self.bench_dir = bench_dir or os.path.join(root, "codec_bench")
        self.benchmark = _load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name):
        for cell in self.benchmark["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for config in self.benchmark["configs"]:
            if config["name"] == name:
                return _load_json(os.path.join(self.root, config["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return _load_json(os.path.join(self.bench_dir, "traffic", f"{name}.json"))

    def limits(self, cell):
        return _load_json(os.path.join(self.bench_dir, "limits", f"{cell}.json"))

    def driver(self, name):
        return _load_module(os.path.join(self.bench_dir, "drivers", f"{name}.py"),
                            f"codec_bench_driver_{name}")

    def reader(self, metric):
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        if not os.path.exists(path) and "." in metric:
            metric = metric.rsplit(".", 1)[0]
            path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        return _load_module(path, "codec_bench_metric_" + metric.replace(".", "_"))

    def end_to_end(self, cell):
        """The cell's end-to-end metrics: those without a ``workloads``
        list and those whose list names it."""
        return [metric for metric in self.benchmark["end_to_end"]
                if cell in metric.get("workloads", [cell])]

    def per_layer(self, cell):
        return [metric for metric in self.benchmark["per_layer"]
                if cell in metric.get("workloads", [cell])]


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's files, the run's arguments and
    the process's start time (``time.time()`` seconds)."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float
    root: str = ROOT


@dataclasses.dataclass
class Run:
    """What a driver measured and compared.

    ``metrics`` holds the end-to-end numbers (and a serving run's
    ``request_p95_ms``), ``checks`` each number compared with the
    reference; the rest is what the per-layer readers read:
    ``window_s``, ``work`` (over
    the whole window: ``mpix``, the model-pixels served or trained, and
    ``flops``, ``{dtype: FLOPs}``), ``requests`` (serving: each
    request's ``wall``, ``coder`` and ``fetch_wait`` seconds), and with
    ``--trace 1`` the ``trace`` (``codec_bench.trace.Trace``) and
    ``traced`` (the same work counts over the traced units, with
    ``gdn_bound_s``, the least time of their GDN launches)."""

    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    metrics: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    requests: list = dataclasses.field(default_factory=list)
    trace: object = None
    traced: dict = dataclasses.field(default_factory=dict)


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def judge(run, limits):
    """``(correct, checks)``: every number compared at or under its limit,
    none missing, and no attempt failed. ``checks`` maps each name to
    ``{"value": v, "limit": l}``."""
    checks = {}
    correct = run.failed == 0 and run.attempted > 0
    for (name, limit) in limits.items():
        value = run.checks.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            correct = False
    return (correct, checks)


def result_line(run, registry, cell, trace, device, correct, checks):
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``--trace 1`` the ``breakdown``, and the
    numbers compared last."""
    units = {metric["name"]: metric["unit"]
             for metric in registry.benchmark["end_to_end"] + registry.benchmark["per_layer"]}
    if trace:
        values = {}
        for metric in registry.per_layer(cell):
            value = registry.reader(metric["name"]).read(run)
            if value is not None:
                values[metric["name"]] = value
    else:
        values = dict(run.metrics, setup_s=run.setup_s)
        values = {metric["name"]: values[metric["name"]] for metric in registry.end_to_end(cell)
                  if metric["name"] in values}
    line = {"correct": bool(correct), "attempted": int(run.attempted),
            "failed": int(run.failed),
            "metrics": {name: {"value": float(value), "unit": units[name]}
                        for (name, value) in values.items()},
            "device": dict(device, memory_peak_bytes=int(run.memory_peak_bytes))}
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s()
        line["device"]["window_s"] = run.trace.window_s()
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    return line


def describe_checks(checks):
    """One line a number compared: its name, value and limit."""
    return [f"check {name}: {entry['value']!r} (limit {entry['limit']!r})"
            for (name, entry) in checks.items()]
