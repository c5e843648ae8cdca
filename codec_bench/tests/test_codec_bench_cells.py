"""Runs of every cell on the CPU at a tiny size, the result line, and a
cell, a traffic mix and a per-layer metric added as new files only."""

import json
import os
import subprocess
import sys

import pytest
import torch

from codec_bench import harness, run, synthetic
from codec_bench.tests import helpers

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return helpers.tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("cell", ["eae_learned_bw.serve", "eae_fixed_bw.ladder_train",
                                  "eae_learned_bw.train", "eae_fixed_bw.serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_with_its_result_line(registry, cell, trace):
    (line, described) = run.execute(registry, cell, 2 ** 31 + 3, 0.5, trace, "cpu", 0.0)
    json.loads(json.dumps(line))
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    expected = (registry.per_layer(cell) if trace else registry.end_to_end(cell))
    names = {metric["name"] for metric in expected}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for (name, entry) in line["checks"].items():
        assert entry["value"] <= entry["limit"]
        assert any(text.startswith(f"check {name}:") for text in described)
    assert set(line["checks"]) == set(registry.limits(cell))
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_cell_traffic_and_metric_from_new_files_only(registry, tmp_path):
    """A later change adds a traffic mix (a data file), a cell (an entry),
    its limits and a per-layer metric (a reader) and edits no file."""
    folder = str(tmp_path)
    new = helpers.tiny_checkout(folder)
    bench_dir = new.bench_dir
    with open(os.path.join(bench_dir, "traffic", "serve.json")) as file:
        traffic = json.load(file)
    traffic.update(images_per_request=4, pool_images=8)
    with open(os.path.join(bench_dir, "traffic", "serve_albums.json"), "w") as file:
        json.dump(traffic, file)
    with open(os.path.join(bench_dir, "limits", "eae_learned_bw.serve_albums.json"), "w") as file:
        json.dump(new.limits("eae_learned_bw.serve"), file)
    with open(os.path.join(bench_dir, "metrics", "requests_per_s.serve.py"), "w") as file:
        file.write("def read(run):\n    return len(run.requests) / run.window_s\n")
    benchmark = dict(new.benchmark)
    benchmark["workloads"] = benchmark["workloads"] + [
        {"name": "eae_learned_bw.serve_albums", "config": "eae_learned_bw",
         "traffic": "serve_albums", "chips": 1, "why": "albums of four"}]
    benchmark["end_to_end"] = [dict(metric, workloads=metric["workloads"] + [
        "eae_learned_bw.serve_albums"]) if "serve_mpix_per_s" == metric["name"] else metric
        for metric in benchmark["end_to_end"]]
    benchmark["per_layer"] = benchmark["per_layer"] + [
        {"name": "requests_per_s.serve", "unit": "1/s", "better": "higher",
         "source": "host_clock", "layer": "pipeline", "moves": "serve_mpix_per_s",
         "workloads": ["eae_learned_bw.serve_albums"]}]
    with open(os.path.join(folder, "BENCHMARK.json"), "w") as file:
        json.dump(benchmark, file)
    added = harness.Registry(root=folder)
    (line, _) = run.execute(added, "eae_learned_bw.serve_albums", 9, 0.5, 0, "cpu", 0.0)
    assert line["correct"] and set(line["metrics"]) == {"serve_mpix_per_s", "setup_s"}
    (line, _) = run.execute(added, "eae_learned_bw.serve_albums", 9, 0.5, 1, "cpu", 0.0)
    assert line["correct"] and line["metrics"]["requests_per_s.serve"]["value"] > 0


def test_without_a_card_it_exits_non_zero_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "eae_learned_bw.train", "--seed", "1", "--seconds", "1"])
    assert code != 0 and capsys.readouterr().out == ""


def test_in_a_folder_of_only_the_benchmark_it_exits_non_zero(tmp_path):
    """Without the port beside it, a run fails and prints no result."""
    import shutil

    shutil.copytree(harness.BENCH_DIR, tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; from codec_bench import run; "
            "sys.exit(run.main(['--workload', 'eae_learned_bw.train', '--seed', '1', "
            "'--seconds', '1']))")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_synthetic_images_repeat_by_seed():
    def draw(seed):
        generator = torch.Generator("cpu").manual_seed(seed)
        return synthetic.luminance_stack(6, 32, 48, generator, "cpu")

    (first, again, other) = (draw(2 ** 31 + 7), draw(2 ** 31 + 7), draw(2 ** 31 + 8))
    assert first.shape == (6, 32, 48, 1) and first.dtype == torch.uint8
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert int(first.min()) >= 16 and int(first.max()) <= 235
