"""BENCHMARK.json keeps to its contract, and every cell finds its files by
name."""

import json
import os
import re

import pytest

from codec_bench import harness
from codec_bench.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def registry():
    return harness.Registry()


def test_top_level_keys_and_command(registry):
    bench = registry.benchmark
    assert set(bench) == KEYS
    assert bench["paths"] == ["codec_bench"]
    assert bench["command"][:3] == ["python3", "-m", "codec_bench.run"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert os.path.getsize(os.path.join(registry.root, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("held_back", [False, True])
def test_names_units_and_texts(registry, tmp_path, held_back):
    if held_back:
        registry = helpers.checkout(str(tmp_path), tiny=False)
    bench = registry.benchmark
    named = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    for cell in bench["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert TEXT.match(cell["why"])
        assert cell["chips"] in (1, 4)
        assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    for config in bench["configs"]:
        assert TEXT.match(config["why"]) and TEXT.match(config["source"])
        assert all(NAME.match(key) for key in config["reduced"])
    for metric in bench["per_layer"]:
        assert TEXT.match(metric["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [entry["name"] for entry in bench[group]]
        assert len(names) == len(set(names))


def test_end_to_end_metrics(registry):
    bench = registry.benchmark
    names = {metric["name"] for metric in bench["end_to_end"]}
    assert names == {"train_mpix_per_s", "setup_s"}
    for metric in bench["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("held_back", [False, True])
def test_every_cell_finds_its_files(registry, tmp_path, held_back):
    """Every cell, and with ``held_back`` the serving cells' entries too."""
    if held_back:
        registry = helpers.checkout(str(tmp_path), tiny=False)
    bench = registry.benchmark
    used = set()
    for cell in bench["workloads"]:
        config = registry.config(cell["config"])
        traffic = registry.traffic(cell["traffic"])
        assert callable(registry.driver(traffic["driver"]).run)
        assert registry.limits(cell["name"])
        assert config["name"] == cell["config"]
        used.add(cell["config"])
        e2e = {metric["name"] for metric in registry.end_to_end(cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.per_layer(cell["name"])
        for metric in registry.per_layer(cell["name"]):
            assert callable(registry.reader(metric["name"]).read)
            assert metric["moves"] in e2e
    assert used == {config["name"] for config in bench["configs"]}


def test_configs_hold_their_files(registry):
    for entry in registry.benchmark["configs"]:
        path = os.path.join(registry.root, entry["file"])
        assert entry["file"].startswith("codec_bench/")
        with open(path) as file:
            config = json.load(file)
        for key in entry["reduced"]:
            assert key in config
        for width in ("nb_maps_1", "nb_maps_2", "nb_maps_3"):
            assert config[width] == 128
        assert os.path.isdir(os.path.join(registry.root, config["serving"]["artifact"]))
