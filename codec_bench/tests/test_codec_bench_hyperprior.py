"""The scale-hyperprior cell on the CPU at a tiny size: its result line,
its faults, and its control on the card."""

import json
import os

import pytest

from codec_bench import calibrate, run
from codec_bench.tests import helpers

CELL = "balle2018_hyperprior.train_rgb"
TINY = {"batch_size": 2, "crop": 64, "crops": 8, "trace_seconds": 0.3}


def _registry(folder, tiny=True):
    registry = helpers.checkout(folder, tiny=tiny)
    if tiny:
        path = os.path.join(registry.bench_dir, "traffic", "train_rgb.json")
        with open(path) as file:
            traffic = json.load(file)
        traffic.update(TINY)
        with open(path, "w") as file:
            json.dump(traffic, file)
    return registry


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return _registry(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_with_its_result_line(registry, trace):
    (line, described) = run.execute(registry, CELL, 2 ** 31 + 5, 0.5, trace, "cpu", 0.0)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"grad_gap", "change_gap"} == set(registry.limits(CELL))
    names = {metric["name"] for metric in (registry.per_layer(CELL) if trace
                                           else registry.end_to_end(CELL))}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == {"train_mpix_per_s", "setup_s"}
    assert len(described) == 2


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_a_broken_step_is_not_correct(registry, fault):
    context = calibrate.context_for(registry, CELL, 2 ** 31 + 23, 0.3, "cpu")
    driver = registry.driver("train_hyperprior")
    readings = driver.readings(context, fault, calibrate.FAULTS)
    assert any(readings[name] > limit for (name, limit) in registry.limits(CELL).items())


@pytest.mark.cuda
def test_the_control_is_not_correct(cuda_device, tmp_path):
    registry = _registry(str(tmp_path), tiny=False)
    context = calibrate.context_for(registry, CELL, 2 ** 31 + 101, 2.0, cuda_device)
    readings = registry.driver("train_hyperprior").readings(context, "control",
                                                            calibrate.FAULTS)
    assert any(readings[name] > limit for (name, limit) in registry.limits(CELL).items())
