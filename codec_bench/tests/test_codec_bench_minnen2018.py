"""The joint-prior cell on the CPU at a tiny size: its result line, its
faults, its roofline counts, and its control on the card."""

import json
import os

import pytest

from codec_bench import calibrate, roofline_hyperprior, roofline_minnen2018, run
from codec_bench.tests import helpers

CELL = "minnen2018_joint.train_rgb_joint"
TINY = {"batch_size": 2, "crop": 64, "crops": 8, "trace_seconds": 0.3}


def _registry(folder, tiny=True):
    registry = helpers.checkout(folder, tiny=tiny)
    if tiny:
        path = os.path.join(registry.bench_dir, "traffic", "train_rgb_joint.json")
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
    (line, described) = run.execute(registry, CELL, 2 ** 31 + 7, 0.5, trace, "cpu", 0.0)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"grad_gap", "change_gap"} == set(registry.limits(CELL))
    names = {metric["name"] for metric in (registry.per_layer(CELL) if trace
                                           else registry.end_to_end(CELL))}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == {"train_mpix_per_s", "setup_s"}
    else:
        # The CPU trace holds no device kernel: the readers of device time
        # find nothing, and the whole step's share is read from the clock.
        assert "mfu.train" in line["metrics"]
    assert len(described) == 2


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_a_broken_step_is_not_correct(registry, fault):
    context = calibrate.context_for(registry, CELL, 2 ** 31 + 29, 0.3, "cpu")
    driver = registry.driver("train_joint")
    readings = driver.readings(context, fault, calibrate.FAULTS)
    assert any(readings[name] > limit for (name, limit) in registry.limits(CELL).items())


def test_the_initial_weights_are_the_programs_layout(registry):
    import torch

    from autoencoder_based_image_compression_tpu_torch.models import minnen2018

    driver = registry.driver("train_joint")
    config = registry.config("minnen2018_joint")
    weights = driver.initial_weights(torch.Generator().manual_seed(3), config, "cpu")
    assert {name: tuple(value.shape) for (name, value) in weights.items()} == (
        minnen2018.param_shapes())
    assert config["nb_parameters"] == sum(value.numel() for value in weights.values())


def test_the_roofline_counts_the_published_layers():
    macs = roofline_minnen2018.layer_macs(256, 256)
    # 12.97 G MACs an image; the context model's 12 live taps, not 25.
    assert sum(macs.values()) == 12_969_574_400
    assert macs["cm_w"] == 16 * 16 * 12 * 192 * 384
    assert roofline_minnen2018.train_flops(256, 256) == 77_345_587_200
    ratio = roofline_minnen2018.train_flops(256, 256) / roofline_hyperprior.train_flops(256, 256)
    assert 2.2 < ratio < 2.35
    # A step's six sites at 131,072 / 32,768 / 8,192 rows (batch 8): bound
    # by operations at 67 TFLOP/s, 0.379 ms forward and 3x that backward.
    assert roofline_minnen2018.site_rows(8, 256, 256) == [131072, 32768, 8192,
                                                          8192, 32768, 131072]
    assert roofline_minnen2018.gdn_bound_s(8, 256, 256) == pytest.approx(3.786e-4, rel=1e-3)
    assert roofline_minnen2018.gdn_backward_bound_s(8, 256, 256) == pytest.approx(
        3 * roofline_minnen2018.gdn_bound_s(8, 256, 256), rel=1e-6)


@pytest.mark.cuda
def test_the_control_is_not_correct(cuda_device, tmp_path):
    registry = _registry(str(tmp_path), tiny=False)
    context = calibrate.context_for(registry, CELL, 2 ** 31 + 103, 2.0, cuda_device)
    readings = registry.driver("train_joint").readings(context, "control", calibrate.FAULTS)
    assert any(readings[name] > limit for (name, limit) in registry.limits(CELL).items())
