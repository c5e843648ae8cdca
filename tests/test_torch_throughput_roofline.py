"""PyTorch port: the roofline accounting and the throughput / parity
measurements against the JAX package's, and the benchmark CLI."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os

import jax
import numpy
import pytest
import torch

from autoencoder_based_image_compression_tpu.eval import roofline as jax_roofline
from autoencoder_based_image_compression_tpu.eval import throughput as jax_throughput
from autoencoder_based_image_compression_tpu.train.checkpoint import (
    load_params_artifact as jax_load_params_artifact,
)
from autoencoder_based_image_compression_tpu_torch.cli import benchmark
from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.eval import roofline, throughput
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    load_params_artifact,
    params_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000",
                       "params_trained.npz")


def _models():
    (params_jax, bin_widths) = jax_load_params_artifact(LEARNED)
    (params_np, _) = load_params_artifact(LEARNED)
    return (params_jax, params_from_jax(params_np), numpy.asarray(bin_widths))


@pytest.mark.parametrize("learn_bin_widths", [True, False])
@pytest.mark.parametrize("height,width", [(64, 64), (256, 256), (512, 768)])
def test_conv_eae_flops_equal_jax(height, width, learn_bin_widths):
    assert roofline.conv_eae_flops(height, width, learn_bin_widths) == \
        jax_roofline.conv_eae_flops(height, width, learn_bin_widths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_measure_matmul_peak_runs_small(dtype):
    peak = roofline.measure_matmul_peak(size=64, dtype=dtype, repeats=1, nb_chained=2,
                                        device="cpu")
    assert numpy.isfinite(peak) and peak > 0.0


def test_time_with_checksum_counts_every_execution():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0

    seconds = throughput.time_with_checksum(fn, torch.ones(8), repeats=3, nb_in_flight=2)
    assert seconds > 0.0 and len(calls) == 1 + 3 * 2
    with pytest.raises(FloatingPointError):
        throughput.time_with_checksum(lambda x: x / 0.0, torch.ones(2), repeats=1)


@pytest.mark.parametrize("weight_mode", ["bf16w", "bf16w+", "int8"])
def test_parity_and_throughput_matches_jax(weight_mode):
    (params_jax, params, bin_widths) = _models()
    images = synthetic_luminance_stack(2, 64, 96, seed=5)
    expected = jax_throughput.parity_and_throughput(params_jax, images, bin_widths, repeats=1,
                                                    weight_mode=weight_mode)
    got = throughput.parity_and_throughput(params, images, bin_widths, repeats=1,
                                           weight_mode=weight_mode, device="cpu")
    assert set(got) == set(expected) == {"mpix_per_s_parity", "mpix_per_s_fast",
                                         "psnr_fast_vs_parity_db", "weight_mode"}
    assert got["weight_mode"] == weight_mode
    assert got["mpix_per_s_parity"] > 0.0 and got["mpix_per_s_fast"] > 0.0
    print(weight_mode, "PSNR between the paths: port", got["psnr_fast_vs_parity_db"],
          "JAX", expected["psnr_fast_vs_parity_db"])
    # How far a variant's reconstruction sits from the fp32 path's, in
    # both packages: the same rounding sites, other summation orders, a
    # few other symbol flips. Within 1.5 dB of each other at 40-60 dB;
    # the port's bf16w+ keeps tconv_4 fp32, so it may only sit higher.
    if weight_mode == "bf16w+":
        assert got["psnr_fast_vs_parity_db"] >= expected["psnr_fast_vs_parity_db"] - 1.5
    else:
        assert abs(got["psnr_fast_vs_parity_db"] - expected["psnr_fast_vs_parity_db"]) <= 1.5


def test_roofline_report_structure():
    (_, params, bin_widths) = _models()
    images = synthetic_luminance_stack(1, 32, 32, seed=6)
    report = roofline.roofline_report(params, images, bin_widths, repeats=1,
                                      peak_flops={"parity": 1e12, "fast": 2e12},
                                      nb_in_flight=1, weight_mode="bf16w+", device="cpu")
    jax_keys = set(jax_roofline.roofline_report(
        jax_load_params_artifact(LEARNED)[0], images, bin_widths, repeats=1,
        peak_flops={"parity": 1e12, "fast": 1e12}, nb_in_flight=1))
    renamed = {key.replace("mxu_utilization", "tensor_core_utilization") for key in jax_keys}
    assert set(report) == renamed | {"weight_mode"}
    assert report["flops_per_pixel"] == pytest.approx(
        roofline.conv_eae_flops(32, 32, True) / (32 * 32))
    assert report["achieved_flops_per_s_fast"] == pytest.approx(
        report["tensor_core_utilization_fast"] * 2e12)
    assert report["achieved_flops_per_s_parity"] == pytest.approx(
        report["mpix_per_s_parity"] * 1e6 * report["flops_per_pixel"])
    assert report["mpix_per_s_parity"] > 0.0


def test_benchmark_cli_parity_prints_one_json_line(capsys):
    benchmark.main(["parity", "--nb_images", "1", "--height", "32", "--width", "48",
                    "--device", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["weight_mode"] == "bf16w" and result["mpix_per_s_fast"] > 0.0


def test_benchmark_cli_profile_writes_a_trace(tmp_path, capsys):
    benchmark.main(["profile", "--nb_images", "4", "--height", "32", "--width", "32",
                    "--trace_dir", str(tmp_path / "trace"), "--device", "cpu"])
    assert "trace written to" in capsys.readouterr().out
    with open(tmp_path / "trace" / "roundtrip_trace.json") as file:
        assert json.load(file)["traceEvents"]


def test_benchmark_cli_profile_default_trace_dir_is_under_the_working_directory(
        tmp_path, monkeypatch, capsys):
    """Without ``--trace_dir`` the trace goes under the directory the
    command runs from, never to a fixed system path that two checkouts
    (or this package and the reference) would share."""
    monkeypatch.chdir(tmp_path)
    benchmark.main(["profile", "--nb_images", "4", "--height", "32", "--width", "32",
                    "--device", "cpu"])
    said = capsys.readouterr().out.strip().rsplit(" ", 1)[-1]
    assert not os.path.isabs(said)
    assert os.path.isfile(tmp_path / "build" / "aeic_trace" / "roundtrip_trace.json")


def test_benchmark_cli_scaling_raises_and_cuda_is_the_default(capsys):
    """``scaling`` runs over the distributed layer now (it raised before the
    port had one); without a card the default device still raises."""
    benchmark.main(["scaling", "--height", "32", "--width", "48", "--per_device_batch", "2",
                    "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip())
    assert report["device"] == "cpu" and set(report["mpix_per_s"]) == {"1"}
    assert report["efficiency"] == {"1": 1.0} and report["mpix_per_s"]["1"] > 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            benchmark.main(["parity", "--nb_images", "1", "--height", "32", "--width", "32"])
        with pytest.raises(RuntimeError, match="cuda"):
            benchmark.main(["scaling", "--height", "32", "--width", "32"])


@pytest.mark.parametrize("model_parallelism", [1, 2])
def test_scaling_report_over_cpu_meshes(model_parallelism):
    """The report's rows over meshes of 1, 2 and 4 CPU shards, against the
    JAX package's keys; on the CPU the numbers are no scaling figure."""
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(0), True)
    report = throughput.scaling_report(params, numpy.ones(128, numpy.float32), (32, 32), 2,
                                       model_parallelism=model_parallelism, repeats=1,
                                       devices=["cpu"] * 4)
    expected_rows = [1, 2, 4] if model_parallelism == 1 else [2, 4]
    assert sorted(report["mpix_per_s"]) == expected_rows
    assert set(report) == {"mpix_per_s", "efficiency"}
    assert all(value > 0.0 for value in report["mpix_per_s"].values())
    if model_parallelism == 1:
        assert report["efficiency"][1] == 1.0
    else:
        assert set(report["efficiency"].values()) == {None}


def test_benchmark_cli_loads_a_checkpoint(tmp_path, capsys):
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import save_checkpoint
    from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state

    state = init_train_state(torch.Generator().manual_seed(3), 1.0, True, device="cpu")
    save_checkpoint(str(tmp_path / "model_1"), state)
    benchmark.main(["parity", "--nb_images", "1", "--height", "32", "--width", "32",
                    "--checkpoint", str(tmp_path / "model_1"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip())["mpix_per_s_parity"] > 0.0
