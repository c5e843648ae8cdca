"""PyTorch port: the serving bench's smoke mode on the CPU, as a user
runs it, and the gate probe it is built on."""

import torch_cpu  # noqa: F401  (first: this process's share of the cores)

import json
import os
import subprocess
import sys

import numpy
import pytest

from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
    synthetic_luminance_stack,
)
from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.eval import gate_probe, serving_bench, workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The keys of bench.py's line, then the port's own: the device, graph
# against eager, and how the baseline row spread and each row was timed.
KEYS = ("metric", "value", "unit", "vs_baseline", "vs_baseline_range",
        "baseline_spread_mpix_per_s", "timing_modes", "headline_path", "int8_mpix_per_s",
        "bf16w_mpix_per_s", "bf16wplus_mpix_per_s", "bf16wplus_scan_mix",
        "gate_pass_worst_0p05db", "fp32_mpix_per_s", "fast_vs_fp32_psnr_db",
        "psnr_delta_vs_fp32_db", "psnr_delta_vs_fp32_worst_db",
        "true_bitstream_fast_mpix_per_s", "true_bitstream_compress_only_mpix_per_s",
        "true_bitstream_mpix_per_s", "true_bitstream_compress_only_noverify_mpix_per_s",
        "true_bitstream_spread_mpix_per_s", "link_mb_per_s", "coder_msym_per_s", "weights",
        "device", "scan_graph_vs_eager")


def _bench(*args, smoke=True):
    env = dict(os.environ, AEIC_BENCH_SMOKE="1" if smoke else "", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"), *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_bench_smoke_on_the_cpu_prints_every_key():
    result = _bench("--device", "cpu")
    assert result.returncode == 0, result.stderr[-2000:]
    line = json.loads(result.stdout.strip().splitlines()[-1])
    assert set(line) == set(KEYS)
    assert line["metric"].startswith("SMOKE_") and line["unit"] == "Mpix/s/chip"
    assert line["weights"] == "trained" and line["device"] == "cpu"
    assert line["headline_path"] == "bf16w+" and line["value"] == line["bf16wplus_mpix_per_s"]
    assert line["bf16wplus_scan_mix"] == engine.BF16WPLUS_SCAN_MIX
    variants = {"int8", "bf16w", "bf16w+"}
    for key in ("gate_pass_worst_0p05db", "fast_vs_fp32_psnr_db", "psnr_delta_vs_fp32_db",
                "psnr_delta_vs_fp32_worst_db", "scan_graph_vs_eager"):
        assert set(line[key]) == variants, key
    assert all(set(row) == {"x1", "x4", "x10"}
               for row in line["psnr_delta_vs_fp32_worst_db"].values())
    # No CUDA graph and no pinned-memory link on the CPU.
    assert all(row["graph"] is None and row["eager"] > 0.0
               for row in line["scan_graph_vs_eager"].values())
    assert line["link_mb_per_s"] is None
    spread = line["true_bitstream_spread_mpix_per_s"]
    assert set(spread) == {"roundtrip", "roundtrip_fast", "compress_only",
                           "compress_only_noverify"}
    assert all(row["min"] <= row["median"] <= row["max"] for row in spread.values())
    assert set(spread["compress_only"]["phase_fractions"]) == {"coder", "fetch_wait"}
    assert set(line["coder_msym_per_s"]) == {"roundtrip", "encode_only"}
    baseline = line["baseline_spread_mpix_per_s"]
    assert 0.0 < baseline["min"] <= baseline["median"] <= baseline["max"]
    (low, high) = line["vs_baseline_range"]
    assert low <= line["vs_baseline"] <= high
    assert set(line["timing_modes"]) == {"fp32", "variants", "baseline"}
    assert line["timing_modes"]["variants"].startswith("eager")  # no graph on the CPU
    for key in KEYS:
        if key.endswith("mpix_per_s") and "spread" not in key:
            assert line[key] > 0.0, key


def test_bench_without_a_card_exits_non_zero():
    result = _bench(smoke=False)
    assert result.returncode != 0
    assert "cuda" in result.stderr and not result.stdout.strip()


def test_distinct_stack_gives_different_batches():
    images = synthetic_luminance_stack(2, 32, 48, seed=0).astype(numpy.float32)
    stack = serving_bench.distinct_stack(images, 3)
    assert stack.shape == (3, 2, 32, 48, 1)
    numpy.testing.assert_array_equal(stack[0], numpy.roll(images, 11, axis=2))
    numpy.testing.assert_array_equal(stack[1], numpy.roll(images, 48, axis=2)[:, ::-1])
    assert not numpy.array_equal(stack[0], stack[2])


@pytest.mark.parametrize("through", ["pipeline", "scan"])
def test_gate_table_rows_and_the_serving_mixes(through):
    (params, bin_widths, map_mean, _, _) = workload.load_model(workload.LEARNED)
    images = synthetic_luminance_stack(2, 64, 96, seed=11)
    labels = list(gate_probe.GATE_MIXES[through])
    shown = []
    table = gate_probe.gate_table(params, bin_widths, map_mean, images, through=through,
                                  batch_size=2, device="cpu", show=shown.append)
    assert list(table) == labels and len(shown) == len(labels)
    assert all(set(row) == set(gate_probe.GATE_MULTIPLIERS) for row in table.values())
    # All fp32 against fp32: only summation order is left.
    assert all(abs(delta) <= 0.01 for delta in table["tail 3 (all fp32)"].values())
    assert gate_probe.holds_gate(table["tail 3 (all fp32)"])
    assert not gate_probe.holds_gate({1.0: 0.0, 4.0: -0.0501})
    # The mix each path serves with is a row of its table.
    if through == "pipeline":
        label = gate_probe.mix_label("pipeline", "bf16", dict(
            fp32_enc_tail=engine.BF16WPLUS_ENC_TAIL, fp32_tail=engine.BF16WPLUS_DEC_TAIL,
            fp32_head=engine.BF16WPLUS_DEC_HEAD,
            exact_latents=engine.BF16WPLUS_DEC_EXACT_LATENTS))
    else:
        label = gate_probe.mix_label("scan", "bf16", engine.BF16WPLUS_SCAN_MIX)
    assert label in table
    with pytest.raises(ValueError, match="pipeline"):
        gate_probe.gate_table(params, bin_widths, map_mean, images, through="mesh",
                              device="cpu")
