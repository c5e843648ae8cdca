"""The serving bench: encode + decode throughput of the codec on one
device, per serving variant, with the fidelity gate beside it.

Counterpart of the reference's root ``bench.py``, on the same workload:
24 luminance images of 512 x 768 (``eval.workload.kodak_images``), the
trained learned-bin-width artifact with its coding statistics (random
weights only where the checkout has none, and then ``"weights":
"random"``), and for the device-only numbers K = 8 distinct batches of
the 24 images (rolled and flipped copies: same shapes, other pixels)
through ``engine.fast_roundtrip_scan`` with 2 such programs queued
before the wait.

What is measured, and how:

- ``int8`` / ``bf16w`` / ``bf16wplus_mpix_per_s``: device-only round
  trips, host clock around work that ends in a device barrier, best of
  5; the K-batch program replayed from its CUDA graph on the card
  (``scan_graph_vs_eager`` has the eager loop beside it for every
  variant). ``fp32_mpix_per_s``: the fp32 transforms over the same
  batches, an eager loop, best of as many calls. ``timing_modes`` says
  which row was timed which way. No result is copied to the host inside
  a timed region.
- the gate: each variant's worst-image PSNR delta against the fp32
  transforms at bin-width multipliers 1, 4 and 10, through the scan
  path (``eval.gate_probe``). The headline is "bf16w+" when it holds
  the 0.05 dB gate, else "bf16w" with the failure in ``gate_pass_*``.
- ``true_bitstream_*``: ``PipelinedCompressor`` at batch 4, real
  arithmetic-coded bitstreams, median of 5-7 calls with the range
  (host clock; these rows ride the host coder, whose time varies from
  call to call).
- ``link_mb_per_s`` (pinned-memory copies of 16 MB) and
  ``coder_msym_per_s`` (the C++ coder alone on the stack's symbols), so
  that the serving rows can be read against their two ceilings.
- ``vs_baseline``: the headline over a reference-style run of the fp32
  transforms, one batch of 4 at a time with a synchronous fetch of
  every result. That run rides the host (launches and fetches of small
  batches) and moves severalfold from call to call, so its median, min
  and max are in ``baseline_spread_mpix_per_s``; ``vs_baseline`` uses
  the median and ``vs_baseline_range`` the slowest and fastest call.

``smoke`` shrinks everything (4 images of 64 x 96, K = 2, 1 repeat, no
graph) so that every code path runs on the CPU in seconds; the numbers
then mean nothing and the metric's name says so.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.coding.compression import (
    compress_lossless_images,
)
from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.eval import gate_probe, workload
from autoencoder_based_image_compression_tpu_torch.eval.throughput import (
    barrier,
    parity_path,
)
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
    PipelinedCompressor,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
    params_artifact_step,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

VARIANTS = ("int8", "bf16w", "bf16w+")
NB_IN_FLIGHT = 2


def distinct_stack(images_f32, nb_scan):
    """``nb_scan`` different batches: spatial rolls and flips of the
    image batch (same shapes, other pixels)."""
    variants = []
    for k in range(nb_scan):
        batch = numpy.roll(images_f32, 37 * k + 11, axis=2)
        if k % 2 == 1:
            batch = batch[:, ::-1]
        variants.append(batch)
    return numpy.stack(variants, axis=0)


def device_line(device):
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _timed(fn, device, repeats):
    """Wall seconds of each of ``repeats`` calls of ``fn`` after a
    warm-up call, each ended by a device barrier."""
    fn()
    barrier(device)
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        fn()
        barrier(device)
        times.append(time.perf_counter() - start)
    return times


def _stats_match_artifact(exp_dir):
    """The coded rows pair the params artifact with the coding
    statistics; both record the training step they came from, and a
    pair from different steps would measure mismatched rates."""
    artifact_step = params_artifact_step(os.path.join(exp_dir, "params_trained.npz"))
    marker = os.path.join(exp_dir, "statistics", "stats_model_idx.json")
    stats_step = None
    if os.path.isfile(marker):
        with open(marker) as file:
            stats_step = json.load(file).get("step")
    if artifact_step is None or stats_step is None:
        return True  # artifacts from before the step stamp: assume the pair
    if artifact_step != stats_step:
        print(f"WARNING: params artifact (step {artifact_step}) and coding statistics "
              f"(step {stats_step}) come from different training steps; skipping the "
              "true-bitstream rows.", file=sys.stderr)
        return False
    return True


def _load():
    exp_dir = workload.LEARNED
    if os.path.isfile(os.path.join(exp_dir, "params_trained.npz")):
        (params, bin_widths, map_mean, probabilities, idx_exception) = workload.load_model(
            exp_dir)
        stats = ((map_mean, probabilities, idx_exception)
                 if _stats_match_artifact(exp_dir) else None)
        return (params, bin_widths, stats, "trained")
    params = conv_eae.init_conv_eae_params(torch.Generator().manual_seed(0), True)
    return (params, numpy.ones(128, numpy.float32), None, "random")


def _spread(nb_pixels, times):
    """Median, min and max Mpix/s over the timed calls of a row."""
    return {"median": round(nb_pixels / statistics.median(times) / 1e6, 3),
            "min": round(nb_pixels / max(times) / 1e6, 3),
            "max": round(nb_pixels / min(times) / 1e6, 3)}


def run(device="cuda", smoke=False, repeats=5):
    """Runs the bench and returns its result as one dict (the keys of
    the reference bench's JSON line, plus ``device`` and
    ``scan_graph_vs_eager``). ``repeats`` is the number of timed calls
    of a row; the two compress-only rows take ``repeats + 2``."""
    device = resolve_device(device)
    if smoke:
        repeats = 1
    use_graph = device.type == "cuda" and not smoke
    nb_scan = 2 if smoke else 8
    (params_cpu, bin_widths_np, stats, weights_kind) = _load()
    images = workload.kodak_images(smoke)
    nb_pixels = images.shape[0] * images.shape[1] * images.shape[2]
    params = {name: value.to(device) for (name, value) in params_cpu.items()}
    bin_widths = torch.tensor(numpy.asarray(bin_widths_np, numpy.float32)).to(device)
    stack = torch.from_numpy(distinct_stack(images.astype(numpy.float32), nb_scan)).to(device)
    scan_pixels = nb_scan * NB_IN_FLIGHT * nb_pixels

    # --- device-only throughput: K distinct batches a program, two
    # programs queued before the barrier.
    def scan_run(variant, graph):
        (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, variant)

        def call():
            return [engine.fast_roundtrip_scan(qparams, qfolded, stack, bin_widths,
                                               graph=graph, **knobs)
                    for _ in range(NB_IN_FLIGHT)]
        return call

    def fp32_run():
        return [[parity_path(params, batch, bin_widths) for batch in stack]
                for _ in range(NB_IN_FLIGHT)]

    fp32_mpix = scan_pixels / min(_timed(fp32_run, device, repeats)) / 1e6
    mpix = {}
    graph_vs_eager = {}
    for variant in VARIANTS:
        eager = scan_pixels / min(_timed(scan_run(variant, False), device, repeats)) / 1e6
        graph_vs_eager[variant] = {"graph": None, "eager": round(eager, 3)}
        mpix[variant] = eager
        if use_graph:
            mpix[variant] = scan_pixels / min(
                _timed(scan_run(variant, True), device, repeats)) / 1e6
            graph_vs_eager[variant]["graph"] = round(mpix[variant], 3)
            engine.clear_scan_graphs()

    # --- the gate, through the scan path, on the weights used above.
    map_mean = stats[0] if stats is not None else numpy.zeros(128, numpy.float32)
    mixes = {variant: engine.SCAN_VARIANTS[variant] for variant in VARIANTS}
    details = gate_probe.gate_details(params_cpu, bin_widths_np, map_mean, images,
                                      through="scan", batch_size=min(images.shape[0], 8),
                                      mixes=mixes, device=device)
    worst = {variant: {f"x{m:g}": float(cell["deltas"].min()) for (m, cell) in row.items()}
             for (variant, row) in details.items()}
    gate_pass = {variant: bool(min(row.values()) >= -gate_probe.GATE_DB)
                 for (variant, row) in worst.items()}
    headline = "bf16w+" if (smoke or gate_pass["bf16w+"]) else "bf16w"

    # --- reference-style: batches of 4, every result fetched before the next.
    def reference_style():
        for start in range(0, images.shape[0], 4):
            batch = torch.from_numpy(images[start:start + 4].astype(numpy.float32)).to(device)
            parity_path(params, batch, bin_widths).cpu()

    baseline = _spread(nb_pixels, _timed(reference_style, device, repeats))

    # --- host link: pinned-memory copies of 16 MB each way.
    link = None
    if device.type == "cuda":
        pinned = torch.zeros(16 << 20, dtype=torch.uint8).pin_memory()
        on_card = pinned.to(device)
        link = {"upload": round(16.0 / min(_timed(
                    lambda: on_card.copy_(pinned, non_blocking=True), device, 3)), 1),
                "fetch": round(16.0 / min(_timed(
                    lambda: pinned.copy_(on_card, non_blocking=True), device, 3)), 1)}

    # --- true bitstreams through PipelinedCompressor, and the coder alone.
    coded = dict.fromkeys(("roundtrip", "roundtrip_fast", "compress_only",
                           "compress_only_noverify"))
    spread = {}
    coder_msym = None
    if stats is not None:
        (map_mean, probabilities, idx_exception) = stats

        def serve_row(name, row_repeats, **kwargs):
            compressor = PipelinedCompressor(
                params_cpu, bin_widths_np, True, probabilities, map_mean, idx_exception,
                batch_size=4, device=device, **kwargs)
            times = _timed(lambda: compressor(images), device, row_repeats)
            spread[name] = _spread(nb_pixels, times)
            coded[name] = nb_pixels / statistics.median(times) / 1e6
            return compressor

        serve_row("roundtrip", repeats)
        serve_row("roundtrip_fast", repeats, fast_path="bf16w+")
        compress_only = serve_row("compress_only", repeats + 2, reconstruct=False)
        wall = max(compress_only.last_timing["wall"], 1e-9)
        spread["compress_only"]["phase_fractions"] = {
            phase: round(compress_only.last_timing[phase] / wall, 3)
            for phase in ("coder", "fetch_wait")}
        serve_row("compress_only_noverify", repeats + 2, reconstruct=False, verify=False)

        symbol_batches = []
        for start in range(0, images.shape[0], 8):
            (sym16, _, _) = compress_only.encode_symbols(
                torch.from_numpy(images[start:start + 8]).to(device))
            symbol_batches.append(sym16.cpu().numpy())
        symbols_all = numpy.concatenate(symbol_batches, axis=0)
        coder_msym = {}
        for (mode, verify) in (("roundtrip", True), ("encode_only", False)):
            seconds = min(_timed(
                lambda v=verify: compress_lossless_images(symbols_all, probabilities,
                                                          idx_exception, verify=v),
                torch.device("cpu"), min(repeats, 3)))
            coder_msym[mode] = round(symbols_all.size / seconds / 1e6, 2)

    def rounded(value, digits=3):
        return None if value is None else round(value, digits)

    return {
        "metric": ("SMOKE_" if smoke else "") + "kodak24_encode_decode_throughput",
        "value": round(mpix[headline], 3),
        "unit": "Mpix/s/chip",
        "vs_baseline": round(mpix[headline] / baseline["median"], 3),
        "vs_baseline_range": [round(mpix[headline] / baseline["max"], 3),
                              round(mpix[headline] / baseline["min"], 3)],
        "baseline_spread_mpix_per_s": baseline,
        "timing_modes": {
            "fp32": f"eager loop, best of {repeats}",
            "variants": (f"CUDA graph replay, best of {repeats}" if use_graph
                         else f"eager loop, best of {repeats}"),
            "baseline": f"eager, batches of 4 with a fetch each, median of {repeats}"},
        "headline_path": headline,
        "int8_mpix_per_s": round(mpix["int8"], 3),
        "bf16w_mpix_per_s": round(mpix["bf16w"], 3),
        "bf16wplus_mpix_per_s": round(mpix["bf16w+"], 3),
        "bf16wplus_scan_mix": dict(engine.BF16WPLUS_SCAN_MIX),
        "gate_pass_worst_0p05db": gate_pass,
        "fp32_mpix_per_s": round(fp32_mpix, 3),
        "fast_vs_fp32_psnr_db": {variant: round(row[1.0]["rec_psnr"], 2)
                                 for (variant, row) in details.items()},
        "psnr_delta_vs_fp32_db": {variant: round(float(row[1.0]["deltas"].mean()), 4)
                                  for (variant, row) in details.items()},
        "psnr_delta_vs_fp32_worst_db": {
            variant: {m: round(d, 4) for (m, d) in row.items()}
            for (variant, row) in worst.items()},
        "true_bitstream_fast_mpix_per_s": rounded(coded["roundtrip_fast"]),
        "true_bitstream_compress_only_mpix_per_s": rounded(coded["compress_only"]),
        "true_bitstream_mpix_per_s": rounded(coded["roundtrip"]),
        "true_bitstream_compress_only_noverify_mpix_per_s": rounded(
            coded["compress_only_noverify"]),
        "true_bitstream_spread_mpix_per_s": spread or None,
        "link_mb_per_s": link,
        "coder_msym_per_s": coder_msym,
        "weights": weights_kind,
        "device": device_line(device),
        "scan_graph_vs_eager": graph_vs_eager,
    }


def main(args=None):
    import argparse

    parser = argparse.ArgumentParser(description="Serving bench of the PyTorch/CUDA port.")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(args)
    smoke = os.environ.get("AEIC_BENCH_SMOKE", "") not in ("", "0")
    try:
        device = resolve_device(args.device)
    except RuntimeError as error:
        print(f"bench_torch: {error}", file=sys.stderr)
        return 1
    print(json.dumps(run(device=device, smoke=smoke, repeats=args.repeats)))
    return 0
