#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA GDN kernels (``nvcc``) and the C++ arithmetic coder
(``make``) from the sources in the checkout, then runs seven phases:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. every kernel variant against its plain PyTorch version at the main
   paths' shapes (serving, a 4 x 512 x 768 batch: rows 98,304 at H/4 and
   24,576 at H/8 for GDN/IGDN in fp32 and bf16, 6,144 at H/16 for
   GDN+quantise; training, a 10 x 256 x 256 batch: rows 40,960, 10,240
   and 2,560 for GDN/IGDN in fp32); then the gradient of the fp32 kernel's
   ``GdnFunction`` against autograd through the plain version;
3. serving: ``PipelinedCompressor`` (bf16w+, then fp32) over the 24
   synthetic Kodak-shaped images on the trained learned-bin-width model
   and its statistics at multiplier 1, true bitstreams, verified;
   then the decoder's precision mixes at multipliers 1, 4 and 10 (the
   gate table) and the device's own time per batch; fails if bf16w+'s
   worst image is more than 0.05 dB below fp32 at any of the three;
4. the fixed-bin-width ``roundtrip_batched`` (fused GDN+quantise);
5. training at full width, both architectures (learned and fixed bin
   widths), on synthetic 256 x 256 crops at batch 10: a fresh state, one
   density pre-fit epoch, three epochs of 12 ``train_step``s; fails unless
   the density loss falls over the pre-fit, the rate-distortion loss of
   ``evaluation`` (same noise) falls over the steps, the projections
   hold, the gradient of the loss through the kernels agrees with the
   gradient through plain GDN, and one ``train_step`` launches the
   expected kernels. Then: checkpoint saved and loaded back equal, a
   params artifact, ``collect_stats`` on held-out crops, and a few
   images served through ``PipelinedCompressor`` with those statistics,
   verified. Prints ms per ``train_step`` and per phase, steps/s, the
   GDN kernels' share and the device's busy share;
6. kernel times, bounds and launch counts: one ``{"kernels": [...]}`` line;
7. the result line ``{"ok": true, "device": {...}}``, last.

Launch counts are set to 0 just before each path and read just after.
Any failure exits non-zero; so does a machine without a card. Imports
nothing of JAX.
"""

import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000")
FIXED = os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000")
KERNEL_SOURCE = "autoencoder_based_image_compression_tpu_torch/csrc/gdn.cu"
TPU_KERNELS = "autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py"
GATE_DB = 0.05
GATE_MULTIPLIERS = (1.0, 4.0, 10.0)
# The GDN launches of one batch on each serving path: (variant, shape).
GDN_SITES = {
    "bf16w+": (("gdn_f32", "H/4"), ("gdn_f32", "H/8"), ("igdn_f32", "H/8"),
               ("igdn_bf16", "H/4")),
    "fp32": (("gdn_f32", "H/4"), ("gdn_f32", "H/8"), ("igdn_f32", "H/8"),
             ("igdn_f32", "H/4")),
}
# Decoder precision mixes of the gate table: (integer symbols into folded
# parameters?, fast_decode's keywords).
GATE_MIXES = {
    "a: fp32 head, rounded latents": (False, dict(fp32_head=True)),
    "b: folded integer symbols, tail 0 (the reference's measurement)": (True, dict()),
    "b+: folded integer symbols, fp32 head": (True, dict(fp32_head=True)),
    "c: fp32 head, exact latents (bf16w+)": (False, dict(fp32_head=True, exact_latents=True)),
    "d: c + fp32 IGDN_6": (False, dict(fp32_head=True, exact_latents=True,
                                        fp32_igdn6=True)),
    "tail 0": (False, dict()), "tail 1": (False, dict(fp32_tail=1)),
    "tail 2": (False, dict(fp32_tail=2)), "tail 3 (all fp32)": (False, dict(fp32_tail=3)),
}
BF16_ULP = 2.0 ** -7
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
(BATCH, HEIGHT, WIDTH) = (4, 512, 768)
# Timed launches walk round this many bytes of inputs and outputs at least
# (the L2 cache holds 50 MB), and the ragged check adds these rows to H/4.
TIMING_FOOTPRINT_BYTES = 128 << 20
RAGGED_EXTRA = 37
# Training: the reference's batch of 10 crops of 256 x 256.
(TRAIN_BATCH, TRAIN_CROP) = (10, 256)
TRAIN_GAMMA = 10000.0
DEVICE = "cuda"
(TRAIN_IMAGES, TRAIN_EPOCHS, EXTRA_IMAGES, SERVED_IMAGES) = (120, 3, 20, 4)
ROWS = {"H/4": BATCH * HEIGHT * WIDTH // 16, "H/8": BATCH * HEIGHT * WIDTH // 64,
        "H/16": BATCH * HEIGHT * WIDTH // 256,
        "T/4": TRAIN_BATCH * TRAIN_CROP ** 2 // 16, "T/8": TRAIN_BATCH * TRAIN_CROP ** 2 // 64,
        "T/16": TRAIN_BATCH * TRAIN_CROP ** 2 // 256}
TRAIN_SHAPES = ("T/4", "T/8", "T/16")
# The GDN launches of one train_step: (variant, shape). The density phase
# encodes, the autoencoder phase encodes and decodes; the fixed-bin-width
# architecture adds GDN_3 and IGDN_4 at the bottleneck.
TRAIN_SITES = {
    True: 2 * (("gdn_f32", "T/4"), ("gdn_f32", "T/8"))
    + (("igdn_f32", "T/8"), ("igdn_f32", "T/4")),
    False: 2 * (("gdn_f32", "T/4"), ("gdn_f32", "T/8"), ("gdn_f32", "T/16"))
    + (("igdn_f32", "T/16"), ("igdn_f32", "T/8"), ("igdn_f32", "T/4")),
}
# Kernel variants: dtype, inverse, quantise, trained (gamma, beta) site,
# the shapes of the main path, and the Pallas body each replaces.
VARIANTS = {
    "gdn_f32": (torch.float32, False, False, (LEARNED, 1), ("H/4", "H/8") + TRAIN_SHAPES, 26),
    "igdn_f32": (torch.float32, True, False, (LEARNED, 6), ("H/4", "H/8") + TRAIN_SHAPES, 26),
    "gdn_bf16": (torch.bfloat16, False, False, (LEARNED, 1), ("H/4", "H/8"), 26),
    "igdn_bf16": (torch.bfloat16, True, False, (LEARNED, 6), ("H/4", "H/8"), 26),
    "gdn_quantize_f32": (torch.float32, False, True, (FIXED, 3), ("H/16",), 44),
}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def build_all():
    """Builds the kernels and the coder from the checkout's sources,
    both at once (nvcc and make in parallel)."""
    from autoencoder_based_image_compression_tpu_torch.coding import native
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(gdn_kernel.load_library), pool.submit(native.load_library)]
        for future in futures:
            future.result()
    print(f"built {KERNEL_SOURCE} and the coder in {time.perf_counter() - t0:.1f} s")
    # ptxas report: kernel (template arguments as mangled: Li<RM>E, then
    # Lb<inverse>E, Lb<quantise>E), registers, spills.
    with open(gdn_kernel.BUILD_LOG) as log:
        report = log.read()
    for entry in report.split("Compiling entry function '")[1:]:
        kernel = re.search(r"gdn_(?:f32|bf16)_kernelI\w+?E(?=Ev)", entry)
        facts = [line.split(":")[-1].strip() for line in entry.splitlines()
                 if "Used" in line or "spill" in line]
        print(f"  ptxas {kernel.group(0) if kernel else '?'}: " + "; ".join(facts))


def _median_ms(run, launches, repeats):
    """Median over ``repeats`` of the device time of ``run()`` per launch."""
    times = []
    for _ in range(repeats):
        (start, end) = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(numpy.median(times))


def time_ms(fn, inputs, launches=24, repeats=7):
    """Device time of one ``fn(x)`` in ms: ``(graph, eager)``.

    ``graph`` replays a captured CUDA graph of ``launches`` calls, so no
    host work (Python, ctypes, the allocator) sits between the kernels;
    ``eager`` times the same calls made from Python back to back. Both
    are the median of ``repeats``. The calls walk round ``inputs``
    (copies of one matrix, more than the L2 cache holds together with
    their outputs) and every output of a pass stays alive, so each launch
    finds its operands in device memory, not in the cache.
    """
    def run():
        return [fn(inputs[i % len(inputs)]) for i in range(launches)]

    for _ in range(2):  # first use sets the kernels' attributes: not capturable
        run()
    torch.cuda.synchronize()
    eager = _median_ms(run, launches, repeats)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = run()
    graph.replay()
    torch.cuda.synchronize()
    replayed = _median_ms(graph.replay, launches, repeats)
    del outputs, graph
    return (replayed, eager)


def bound(rows, dtype, quantize):
    """Least time on the card (ms) for the kernel's work and what sets it:
    each input read once and the output written once at the HBM rate, or
    the 2 * rows * 128^2 flops of the pool at the peak rate of their type."""
    nbytes = 2 * rows * 128 * (4 if dtype == torch.float32 else 2)
    nbytes += (128 * 128 + 128 + (128 if quantize else 0)) * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2.0 * rows * 128 * 128 / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(name, rows, seed):
    (dtype, _, quantize, (exp_dir, index), _, _) = VARIANTS[name]
    with numpy.load(os.path.join(exp_dir, "params_trained.npz")) as data:
        gamma = data[f"param:gamma_{index}"].astype(numpy.float32)
        beta = data[f"param:beta_{index}"].astype(numpy.float32)
        bin_widths = data["bin_widths"].astype(numpy.float32)
    rng = numpy.random.default_rng(seed)
    x = (4.0 * rng.normal(size=(rows, 128))).astype(numpy.float32)
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = [cuda(x).to(dtype), cuda(gamma), cuda(beta)]
    if quantize:
        args.append(cuda(bin_widths))
    return args


def check_kernel(name, rows, got, expected, bin_widths):
    """Holds a kernel's result against its plain version's at the
    variant's tolerance; returns ``(max_abs, max_rel, tolerance, detail)``."""
    (dtype, _, quantize, _, _, _) = VARIANTS[name]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} at {rows} rows: non-finite output")
    diff = (got.float() - expected.float()).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / expected.float().abs().clamp_min(1e-30)).max())
    if quantize:
        flips = got != expected
        flip_share = float(flips.float().mean())
        bw = bin_widths.expand_as(got)
        if flip_share > 1e-4 or not torch.allclose(diff[flips], bw[flips], rtol=1e-6):
            raise AssertionError(f"{name}: {flip_share} of the elements off by a bin")
        return (max_abs, max_rel, "identical except ties (<= 1e-4, one bin each)",
                f"tie flips {int(flips.sum())} of {flips.numel()}")
    if dtype == torch.float32:
        torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)
        return (max_abs, max_rel, "rtol 1e-5, atol 1e-6", "")
    if not bool((diff <= BF16_ULP * expected.float().abs()).all()):
        raise AssertionError(f"{name} at {rows} rows: more than 1 bf16 ulp off")
    return (max_abs, max_rel, "1 bf16 ulp (rtol 2^-7)", "")


def phase_kernels():
    """Each variant against its plain version; returns errors and times."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    results = {}
    for (seed, (name, (dtype, inverse, quantize, _, shapes, _))) in enumerate(VARIANTS.items()):
        kernel = gk.gdn_quantize_2d if quantize else gk.gdn_2d
        plain = gk.gdn_quantize_2d_plain if quantize else gk.gdn_2d_plain
        # A ragged row count first (the last tile is masked), then the
        # main path's shapes, which are also timed.
        for shape in ("ragged",) + shapes:
            rows = ROWS["H/4"] + RAGGED_EXTRA if shape == "ragged" else ROWS[shape]
            (x, *params) = kernel_inputs(name, rows, seed)
            got = kernel(x, *params, inverse=inverse)
            expected = plain(x, *params, inverse=inverse)
            torch.cuda.synchronize()
            (max_abs, max_rel, tolerance, detail) = check_kernel(
                name, rows, got, expected, params[-1])
            head = (f"  {name:17s} rows {rows:6d} ({shape:6s}): max abs err {max_abs:.3e}, "
                    f"max rel err {max_rel:.3e} [{tolerance}] {detail}")
            if shape == "ragged":
                print(head)
                continue
            del got, expected
            nbytes = 2 * x.numel() * x.element_size()
            inputs = [x] + [x.clone() for _ in range(TIMING_FOOTPRINT_BYTES // nbytes)]
            (ms, ms_eager) = time_ms(lambda t: kernel(t, *params, inverse=inverse), inputs)
            (plain_ms, _) = time_ms(lambda t: plain(t, *params, inverse=inverse), inputs)
            (bound_ms, bound_by) = bound(rows, dtype, quantize)
            results[(name, shape)] = dict(max_abs_err=max_abs, ms=ms, ms_eager=ms_eager,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by)
            print(f"{head}; tile {gk.tile_rows(rows) if dtype == torch.float32 else 16}; "
                  f"kernel {ms:.4f} ms replayed, {ms_eager:.4f} ms eager, "
                  f"plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us ({bound_by}), "
                  f"share of bound {100 * bound_ms / ms:.0f} %")
    return results


def load_model(exp_dir):
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
        load_params_artifact,
        params_from_jax,
    )

    (params_np, bin_widths) = load_params_artifact(os.path.join(exp_dir, "params_trained.npz"))
    stats = os.path.join(exp_dir, "statistics")
    map_mean = numpy.load(os.path.join(stats, "map_mean.npy"))
    probabilities = numpy.load(os.path.join(stats, "binary_probabilities_1.npy"))
    with open(os.path.join(stats, "idx_map_exception.pkl"), "rb") as file:
        idx_exc = pickle.load(file)
    return (params_from_jax(params_np), bin_widths, map_mean, probabilities, idx_exc)


def expect_launches(path, counts, expected):
    """Every GDN site of the path went through the kernels, and only those."""
    got = {name: n for (name, n) in counts.items() if n}
    print(f"  launches on the {path} path: {got}")
    if got != expected:
        raise AssertionError(f"{path}: launches {got}, expected {expected}")


def phase_serving(kernel_results):
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
    )

    (params, bin_widths, map_mean, probabilities, idx_exc) = load_model(LEARNED)
    images = synthetic_kodak(seed=0)
    nb_batches = -(-images.shape[0] // BATCH)
    # Small-input reference: the fp32 transforms with the kernels on the
    # card against the same transforms on the CPU (plain GDN).
    small = torch.from_numpy(images[:1, :64, :96].astype(numpy.float32))
    params_gpu = {k: v.cuda() for (k, v) in params.items()}
    y_gpu = conv_eae.encode(params_gpu, small.cuda(), True).cpu()
    y_cpu = conv_eae.encode(params, small, True)
    torch.testing.assert_close(y_gpu, y_cpu, rtol=1e-4, atol=1e-3)
    print(f"  small-input fp32 latents, card vs CPU: max abs diff "
          f"{float((y_gpu - y_cpu).abs().max()):.3e}")

    runs = {}
    for fast_path in ("bf16w+", None):
        compressor = PipelinedCompressor(params, bin_widths, True, probabilities, map_mean,
                                         idx_map_exception=idx_exc, batch_size=BATCH,
                                         fast_path=fast_path, verify=True, reconstruct=True)
        compressor(images[:BATCH])  # warm-up: cuDNN plans, pinned buffers
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        (recs, bits) = compressor(images)
        torch.cuda.synchronize()
        launches = dict(gk.LAUNCHES)
        tag = fast_path or "fp32"
        if recs.shape != images.shape or recs.dtype != numpy.uint8:
            raise AssertionError(f"{tag}: reconstructions {recs.shape} {recs.dtype}")
        if not numpy.all(bits > 0):
            raise AssertionError(f"{tag}: empty bitstream")
        if compressor.peak_in_flight > compressor.max_in_flight:
            raise AssertionError(f"{tag}: window exceeded")
        psnrs = numpy.array([psnr_2d(images[i, :, :, 0], recs[i, :, :, 0])
                             for i in range(images.shape[0])])
        timing = compressor.last_timing
        print(f"  serving {tag}: {bits.sum() / images[..., 0].size:.4f} bpp, "
              f"PSNR mean {psnrs.mean():.4f} dB (min {psnrs.min():.4f}), "
              f"{images[..., 0].size / timing['wall'] / 1e6:.3f} Mpix/s end to end, "
              f"last_timing {json.dumps(timing)}, peak_in_flight {compressor.peak_in_flight}")
        runs[tag] = (psnrs, bits, launches)
        device_times(compressor, images[:BATCH], timing["coder"] / nb_batches, kernel_results,
                     GDN_SITES[tag])
    expect_launches("serving bf16w+", runs["bf16w+"][2],
                    {"gdn_f32": 2 * nb_batches, "igdn_f32": nb_batches,
                     "igdn_bf16": nb_batches})
    expect_launches("serving fp32", runs["fp32"][2],
                    {"gdn_f32": 2 * nb_batches, "igdn_f32": 2 * nb_batches})
    deltas = runs["bf16w+"][0] - runs["fp32"][0]
    rate_gap = abs(int(runs["bf16w+"][1].sum()) - int(runs["fp32"][1].sum()))
    print(f"  bf16w+ vs fp32 through the pipeline at x1: worst-image PSNR delta "
          f"{deltas.min():+.4f} dB (gate -{GATE_DB} dB), max |delta| "
          f"{numpy.abs(deltas).max():.4f} dB, "
          f"total bits differ by {rate_gap / int(runs['fp32'][1].sum()):.3e}")
    if deltas.min() < -GATE_DB:
        raise AssertionError(f"bf16w+ misses the {GATE_DB} dB gate: {deltas.min():+.4f} dB")
    table = gate_table(params, bin_widths, map_mean, images)
    # The row of the mix that PipelinedCompressor serves with.
    serving = {key: value for (key, value) in dict(
        fp32_tail=engine.BF16WPLUS_DEC_TAIL, fp32_head=engine.BF16WPLUS_DEC_HEAD,
        exact_latents=engine.BF16WPLUS_DEC_EXACT_LATENTS).items() if value}
    (label,) = [label for (label, (folded, mix)) in GATE_MIXES.items()
                if not folded and mix == serving]
    for (multiplier, delta) in table[label].items():
        if not delta >= -GATE_DB:
            raise AssertionError(f"bf16w+ misses the {GATE_DB} dB gate at x{multiplier:g}: "
                                 f"{delta:+.4f} dB")
    print(f"  bf16w+ ({label}) holds the {GATE_DB} dB gate at x1, x4 and x10")
    return {"serving bf16w+": runs["bf16w+"][2], "serving fp32": runs["fp32"][2]}


def device_times(compressor, batch_uint8, coder_s, kernel_results, sites, repeats=5):
    """Device time of one batch's encode and decode (CUDA events round
    each, median of ``repeats``), GDN's share of it (the kernels' replayed
    times at the path's ``sites``) and the coder's host time per batch."""
    batch = torch.from_numpy(batch_uint8).cuda()
    (sym16, _, _) = compressor.encode_symbols(batch)
    compressor.decode_symbols(sym16)
    torch.cuda.synchronize()
    encode_ms = _median_ms(lambda: compressor.encode_symbols(batch), 1, repeats)
    decode_ms = _median_ms(lambda: compressor.decode_symbols(sym16), 1, repeats)
    gdn_ms = sum(kernel_results[site]["ms"] for site in sites)
    device_ms = encode_ms + decode_ms
    print(f"  device time per batch, {compressor.fast_path or 'fp32'}: encode "
          f"{encode_ms:.4f} ms, decode {decode_ms:.4f} ms, GDN kernels {gdn_ms:.4f} ms "
          f"({100 * gdn_ms / device_ms:.1f} % of {device_ms:.4f} ms); coder on the host "
          f"{1e3 * coder_s:.3f} ms per batch ({1e3 * coder_s / device_ms:.1f}x the device)")


def gate_table(params, bin_widths, map_mean, images):
    """Worst-image PSNR delta against the fp32 decode for the decoder's
    precision mixes at multipliers 1, 4 and 10 (symbols from the fp32
    encoder). Returns ``{label: {multiplier: worst delta}}``.

    The "folded" rows are the reference's own gate measurement: integer
    symbols ``round(y / bw)`` (no map means) into a decoder whose first
    kernel holds the bin widths, against the fp32 decode of ``sym * bw``.
    The other rows are the pipeline's call on ``sym * bw + mean``.
    """
    from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601

    params = {k: v.cuda() for (k, v) in params.items()}
    mean = torch.from_numpy(map_mean.astype(numpy.float32)).cuda()
    batches = [torch.from_numpy(images[i:i + BATCH].astype(numpy.float32)).cuda()
               for i in range(0, images.shape[0], BATCH)]
    latents = [conv_eae.encode(params, batch, True) for batch in batches]

    def psnrs(decode, inputs):
        recs = numpy.concatenate([cast_bt601(decode(y)).cpu().numpy() for y in inputs])
        return numpy.array([psnr_2d(images[i, :, :, 0], recs[i, :, :, 0])
                            for i in range(images.shape[0])])

    table = {label: {} for label in GATE_MIXES}
    for multiplier in GATE_MULTIPLIERS:
        bw = torch.from_numpy(bin_widths * multiplier).cuda()
        symbols = [torch.round(y / bw) for y in latents]
        quantized = [torch.round((y - mean) / bw) * bw + mean for y in latents]
        fp32_decode = lambda y: conv_eae.decode(params, y, True)  # noqa: E731
        reference = {False: psnrs(fp32_decode, quantized),
                     True: psnrs(fp32_decode, [sym * bw for sym in symbols])}
        folded_params = engine.fold_bin_widths_into_decoder(params, bw)
        for (label, (folded, mix)) in GATE_MIXES.items():
            qp = engine.bf16_weight_params(folded_params if folded else params,
                                           fp32_tail=mix.get("fp32_tail", 0))
            got = psnrs(lambda y: engine.fast_decode(qp, y, **mix),
                        symbols if folded else quantized)
            table[label][multiplier] = float((got - reference[folded]).min())
    for (label, row) in table.items():
        print(f"  gate table, worst-image delta (dB), {label}: "
              + "; ".join(f"x{m:g} {d:+.4f}" for (m, d) in row.items()))
    return table


def phase_fixed_bw():
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
        cast_bt601,
        quantize_per_map,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        roundtrip_batched,
    )

    (params, bin_widths, _, _, _) = load_model(FIXED)
    images = synthetic_kodak(seed=0)[:8]
    gk.reset_launch_counts()
    recs = roundtrip_batched(params, images, bin_widths, False, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)
    nb_batches = -(-images.shape[0] // BATCH)
    expect_launches("fixed-bw roundtrip", launches,
                    {"gdn_f32": 2 * nb_batches, "gdn_quantize_f32": nb_batches,
                     "igdn_f32": 3 * nb_batches})
    if recs.shape != images.shape or not numpy.all(numpy.isfinite(recs)):
        raise AssertionError(f"fixed-bw reconstructions {recs.shape}, finite "
                             f"{numpy.isfinite(recs).all()}")
    recs_u8 = cast_bt601(recs)
    psnrs = numpy.array([psnr_2d(images[i, :, :, 0], recs_u8[i, :, :, 0])
                         for i in range(images.shape[0])])
    # Reference on the card: GDN_3 and the quantiser as two steps.
    params_gpu = {k: v.cuda() for (k, v) in params.items()}
    batch = torch.from_numpy(images[:BATCH].astype(numpy.float32)).cuda()
    quantized = quantize_per_map(conv_eae.encode(params_gpu, batch, False),
                                 torch.from_numpy(bin_widths).cuda())
    unfused = conv_eae.decode(params_gpu, quantized, False).cpu().numpy()
    mse = float(numpy.mean((unfused.astype(numpy.float64) - recs[:BATCH]) ** 2))
    rec_psnr = 99.0 if mse == 0.0 else 10.0 * numpy.log10(255.0 ** 2 / mse)
    print(f"  fixed-bw roundtrip: PSNR vs originals mean {psnrs.mean():.4f} dB "
          f"(min {psnrs.min():.4f}); fused vs unfused reconstructions {rec_psnr:.2f} dB")
    if rec_psnr < 60.0 or psnrs.min() < 20.0:
        raise AssertionError("fixed-bw roundtrip disagrees with its unfused reference")
    return {"fixed-bw roundtrip": launches}


def _gap_to_max(got, expected):
    """Largest absolute difference, as a share of the largest entry."""
    return float((got - expected).abs().max() / expected.abs().max().clamp_min(1e-30))


def phase_gradient():
    """``GdnFunction`` (kernel forward, gradient written out) against
    autograd through the plain version, same inputs on the card, at the
    H/4 rows of a training batch. Tolerance: each gradient within 1e-4
    of its largest entry (fp32 sums over 128 channels, or over 40,960
    rows for gamma and beta, in another order)."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    rows = ROWS["T/4"]
    for (seed, name) in enumerate(("gdn_f32", "igdn_f32")):
        inverse = VARIANTS[name][1]
        (x, gamma, beta) = kernel_inputs(name, rows, 20 + seed)
        upstream = torch.randn(x.shape, device=DEVICE,
                               generator=torch.Generator(DEVICE).manual_seed(seed))
        grads = {}
        gk.reset_launch_counts()
        for (label, fn) in (("kernel", gk.gdn_2d), ("plain", gk.gdn_2d_plain)):
            leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
            out = fn(*leaves, inverse=inverse)
            if not out.requires_grad:
                raise AssertionError(f"{name}: the {label} result came back detached")
            grads[label] = torch.autograd.grad(out, leaves, upstream)
        torch.cuda.synchronize()
        if gk.LAUNCHES[name] != 1:
            raise AssertionError(f"{name}: {gk.LAUNCHES[name]} launches in the gradient check")
        gaps = [_gap_to_max(got, expected)
                for (got, expected) in zip(grads["kernel"], grads["plain"])]
        leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
        out = gk.gdn_2d(*leaves, inverse=inverse)
        backward_ms = _median_ms(
            lambda: torch.autograd.grad(out, leaves, upstream, retain_graph=True), 1, 7)
        print(f"  {name} gradient at {rows} rows, kernel forward vs autograd through plain: "
              f"gap / largest entry grad_x {gaps[0]:.3e}, grad_gamma {gaps[1]:.3e}, "
              f"grad_beta {gaps[2]:.3e} [1e-4]; backward (plain PyTorch) {backward_ms:.4f} ms")
        if not all(gap <= 1e-4 for gap in gaps):
            raise AssertionError(f"{name}: gradient gaps {gaps}")
        # What is never differentiated raises instead of detaching.
        for (call, error) in (
                (lambda: gk.gdn_2d(leaves[0].to(torch.bfloat16), gamma, beta), TypeError),
                (lambda: gk.gdn_quantize_2d(leaves[0], gamma, beta, beta), RuntimeError)):
            try:
                call()
            except error:
                continue
            raise AssertionError(f"{name}: an undifferentiable call with grad did not raise")


def _uniform_noise(shape, seed):
    generator = torch.Generator(DEVICE).manual_seed(seed)
    return torch.rand(shape, device=DEVICE, generator=generator) - 0.5


def check_projections(state, learn_bin_widths, ppi, max_itvs):
    from autoencoder_based_image_compression_tpu_torch import constants as csts
    from autoencoder_based_image_compression_tpu_torch.ops import density as dens

    # The floors as the float32 values the projections clamp to.
    (floor_gdn, min_bw, max_bw) = (numpy.float32(csts.MIN_GAMMA_BETA),
                                   numpy.float32(csts.MIN_BW), numpy.float32(csts.MAX_BW))
    for i in ((1, 2, 5, 6) if learn_bin_widths else (1, 2, 3, 4, 5, 6)):
        (gamma, beta) = (state.params[f"gamma_{i}"], state.params[f"beta_{i}"])
        if not (torch.equal(gamma, gamma.t()) and float(gamma.min()) >= floor_gdn
                and float(beta.min()) >= floor_gdn):
            raise AssertionError(f"GDN projection {i} does not hold")
    (low, high) = (float(state.bin_widths.min()), float(state.bin_widths.max()))
    if not (min_bw <= low and high <= max_bw):
        raise AssertionError(f"bin widths [{low}, {high}] outside [0.8, 4.0]")
    mask = dens.active_mask(state.density.nb_itvs_per_side, ppi, max_itvs)
    floor = numpy.float32(csts.LOW_PROJECTION)
    parameters = state.density.parameters
    if not (bool((parameters[:, mask == 0] == floor).all()) and float(parameters.min()) >= floor):
        raise AssertionError("density projection does not hold")
    for leaf in (*state.params.values(), parameters, state.bin_widths):
        if leaf.requires_grad or not bool(torch.isfinite(leaf).all()):
            raise AssertionError("a state leaf is not finite or still carries a graph")


def check_rd_gradient(state, batch, noise, learn_bin_widths, ppi, max_itvs):
    """The gradient of the rate-distortion loss through the kernels
    against the same through plain GDN (the wrapper of ``conv_eae``
    swapped for the plain version), same state, batch and noise. Each
    parameter's gradient within 1e-4 of its largest entry."""
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.train import step

    def plain_nhwc(x, gamma, beta, inverse=False):
        return gk.gdn_2d_plain(x, gamma, beta, inverse)

    args = (state, batch, noise, TRAIN_GAMMA, learn_bin_widths, ppi, max_itvs)
    gk.reset_launch_counts()
    (grads, grads_bw, loss) = step.rd_gradients(*args)
    launched = sum(gk.LAUNCHES.values())
    with mock.patch.object(conv_eae, "gdn_nhwc", plain_nhwc):
        (plain, plain_bw, plain_loss) = step.rd_gradients(*args)
    if launched == 0 or sum(gk.LAUNCHES.values()) != launched:
        raise AssertionError("the kernel run did not launch, or the plain run did")
    gaps = {name: _gap_to_max(grads[name], plain[name]) for name in grads}
    if learn_bin_widths:
        gaps["bin_widths"] = _gap_to_max(grads_bw, plain_bw)
    worst = max(gaps, key=gaps.get)
    print(f"  rate-distortion gradient through the kernels vs plain GDN: loss {float(loss):.6e} "
          f"vs {float(plain_loss):.6e}; largest gap / largest entry {gaps[worst]:.3e} "
          f"({worst}) [1e-4]")
    if not gaps[worst] <= 1e-4:
        raise AssertionError(f"rate-distortion gradient disagrees: {gaps}")


def traced_device_ms(run, steps, top=6):
    """Device time of one call of ``run`` from a profiler trace of
    ``steps`` calls: the kernels' own durations summed (the host-side
    rows of the trace, which carry the same time again, left out), and
    the ``top`` kernels by time as ``(name, ms a call, launches a call)``.
    ``(None, [])`` when the trace holds no device time. The profiler
    slows the host, so the wall time under it is not reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # the profiler's own start-up stays out of the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kernels = [(event.key, getattr(event, "self_device_time_total",
                                   getattr(event, "self_cuda_time_total", 0)), event.count)
               for event in trace.key_averages() if event.device_type == DeviceType.CUDA]
    total_us = sum(us for (_, us, _) in kernels)
    if total_us <= 0:
        return (None, [])
    kernels.sort(key=lambda row: -row[1])
    return (1e-3 * total_us / steps,
            [(name[:60], 1e-3 * us / steps, count / steps) for (name, us, count) in kernels[:top]])


def replayed_step_ms(step, repeats=7):
    """Device time (ms) of ``step()`` replayed from a captured CUDA graph:
    the step's kernels back to back, with no host work between them.
    Capturing a training step is no part of the package yet, so a
    capture that PyTorch refuses gives ``(None, reason)``, not a failure."""
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            kept = step()
        graph.replay()
        torch.cuda.synchronize()
        ms = _median_ms(graph.replay, 1, repeats)
        del kept, graph
        return (ms, None)
    except RuntimeError as error:
        return (None, (str(error).splitlines() or ["RuntimeError"])[0])


def phase_training(kernel_results, learn_bin_widths):
    from autoencoder_based_image_compression_tpu_torch import constants as csts
    from autoencoder_based_image_compression_tpu_torch.cli import collect_stats
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import (
        synthetic_luminance_stack,
    )
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
    )
    from autoencoder_based_image_compression_tpu_torch.train import checkpoint, loop
    from autoencoder_based_image_compression_tpu_torch.train.state import init_train_state
    from autoencoder_based_image_compression_tpu_torch.train.step import make_step_fns
    from autoencoder_based_image_compression_tpu_torch.utils.naming import experiment_suffix

    tag = "learned bin widths" if learn_bin_widths else "fixed bin widths"
    (ppi, max_itvs) = (csts.NB_POINTS_PER_INTERVAL, csts.MAX_ITVS_PER_SIDE)
    nb_batches = TRAIN_IMAGES // TRAIN_BATCH
    training = synthetic_luminance_stack(TRAIN_IMAGES, TRAIN_CROP, TRAIN_CROP, seed=10)
    state = init_train_state(torch.Generator().manual_seed(0), 1.0, learn_bin_widths,
                             device=DEVICE)
    fns = make_step_fns(TRAIN_GAMMA, learn_bin_widths)
    dataset = loop.device_resident_dataset(training, DEVICE)
    eval_batch = dataset[:TRAIN_BATCH]
    latent = (TRAIN_BATCH, TRAIN_CROP // 16, TRAIN_CROP // 16, csts.NB_MAPS_3)
    eval_noise = _uniform_noise(latent, 1)
    noise = torch.Generator(DEVICE).manual_seed(2)
    fns["train_step"](state, eval_batch, noise)  # warm-up: cuDNN plans; result dropped
    torch.cuda.synchronize()

    def indicators(state):
        full = loop.evaluate_full(state, eval_batch, fns, TRAIN_GAMMA, eval_noise)
        return (full["loss_density"], full["scaled_approx_entropy"] + full["rec_error"], full)

    gk.reset_launch_counts()
    (density_0, rd_0, _) = indicators(state)
    state = loop.preliminary_fitting(dataset, state, fns, TRAIN_BATCH, 1, noise)
    (density_1, rd_1, _) = indicators(state)
    shuffle = numpy.random.default_rng(3)
    epoch_seconds = []
    for _ in range(TRAIN_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = loop.run_epoch_training(dataset, state, fns, TRAIN_BATCH, nb_batches, noise,
                                        permutation=shuffle.permutation(TRAIN_IMAGES))
        torch.cuda.synchronize()
        epoch_seconds.append(time.perf_counter() - t0)
    (density_2, rd_2, full) = indicators(state)
    launches = dict(gk.LAUNCHES)
    steps = TRAIN_EPOCHS * nb_batches
    sites = TRAIN_SITES[learn_bin_widths]
    per_step = {name: sum(1 for (variant, _) in sites if variant == name)
                for name in ("gdn_f32", "igdn_f32")}
    # Evaluations (3) and pre-fit steps encode (and the evaluations
    # decode) beside the steps' launches.
    gdn_encode = per_step["gdn_f32"] // 2
    expect_launches(f"training, {tag}", launches, {
        "gdn_f32": steps * per_step["gdn_f32"] + (3 + nb_batches) * gdn_encode,
        "igdn_f32": (steps + 3) * per_step["igdn_f32"]})
    print(f"  training, {tag}: density loss {density_0:.6f} -> {density_1:.6f} over the "
          f"pre-fit ({nb_batches} steps); rate-distortion loss {rd_1:.6e} -> {rd_2:.6e} over "
          f"{steps} train_steps (before the pre-fit {rd_0:.6e}); rec error "
          f"{full['rec_error']:.6e}, mean approximate entropy {full['mean_approx_entropy']:.4f}, "
          f"mean entropy {full['mean_disc_entropy']:.4f}, grid "
          f"{int(state.density.nb_itvs_per_side)} intervals a side, step {int(state.step)}")
    if not density_1 < density_0:
        raise AssertionError(f"{tag}: the density loss did not fall over the pre-fit")
    if not rd_2 < rd_1:
        raise AssertionError(f"{tag}: the rate-distortion loss did not fall over the steps")
    if int(state.step) != steps or int(state.opt_eae.count) != steps:
        raise AssertionError(f"{tag}: step {int(state.step)}, expected {steps}")
    check_projections(state, learn_bin_widths, ppi, max_itvs)
    check_rd_gradient(state, eval_batch, eval_noise, learn_bin_widths, ppi, max_itvs)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the training path must run true fp32")

    gk.reset_launch_counts()
    fns["train_step"](state, eval_batch, noise)
    expect_launches(f"one train_step, {tag}", dict(gk.LAUNCHES), per_step)

    # Times: CUDA events round one call, median of 9.
    step_ms = _median_ms(lambda: fns["train_step"](state, eval_batch, noise), 1, 9)
    density_ms = _median_ms(lambda: fns["training_fct"](state, eval_batch, noise), 1, 9)
    eae_ms = _median_ms(lambda: fns["training_eae_bw"](state, eval_batch, noise), 1, 9)
    gdn_ms = sum(kernel_results[site]["ms"] for site in sites)
    epoch_s = float(numpy.median(epoch_seconds))
    (traced_ms, top_kernels) = traced_device_ms(
        lambda: fns["train_step"](state, eval_batch, noise), 10)
    print(f"  train_step, {tag}: {step_ms:.3f} ms (density phase {density_ms:.3f} ms, "
          f"autoencoder phase {eae_ms:.3f} ms); one epoch of {nb_batches} steps "
          f"{epoch_s:.4f} s = {nb_batches / epoch_s:.2f} steps/s, "
          f"{nb_batches * TRAIN_BATCH * TRAIN_CROP ** 2 / epoch_s / 1e6:.3f} Mpix/s; GDN forward "
          f"kernels {gdn_ms:.4f} ms ({100 * gdn_ms / step_ms:.1f} % of the step, "
          f"{len(sites)} launches); device busy share "
          + ("not measured (the trace holds no device time)" if traced_ms is None
             else f"{100 * traced_ms / step_ms:.1f} % ({traced_ms:.3f} ms of kernels a step in "
                  f"a profiler trace, against the step's {step_ms:.3f} ms)"))
    for (name, ms, count) in top_kernels:
        print(f"    {ms:.4f} ms a step, {count:.1f} launches: {name}")

    with tempfile.TemporaryDirectory() as root:
        exp_dir = os.path.join(root, experiment_suffix(1.0, TRAIN_GAMMA, learn_bin_widths))
        path = os.path.join(exp_dir, "model_1")
        checkpoint.save_checkpoint(path, state)
        checkpoint.mark_checkpoint_complete(path)
        template = init_train_state(torch.Generator().manual_seed(9), 1.0, learn_bin_widths,
                                    device=DEVICE)
        loaded = checkpoint.load_checkpoint(path, template)
        (saved, back) = (checkpoint.state_to_jax(state), checkpoint.state_to_jax(loaded))
        if set(saved) != set(back) or not all(numpy.array_equal(saved[key], back[key])
                                              for key in saved):
            raise AssertionError(f"{tag}: the checkpoint did not load back equal")
        checkpoint.save_params_artifact(os.path.join(exp_dir, "params_trained.npz"),
                                        state.params, state.bin_widths, step=int(state.step))
        extra = os.path.join(root, "extra.npy")
        numpy.save(extra, synthetic_luminance_stack(EXTRA_IMAGES, TRAIN_CROP, TRAIN_CROP, 11))
        collect_stats.main(
            ["1.0", str(TRAIN_GAMMA), "1", "--from_params", "--path_to_extra_data", extra,
             "--results_root", root, "--device", DEVICE]
            + (["--learn_bin_widths"] if learn_bin_widths else []))
        stats_dir = os.path.join(exp_dir, "statistics")
        map_mean = numpy.load(os.path.join(stats_dir, "map_mean.npy"))
        probabilities = numpy.load(os.path.join(stats_dir, "binary_probabilities_1.npy"))
        with open(os.path.join(stats_dir, "idx_map_exception.pkl"), "rb") as file:
            idx_exc = pickle.load(file)
        (params_np, bin_widths) = checkpoint.load_params_artifact(
            os.path.join(exp_dir, "params_trained.npz"))
    images = synthetic_luminance_stack(SERVED_IMAGES, TRAIN_CROP, TRAIN_CROP, seed=12)
    compressor = PipelinedCompressor(
        checkpoint.params_from_jax(params_np), bin_widths, learn_bin_widths, probabilities,
        map_mean, idx_map_exception=idx_exc, batch_size=BATCH,
        fast_path="bf16w+" if learn_bin_widths else None, verify=True, reconstruct=True,
        device=DEVICE)
    (recs, bits) = compressor(images)
    if recs.shape != images.shape or recs.dtype != numpy.uint8 or not numpy.all(bits > 0):
        raise AssertionError(f"{tag}: served reconstructions {recs.shape} {recs.dtype}, bits "
                             f"{bits}")
    psnrs = [psnr_2d(images[i, :, :, 0], recs[i, :, :, 0]) for i in range(SERVED_IMAGES)]
    print(f"  trained {steps} steps, checkpointed, statistics on {EXTRA_IMAGES} held-out crops, "
          f"served {SERVED_IMAGES} images ({compressor.fast_path or 'fp32'}, verified): "
          f"{bits.sum() / images[..., 0].size:.4f} bpp, PSNR mean {numpy.mean(psnrs):.4f} dB")
    if not numpy.all(numpy.isfinite(psnrs)):
        raise AssertionError(f"{tag}: PSNR {psnrs}")
    step_noise = (_uniform_noise(latent, 4), _uniform_noise(latent, 5))
    return ({f"training, {tag}": launches}, step_ms,
            lambda: fns["train_step"](state, eval_batch, step_noise))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU.", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print("phase 1: card")
    print(f"  {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_all()

    print("phase 2: kernels against their plain versions")
    kernel_results = phase_kernels()
    phase_gradient()
    print("phase 3: serving (PipelinedCompressor)")
    path_launches = phase_serving(kernel_results)
    print("phase 4: fixed-bin-width roundtrip_batched")
    path_launches.update(phase_fixed_bw())
    print("phase 5: training (pre-fit, train_step, checkpoint, collect_stats, serve)")
    replays = {}
    for learn_bin_widths in (True, False):
        (launches, step_ms, step) = phase_training(kernel_results, learn_bin_widths)
        path_launches.update(launches)
        replays[next(iter(launches))] = (step_ms, step)
    # Last of the device work: a refused capture may leave the context unusable.
    for (path, (step_ms, step)) in replays.items():
        (replayed_ms, reason) = replayed_step_ms(step)
        print(f"  one train_step replayed from a CUDA graph, {path}: "
              + (f"not measured ({reason})" if replayed_ms is None else
                 f"{replayed_ms:.3f} ms of device work against {step_ms:.3f} ms eager "
                 f"(device busy {100 * replayed_ms / step_ms:.1f} % of the eager step)"))

    print("phase 6: kernel times")
    # Each kernel of a path, with its launches on that path (the counts
    # are per variant: a variant's shapes on one path share them).
    on_path = [("gdn_f32", "serving bf16w+", "H/4"), ("igdn_bf16", "serving bf16w+", "H/4"),
               ("igdn_f32", "serving fp32", "H/4"),
               ("gdn_quantize_f32", "fixed-bw roundtrip", "H/16")]
    on_path += [(name, "training, fixed bin widths", shape)
                for name in ("gdn_f32", "igdn_f32") for shape in TRAIN_SHAPES]
    on_path += [(name, "training, learned bin widths", "T/4") for name in ("gdn_f32", "igdn_f32")]
    kernels = []
    for (name, path, shape) in on_path:
        launches = path_launches[path][name]
        if launches <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")
        result = kernel_results[(name, shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_KERNELS}:{VARIANTS[name][5]}", "launches": launches,
            "max_abs_err": result["max_abs_err"], "ms": result["ms"],
            "ms_eager": result["ms_eager"], "plain_ms": result["plain_ms"],
            "bound_ms": result["bound_ms"], "bound_by": result["bound_by"], "library_ms": None,
            "path": path, "rows": ROWS[shape]})
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
