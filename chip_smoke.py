#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA GDN kernels (``nvcc``) and the C++ arithmetic coder
(``make``) from the sources in the checkout, then runs six phases:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. every kernel variant against its plain PyTorch version at the main
   path's shapes (a 4 x 512 x 768 batch: rows 98,304 at H/4 and 24,576
   at H/8 for GDN/IGDN in fp32 and bf16, 6,144 at H/16 for GDN+quantise);
3. serving: ``PipelinedCompressor`` (bf16w+, then fp32) over the 24
   synthetic Kodak-shaped images on the trained learned-bin-width model
   and its statistics at multiplier 1, true bitstreams, verified;
   fails if bf16w+'s worst image is more than 0.05 dB below fp32;
4. the fixed-bin-width ``roundtrip_batched`` (fused GDN+quantise);
5. kernel times, bounds and launch counts: one ``{"kernels": [...]}`` line;
6. the result line ``{"ok": true, "device": {...}}``, last.

Launch counts are set to 0 just before each path and read just after.
Any failure exits non-zero; so does a machine without a card. Imports
nothing of JAX.
"""

import json
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LEARNED = os.path.join(REPO, "results", "eae", "learning_bw", "0dot5_10000")
FIXED = os.path.join(REPO, "results", "eae", "fixed_bw", "1_10000")
KERNEL_SOURCE = "autoencoder_based_image_compression_tpu_torch/csrc/gdn.cu"
TPU_KERNELS = "autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py"
GATE_DB = 0.05
BF16_ULP = 2.0 ** -7
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
(BATCH, HEIGHT, WIDTH) = (4, 512, 768)
ROWS = {"H/4": BATCH * HEIGHT * WIDTH // 16, "H/8": BATCH * HEIGHT * WIDTH // 64,
        "H/16": BATCH * HEIGHT * WIDTH // 256}
# Kernel variants: dtype, inverse, quantise, trained (gamma, beta) site,
# the shapes of the main path, and the Pallas body each replaces.
VARIANTS = {
    "gdn_f32": (torch.float32, False, False, (LEARNED, 1), ("H/4", "H/8"), 26),
    "igdn_f32": (torch.float32, True, False, (LEARNED, 6), ("H/4", "H/8"), 26),
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
    with open(gdn_kernel.BUILD_LOG) as log:
        for line in log:
            if "Used" in line or "spill" in line:
                print("  ptxas:", line.strip())


def time_ms(fn, iters=50):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    (start, end) = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_kernels():
    """Each variant against its plain version; returns errors and times."""
    from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel as gk

    results = {}
    for (seed, (name, (dtype, inverse, quantize, _, shapes, _))) in enumerate(VARIANTS.items()):
        kernel = gk.gdn_quantize_2d if quantize else gk.gdn_2d
        plain = gk.gdn_quantize_2d_plain if quantize else gk.gdn_2d_plain
        for shape in shapes:
            rows = ROWS[shape]
            args = kernel_inputs(name, rows, seed)
            got = kernel(*args, inverse=inverse)
            expected = plain(*args, inverse=inverse)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} at {rows} rows: non-finite output")
            diff = (got.float() - expected.float()).abs()
            max_abs = float(diff.max())
            max_rel = float((diff / expected.float().abs().clamp_min(1e-30)).max())
            if quantize:
                flips = got != expected
                flip_share = float(flips.float().mean())
                bw = args[3].expand_as(got)
                if flip_share > 1e-4 or not torch.allclose(diff[flips], bw[flips], rtol=1e-6):
                    raise AssertionError(f"{name}: {flip_share} of the elements off by a bin")
                detail = f"tie flips {int(flips.sum())} of {flips.numel()}"
                tolerance = "identical except ties (<= 1e-4, one bin each)"
            elif dtype == torch.float32:
                torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)
                (detail, tolerance) = ("", "rtol 1e-5, atol 1e-6")
            else:
                if not bool((diff <= BF16_ULP * expected.float().abs()).all()):
                    raise AssertionError(f"{name} at {rows} rows: more than 1 bf16 ulp off")
                (detail, tolerance) = ("", "1 bf16 ulp (rtol 2^-7)")
            ms = time_ms(lambda: kernel(*args, inverse=inverse))
            plain_ms = time_ms(lambda: plain(*args, inverse=inverse))
            (bound_ms, bound_by) = bound(rows, dtype, quantize)
            results[(name, shape)] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by)
            print(f"  {name:17s} rows {rows:6d} ({shape:4s}): max abs err {max_abs:.3e}, "
                  f"max rel err {max_rel:.3e} [{tolerance}] {detail}; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us ({bound_by})")
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


def phase_serving():
    from autoencoder_based_image_compression_tpu_torch.data.synthetic import synthetic_kodak
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
    expect_launches("serving bf16w+", runs["bf16w+"][2],
                    {"gdn_f32": 2 * nb_batches, "igdn_f32": nb_batches,
                     "igdn_bf16": nb_batches})
    expect_launches("serving fp32", runs["fp32"][2],
                    {"gdn_f32": 2 * nb_batches, "igdn_f32": 2 * nb_batches})
    deltas = runs["bf16w+"][0] - runs["fp32"][0]
    rate_gap = abs(int(runs["bf16w+"][1].sum()) - int(runs["fp32"][1].sum()))
    print(f"  bf16w+ vs fp32: worst-image PSNR delta {deltas.min():+.4f} dB "
          f"(gate -{GATE_DB} dB), max |delta| {numpy.abs(deltas).max():.4f} dB, "
          f"total bits differ by {rate_gap / int(runs['fp32'][1].sum()):.3e}")
    if deltas.min() < -GATE_DB:
        raise AssertionError(f"bf16w+ misses the {GATE_DB} dB gate: {deltas.min():+.4f} dB")
    gate_table(params, bin_widths, map_mean, images)
    return {"serving bf16w+": runs["bf16w+"][2], "serving fp32": runs["fp32"][2]}


def gate_table(params, bin_widths, map_mean, images):
    """Worst-image PSNR delta against the fp32 decode for the decoder's
    precision mixes at multipliers 1, 4 and 10 (symbols from the fp32
    encoder). Printed for the record; the gate itself is checked above."""
    from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
    from autoencoder_based_image_compression_tpu_torch.models import conv_eae
    from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
    from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601

    params = {k: v.cuda() for (k, v) in params.items()}
    mean = torch.from_numpy(map_mean.astype(numpy.float32)).cuda()
    batches = [torch.from_numpy(images[i:i + BATCH].astype(numpy.float32)).cuda()
               for i in range(0, images.shape[0], BATCH)]
    latents = [conv_eae.encode(params, batch, True) for batch in batches]
    mixes = {"bf16w+ (tail 0, fp32 head)": (0, True), "tail 0": (0, False),
             "tail 1": (1, False), "tail 2": (2, False), "tail 3": (3, False)}

    def psnrs(decode):
        recs = numpy.concatenate([cast_bt601(decode(y)).cpu().numpy() for y in quantized])
        return numpy.array([psnr_2d(images[i, :, :, 0], recs[i, :, :, 0])
                            for i in range(images.shape[0])])

    for multiplier in (1.0, 4.0, 10.0):
        bw = torch.from_numpy(bin_widths * multiplier).cuda()
        quantized = [torch.round((y - mean) / bw) * bw + mean for y in latents]
        reference = psnrs(lambda y: conv_eae.decode(params, y, True))
        row = []
        for (label, (tail, head)) in mixes.items():
            qp = engine.bf16_weight_params(params, fp32_tail=tail)
            delta = psnrs(lambda y: engine.fast_decode(qp, y, fp32_tail=tail,
                                                       fp32_head=head)) - reference
            row.append(f"{label} {delta.min():+.4f}")
        print(f"  gate table x{multiplier:g} (worst-image delta, dB): " + "; ".join(row))


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
    print("phase 3: serving (PipelinedCompressor)")
    path_launches = phase_serving()
    print("phase 4: fixed-bin-width roundtrip_batched")
    path_launches.update(phase_fixed_bw())

    print("phase 5: kernel times")
    # Each kernel of a path, with its launches on that path.
    on_path = [("gdn_f32", "serving bf16w+", "H/4"), ("igdn_bf16", "serving bf16w+", "H/4"),
               ("igdn_f32", "serving fp32", "H/4"),
               ("gdn_quantize_f32", "fixed-bw roundtrip", "H/16")]
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
            "plain_ms": result["plain_ms"], "bound_ms": result["bound_ms"],
            "bound_by": result["bound_by"], "library_ms": None,
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
