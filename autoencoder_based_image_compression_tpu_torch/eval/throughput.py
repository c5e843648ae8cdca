"""Throughput, fast-path parity and scaling measurements.

Counterpart of the reference's ``eval/throughput.py``: encode + decode
Mpix/s of the fp32 parity path and of a serving variant, the PSNR
between their reconstructions, a ``torch.profiler`` trace of one round
trip, and ``scaling_report``, the round trip's Mpix/s over data-parallel
meshes of 1, 2, 4 ... devices (``parallel.mesh``). On a machine with one
card that is the one-device row alone: no scaling figure.

PyTorch returns before the device has finished, so every timed region
ends in a barrier (``torch.cuda.synchronize`` on the card); the checksum
of each result is kept and read so that no execution can be skipped.
"""

import os
import time

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
    cast_bt601,
    quantize_per_map,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device


def barrier(device):
    """Waits until ``device`` has finished what was queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_with_checksum(fn, *args, repeats=5, nb_in_flight=1):
    """Best of ``repeats`` of the wall time of one ``fn(*args).sum()``.

    With ``nb_in_flight > 1`` that many executions are queued back to
    back before the wait (the sustained-serving pattern) and the time
    per execution is returned.
    """
    def run():
        return fn(*args).sum()

    checksum = run()  # warm-up: cuDNN plans, the kernels' library
    barrier(checksum.device)
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        checksums = [run() for _ in range(nb_in_flight)]
        barrier(checksums[-1].device)
        times.append((time.perf_counter() - start) / nb_in_flight)
        if not all(numpy.isfinite(float(checksum)) for checksum in checksums):
            raise FloatingPointError("a timed execution gave a non-finite checksum.")
    return min(times)


def parity_path(params, images, bin_widths):
    """The fp32 round trip: encode, quantise (uncentred), decode."""
    y = conv_eae.encode(params, images, True)
    return conv_eae.decode(params, quantize_per_map(y, bin_widths), True)


def parity_and_throughput(params, images_uint8, bin_widths, repeats=5, nb_in_flight=1,
                          weight_mode="bf16w", device="cuda"):
    """Compares the fp32 parity path with a serving variant.

    ``weight_mode`` picks the variant: "bf16w" (bf16-rounded kernels,
    all-bf16 activations), "bf16w+" (``engine.BF16WPLUS_SCAN_MIX``) or
    "int8" (int8 weight store); each decodes integer symbols with the
    bin widths folded into its first decoder kernel
    (``engine.scan_variant``). Returns Mpix/s of both paths and the PSNR
    between their uint8 reconstructions. Learned-bin-width architecture;
    ``params`` is the dict of ``train.checkpoint.params_from_jax``.
    """
    device = resolve_device(device)
    params = {name: value.to(device) for (name, value) in params.items()}
    images = torch.from_numpy(numpy.ascontiguousarray(images_uint8)).to(device).to(
        torch.float32)
    bin_widths = torch.tensor(numpy.asarray(bin_widths, numpy.float32)).to(device)
    nb_pixels = images.shape[0] * images.shape[1] * images.shape[2]
    (qparams, qfolded, knobs) = engine.scan_variant(params, bin_widths, weight_mode)

    def fast_path(images):
        (reconstructions, _) = engine.fast_roundtrip_scan(
            qparams, qfolded, images[None], bin_widths, **knobs)
        return reconstructions[0]

    seconds_parity = time_with_checksum(parity_path, params, images, bin_widths,
                                        repeats=repeats, nb_in_flight=nb_in_flight)
    seconds_fast = time_with_checksum(fast_path, images, repeats=repeats,
                                      nb_in_flight=nb_in_flight)
    rec_parity = cast_bt601(parity_path(params, images, bin_widths)).cpu().numpy()
    rec_fast = cast_bt601(fast_path(images)).cpu().numpy()
    if numpy.array_equal(rec_parity, rec_fast):
        psnr_between = float("inf")
    else:
        psnr_between = float(numpy.mean([
            psnr_2d(rec_parity[i, :, :, 0], rec_fast[i, :, :, 0])
            for i in range(rec_parity.shape[0])]))
    return {
        "mpix_per_s_parity": nb_pixels / seconds_parity / 1e6,
        "mpix_per_s_fast": nb_pixels / seconds_fast / 1e6,
        "psnr_fast_vs_parity_db": psnr_between,
        "weight_mode": weight_mode,
    }


def scaling_report(params, bin_widths, image_shape, per_device_batch, model_parallelism=1,
                   repeats=3, devices=None, device="cuda"):
    """Times the sharded round trip on meshes of 1, 2, 4 ... devices.

    ``devices`` lists the devices to scale over (default: every visible
    card for ``device="cuda"``, the one CPU for ``"cpu"``); a mesh of
    ``n`` takes the first ``n``, with ``model_parallelism`` of them a
    model group, and runs a batch of ``per_device_batch`` images a data
    shard. Returns ``{"mpix_per_s": {n: ...}, "efficiency": {n: ...}}``,
    efficiency being Mpix/s over ``n`` times the one-device figure (None
    without a one-device row, as when ``model_parallelism > 1``). With
    one card the report has one row, efficiency 1.0: not a scaling
    figure.
    """
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        make_codec_fns,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh

    if devices is None:
        device = resolve_device(device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
    results = {}
    n = model_parallelism  # the smallest mesh holds one model group
    while n <= len(devices):
        mesh = make_mesh(model_parallelism, devices=devices[:n])
        (encode_fn, decode_fn, put) = make_codec_fns(True, mesh)
        shape = (per_device_batch * (n // model_parallelism),) + tuple(image_shape) + (1,)
        batch = put(numpy.zeros(shape, numpy.float32))

        def roundtrip(params, batch, bin_widths):
            return decode_fn(params, encode_fn(params, batch), bin_widths).local_sum()

        seconds = time_with_checksum(roundtrip, params, batch, bin_widths, repeats=repeats)
        results[n] = shape[0] * shape[1] * shape[2] / seconds / 1e6
        n *= 2
    base = results.get(1)
    return {
        "mpix_per_s": results,
        "efficiency": {n: (v / (n * base)) if base else None for (n, v) in results.items()},
    }


def profile_roundtrip(params, images_uint8, bin_widths, trace_dir, device="cuda"):
    """Writes a ``torch.profiler`` Chrome trace of one parity-path round
    trip to ``<trace_dir>/roundtrip_trace.json`` (open it in a Chromium
    browser's tracing page or in Perfetto) and returns ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    params = {name: value.to(device) for (name, value) in params.items()}
    images = torch.from_numpy(numpy.ascontiguousarray(images_uint8)).to(device).to(
        torch.float32)
    bw = torch.tensor(numpy.asarray(bin_widths, numpy.float32)).to(device)
    parity_path(params, images, bw)  # warm-up stays out of the trace
    barrier(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as trace:
        parity_path(params, images, bw)
        barrier(device)
    os.makedirs(trace_dir, exist_ok=True)
    trace.export_chrome_trace(os.path.join(trace_dir, "roundtrip_trace.json"))
    return trace_dir
