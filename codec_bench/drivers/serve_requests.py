"""Closed-loop serving of true bitstreams through ``PipelinedCompressor``.

One client sends requests back to back. A request holds
``images_per_request`` images of ``height`` x ``width``, drawn in turn
from a pool of ``pool_images`` made at set-up from ``--seed``; the
program encodes them on the device, codes every latent map with the host
arithmetic coder (verified), decodes them, and hands back the uint8
reconstructions and each image's bit count. A request counts from the
call until both are on the host.

Set-up loads the committed trained model and its statistics through the
program's loader, makes the pool on the card, and warms the pipeline up
on ``warmup_requests`` requests of the window's shape.

``correct``: once the window has closed, the plain reference encodes,
quantises and decodes every pool image in fp32 and counts the exact
length of each image's bitstream from the symbols and the committed
statistics. Against it: every request's bit counts (``rate_gap``, the
worst image's relative gap), and the reconstructions of the requests
kept, a share drawn from the seed with the last one always in it
(``rec_mse``, the worst image's mean squared difference to the
reference's reconstruction in levels squared; ``psnr_drop``, the worst
image's PSNR against the original under the reference's, in dB). A
request that raises or returns the wrong shapes counts as failed.
"""

import contextlib
import os
import time
import traceback

import numpy
import torch

from codec_bench import harness, roofline, synthetic, trace
from codec_bench.reference import codec, rate


def make_pool(context):
    traffic = context.traffic
    device = torch.device(context.device)
    generator = torch.Generator(device).manual_seed(context.seed % 2 ** 63)
    return synthetic.luminance_stack(traffic["pool_images"], traffic["height"], traffic["width"],
                                     generator, device).cpu().numpy()


def program(context, fast_path):
    """The program's serving pipeline on the configuration's trained model."""
    from autoencoder_based_image_compression_tpu_torch.eval.workload import load_model
    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        PipelinedCompressor,
    )

    serving = context.config["serving"]
    (params, bin_widths, map_mean, probabilities, idx_exception) = load_model(
        os.path.join(context.root, serving["artifact"]))
    return PipelinedCompressor(params, bin_widths, context.config["learn_bin_widths"],
                               probabilities, map_mean, idx_map_exception=idx_exception,
                               batch_size=context.traffic["batch_size"], fast_path=fast_path,
                               verify=True, reconstruct=True, device=context.device)


def request_indices(i, per_request, pool_size):
    return (i * per_request + numpy.arange(per_request)) % pool_size


def run(context, serve=None):
    """A serving cell's run. ``serve``, a callable ``images -> (recs,
    bits)``, stands in for the program (the control); by default the
    program's pipeline on the configuration's path."""
    from autoencoder_based_image_compression_tpu_torch.parallel import inference

    traffic = context.traffic
    serving = context.config["serving"]
    device = torch.device(context.device)
    pool = make_pool(context)
    if serve is None:
        serve = program(context, serving["fast_path"])
    per_request = traffic["images_per_request"]
    (height, width) = (traffic["height"], traffic["width"])
    for _ in range(traffic["warmup_requests"]):
        serve(pool[request_indices(0, per_request, len(pool))])
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    result = harness.Run()
    result.setup_s = time.time() - context.started
    keep = numpy.random.default_rng(context.seed % 2 ** 63)
    (latencies, bits, kept, paused, traced) = ([], {}, {}, 0.0, 0)
    profile = trace.profiler(context.device) if context.trace else None
    labels = ((inference, "compress_lossless_images", "codec_bench.coder"),
              (inference.Fetch, "wait", "codec_bench.fetch_wait"))
    with contextlib.ExitStack() as stack:
        if profile is not None:
            for (owner, attribute, label) in labels:
                stack.enter_context(trace.labelled(owner, attribute, label))
        started = time.perf_counter()
        i = 0
        while True:
            indices = request_indices(i, per_request, len(pool))
            images = pool[indices]
            in_trace = (profile is not None and result.trace is None
                        and time.perf_counter() - started - paused < traffic["trace_seconds"])
            if in_trace and traced == 0:
                paused += trace.start(profile)
            t0 = time.perf_counter()
            try:
                with (torch.profiler.record_function(trace.WINDOW_SPAN) if in_trace
                      else contextlib.nullcontext()):
                    (recs, image_bits) = serve(images)
                t1 = time.perf_counter()
                ok = (recs is not None and recs.shape == images.shape
                      and recs.dtype == numpy.uint8 and numpy.shape(image_bits) == (per_request,))
            except Exception:  # a request that raises is a failed request; the run goes on
                traceback.print_exc()
                (t1, ok) = (time.perf_counter(), False)
            result.attempted += 1
            latencies.append(t1 - t0)
            traced += in_trace
            if ok:
                bits[i] = (indices, numpy.asarray(image_bits, dtype=numpy.int64))
                if getattr(serve, "last_timing", None) is not None:
                    result.requests.append(dict(serve.last_timing))
                if keep.random() < traffic["kept_share"]:
                    kept[i] = recs
            else:
                result.failed += 1
            if traced and not in_trace and result.trace is None:
                (result.trace, seconds) = trace.stop(profile)
                paused += seconds
            i += 1
            if t1 - started - paused >= context.seconds:
                if ok:
                    kept[i - 1] = recs
                break
        if traced and result.trace is None:
            (result.trace, seconds) = trace.stop(profile)
            paused += seconds
        result.window_s = time.perf_counter() - started - paused
    if result.trace is not None:
        result.trace.require([label for (_, _, label) in labels])
    if device.type == "cuda":
        result.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    served = len(bits)
    pixels = per_request * height * width
    result.metrics["serve_mpix_per_s"] = served * pixels / result.window_s / 1e6
    result.metrics["request_p95_ms"] = 1e3 * float(numpy.percentile(latencies, 95))
    learn = context.config["learn_bin_widths"]
    bf16 = serving["bf16_layers"]
    image_flops = roofline.serve_flops(height, width, learn, bf16)
    result.work = {"mpix": served * pixels / 1e6,
                   "flops": {k: served * per_request * v for (k, v) in image_flops.items()}}
    units = -(-per_request // traffic["batch_size"])
    unit_bound = roofline.gdn_sites_bound_s(roofline.serve_gdn_sites(
        learn, traffic["batch_size"], height, width, bf16))
    result.traced = {"mpix": traced * pixels / 1e6, "gdn_bound_s": traced * units * unit_bound}

    # The window has closed: free the program, then the reference.
    del serve
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result.checks = compare(context, pool, bits, kept)
    return result


def reference_outputs(context, pool, dtype=torch.float32):
    """``(symbols, reconstructions, bits)`` of every pool image by the
    plain reference."""
    exp_dir = os.path.join(context.root, context.config["serving"]["artifact"])
    (params, bin_widths) = codec.load_params(os.path.join(exp_dir, "params_trained.npz"),
                                             torch.device(context.device))
    (map_mean, probabilities, idx_exception) = codec.load_statistics(exp_dir)
    (symbols, recs) = codec.roundtrip(params, bin_widths, map_mean, pool,
                                      context.traffic["batch_size"], dtype)
    return (symbols, recs, rate.image_bits(symbols, probabilities, idx_exception))


def compare(context, pool, bits, kept):
    """The numbers compared (see the module docstring)."""
    (_, reference_recs, reference_bits) = reference_outputs(context, pool)
    checks = {"rate_gap": 0.0, "rec_mse": 0.0, "psnr_drop": 0.0}
    per_request = context.traffic["images_per_request"]
    for (indices, image_bits) in bits.values():
        gap = numpy.abs(image_bits - reference_bits[indices]) / reference_bits[indices]
        checks["rate_gap"] = max(checks["rate_gap"], float(gap.max()))
    for (i, recs) in kept.items():
        indices = request_indices(i, per_request, len(pool))
        for (rec, j) in zip(recs, indices):
            difference = rec.astype(numpy.float64) - reference_recs[j].astype(numpy.float64)
            checks["rec_mse"] = max(checks["rec_mse"], float(numpy.mean(difference ** 2)))
            drop = codec.psnr(reference_recs[j], pool[j]) - codec.psnr(rec, pool[j])
            checks["psnr_drop"] = max(checks["psnr_drop"], float(drop))
    if not kept:
        checks = {"rate_gap": checks["rate_gap"]}
    return checks

