"""Where the fp32 GDN kernel's time goes, on the card.

Builds ``csrc/gdn.cu`` several times with its ``GDN_PROBE_*`` switches,
each of which takes one part out of the fp32 kernel (the results are
then wrong; only the time is read), and times GDN and IGDN at the main
path's largest shape beside the whole kernel. Also measures the fp32
FMA rate the card sustains (``csrc/fma_peak.cu``), the yardstick for the
kernel's contraction. Needs one NVIDIA GPU and ``nvcc``:

    python -m autoencoder_based_image_compression_tpu_torch.eval.kernel_probe

Prints the card, then one line per build with the replayed time of one
launch (a CUDA graph of 24 launches over inputs that exceed the L2
cache, median of 7), then the FMA rates, then what cuDNN's deterministic
algorithms cost the decoder's two fp32 5 x 5 stride-2 transposed convs
at the serving shapes (``utils.device.deterministic_cudnn``), and whether
each repeats its bits either way, beside the engine's form of the first
(``engine/quantized.py::_tconv4_phases``: a forward conv into the four
output phases, then depth-to-space).
"""

import ctypes
import os
import subprocess
import sys

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.ops.kernels import gdn_kernel
from autoencoder_based_image_compression_tpu_torch.utils.device import (
    deterministic_cudnn,
    disable_tf32,
)

ROWS = 4 * 512 * 768 // 16
TILE_ROWS = 128
PROBES = {
    "whole kernel": [],
    "no epilogue arithmetic": ["-DGDN_PROBE_NO_EPILOGUE"],
    "no squares": ["-DGDN_PROBE_NO_SQUARE"],
    "no loads of the next tile": ["-DGDN_PROBE_NO_PREFETCH"],
    "contraction alone (none of the three)": [
        "-DGDN_PROBE_NO_EPILOGUE", "-DGDN_PROBE_NO_SQUARE", "-DGDN_PROBE_NO_PREFETCH"],
    "contraction alone, operands loaded once": [
        "-DGDN_PROBE_NO_EPILOGUE", "-DGDN_PROBE_NO_SQUARE", "-DGDN_PROBE_NO_PREFETCH",
        "-DGDN_PROBE_NO_SHARED_LOADS"],
}
FMA_PEAK_SOURCE = os.path.join(os.path.dirname(gdn_kernel.LIB_PATH), os.pardir, "fma_peak.cu")


def _build(sources_and_flags):
    """Runs one nvcc per library, all at once; returns the paths."""
    os.makedirs(gdn_kernel.BUILD_DIR, exist_ok=True)
    jobs = []
    for (index, (source, flags)) in enumerate(sources_and_flags):
        path = os.path.join(gdn_kernel.BUILD_DIR, f"probe_{index}.so")
        command = [gdn_kernel._nvcc(), *gdn_kernel.NVCC_FLAGS, *flags, "-o", path, source]
        jobs.append((path, subprocess.Popen(command, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    for (path, job) in jobs:
        (_, errors) = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}:\n{errors}")
    return [path for (path, _) in jobs]


def _replayed_ms(launch, launches=24, repeats=7):
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for index in range(launches):
            launch(index)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        (start, end) = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(numpy.median(times))


def _eager_ms(run, repeats=7):
    """Median device time of ``run()`` in ms, CUDA events."""
    run()
    times = []
    for _ in range(repeats):
        (start, end) = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(numpy.median(times))


def transposed_conv_times(batch_sizes=(4, 24), height=512, width=768):
    """Prints, for the decoder's tconv_4 (input at H/16) and tconv_5
    (input at H/8) in true fp32 on random operands, the time with
    cuDNN's default algorithm and with the deterministic ones, and
    whether two runs give the same bits."""
    disable_tf32()
    generator = torch.Generator(device="cuda").manual_seed(0)
    w = 0.05 * torch.randn(128, 128, 5, 5, device="cuda", generator=generator)
    for batch_size in batch_sizes:
        said = []
        for (name, down) in (("tconv_4", 16), ("tconv_5", 8)):
            x = torch.randn(batch_size, 128, height // down, width // down, device="cuda",
                            generator=generator)

            def run():
                return torch.nn.functional.conv_transpose2d(x, w, stride=2)
            default_ms = _eager_ms(run)
            repeats = torch.equal(run(), run())
            with deterministic_cudnn():
                pinned_ms = _eager_ms(run)
                pinned_repeats = torch.equal(run(), run())
            said.append(f"{name} {default_ms:.4f} ms with cuDNN's default (repeats its bits: "
                        f"{repeats}), {pinned_ms:.4f} ms deterministic ({pinned_repeats})")
            if name == "tconv_4":
                x_nhwc = x.permute(0, 2, 3, 1).contiguous()

                def phases():
                    return engine._tconv4_phases(x_nhwc, w, dtype=torch.float32)
                said.append(f"tconv_4 as the engine's phase conv {_eager_ms(phases):.4f} ms "
                            f"(repeats its bits: {torch.equal(phases(), phases())})")
        print(f"  fp32 transposed convs, batch of {batch_size}: " + "; ".join(said))


def main():
    if not torch.cuda.is_available():
        print("kernel_probe: needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    paths = _build([(gdn_kernel._SOURCE, flags) for flags in PROBES.values()]
                   + [(FMA_PEAK_SOURCE, [])])
    generator = torch.Generator(device="cuda").manual_seed(0)
    inputs = [4.0 * torch.randn(ROWS, 128, device="cuda", generator=generator)
              for _ in range(3)]
    outputs = [torch.empty_like(x) for x in inputs]
    gamma = 0.01 * torch.rand(128, 128, device="cuda", generator=generator)
    beta = torch.ones(128, device="cuda")
    for (label, path) in zip(PROBES, paths):
        fn = ctypes.CDLL(path).aeic_gdn_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        times = []
        for inverse in (0, 1):
            def launch(index=0):
                status = fn(inputs[index % 3].data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                            outputs[index % 3].data_ptr(), ROWS, inverse, TILE_ROWS,
                            torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"launch failed: CUDA error {status}")
            times.append(_replayed_ms(launch))
        print(f"  fp32 at {ROWS} rows, {label}: GDN {times[0]:.4f} ms, IGDN {times[1]:.4f} ms")

    peak = ctypes.CDLL(paths[-1])
    peak.aeic_fma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    peak.aeic_fma_peak.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scratch = torch.empty(sms * 1024, device="cuda")
    iters = 4000
    for threads in (256, 512, 1024):
        def launch(index=0):
            status = peak.aeic_fma_peak(scratch.data_ptr(), sms, threads, iters,
                                        torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"launch failed: CUDA error {status}")
        flops = 2.0 * sms * threads * iters * peak.aeic_fma_peak_fmas_per_iter()
        print(f"  fp32 FMA rate, {sms} blocks of {threads} threads: "
              f"{flops / (1e-3 * _replayed_ms(launch)) / 1e12:.1f} TFLOP/s")
    transposed_conv_times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
