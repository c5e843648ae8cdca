"""The stacked gamma ladder's parts, timed on the card.

Three measurements, each at the shapes a full-width path gives it (128
maps, a batch of 10 crops of 256 x 256 for the ladder's 7 models, the
serving batches of 4 and 24 images of 512 x 768 for the decode):

- every conv site of a ladder step (``models/conv_eae.py::_conv_stacked``)
  grouped over the models against the M per-model convs on channel
  slices: forward, the gradient of the input (dgrad) and of the weights
  (wgrad), each with the step's own layouts and copies;
- the fp32 parity decode (``conv_eae.decode``) with its transposed convs
  as forward convs into their output phases (what it runs without grad)
  against ``conv_transpose2d`` (what it runs with grad), and whether
  each repeats its bits over three decodes of the same latents;
- the kernels of a profiler trace, split into cuDNN's convolutions, the
  GDN kernels and the rest (PyTorch's elementwise and reduce kernels,
  the density model's gathers and scatters).

Needs one NVIDIA GPU and ``nvcc``:

    python -m autoencoder_based_image_compression_tpu_torch.eval.ladder_probe

Times are device times between CUDA events, the median of ``repeats``
calls: the conv sites replayed from CUDA graphs (as a graphed training
epoch runs them), the decodes called from Python back to back.
"""

import subprocess

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.utils.device import disable_tf32

# (input maps a model, output maps a model, kernel, stride, transposed,
# input size as a share of the crop) of each conv site of a ladder step.
SITES = {"conv_1": (1, 128, 9, 4, False, 1), "conv_2": (128, 128, 5, 2, False, 4),
         "conv_3": (128, 128, 5, 2, False, 8), "tconv_4": (128, 128, 5, 2, True, 16),
         "tconv_5": (128, 128, 5, 2, True, 8), "tconv_6": (128, 1, 9, 4, True, 4)}


def _events_ms(before, run, repeats):
    """Median device ms of ``run()`` over ``repeats`` calls, each after an
    untimed ``before()`` whose result ``run`` takes."""
    times = []
    for _ in range(repeats + 1):
        arguments = before()
        (start, end) = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        start.record()
        run(arguments)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(numpy.median(times[1:]))  # the first call sets up cuDNN's plans


def _replayed_ms(fn, repeats, calls=4):
    """Median device ms of one ``fn()`` replayed from a CUDA graph of
    ``calls`` calls (as a graphed training epoch runs it: no host work
    between the kernels), over ``repeats`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # cuDNN's plans and autograd's set-up, before the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(lambda: None, lambda _: graph.replay(), repeats) / calls


def conv_site_times(nb_models=7, batch=10, crop=256, repeats=9, device="cuda"):
    """``{site: {form: (fprop, dgrad, wgrad) ms}}`` for ``form`` in
    ``("grouped", "separate")``, replayed from CUDA graphs: fprop is the
    forward alone, dgrad and wgrad what the forward and the gradient of
    the input or of the weights take beyond it (dgrad None for
    ``conv_1``, whose input is the data)."""
    disable_tf32()
    generator = torch.Generator(device).manual_seed(0)
    results = {}
    for (site, (nb_in, nb_out, kernel, stride, transposed, share)) in SITES.items():
        size = crop // share
        maps = nb_in if site == "conv_1" else nb_models * nb_in
        x = torch.randn((batch, size, size, maps), generator=generator, device=device)
        shape = ((nb_models, nb_in, nb_out, kernel, kernel) if transposed
                 else (nb_models, nb_out, nb_in, kernel, kernel))
        w = 0.05 * torch.randn(shape, generator=generator, device=device)
        results[site] = {}
        for form in ("grouped", "separate"):
            separate = {site} if form == "separate" else set()

            def forward(x_in, w_in):
                return conv_eae._conv_stacked(site, x_in, w_in, stride, transposed, separate)

            with torch.no_grad():
                fprop = _replayed_ms(lambda: forward(x, w), repeats)
            grad_out = torch.ones_like(forward(x, w))

            def backward_of(leaf):
                (x_in, w_in) = (x.detach().requires_grad_(leaf == "x"),
                                w.detach().requires_grad_(leaf == "w"))
                return _replayed_ms(lambda: torch.autograd.grad(
                    forward(x_in, w_in), x_in if leaf == "x" else w_in, grad_out),
                    repeats) - fprop

            dgrad = None if site == "conv_1" else backward_of("x")
            results[site][form] = (fprop, dgrad, backward_of("w"))
    return results


def decode_times(params, batch, height=512, width=768, repeats=9, device="cuda"):
    """fp32 decode of ``batch`` random latents of ``height`` x ``width``
    images (learned bin widths): ``{form: (ms, repeats its bits)}`` for
    the phase form and ``conv_transpose2d``."""
    generator = torch.Generator(device).manual_seed(1)
    y = torch.round(3.0 * torch.randn((batch, height // 16, width // 16, csts.NB_MAPS_3),
                                      generator=generator, device=device))
    forms = {"phase form": conv_eae.conv_transpose_phases,
             "conv_transpose2d": conv_eae.conv_transpose_same}
    results = {}
    with torch.no_grad():
        for (form, tconv) in forms.items():
            def run(_):
                return conv_eae._decode(params, y, True, tconv)

            decodes = [run(None) for _ in range(3)]
            equal = all(torch.equal(decodes[0], other) for other in decodes[1:])
            results[form] = (_events_ms(lambda: None, run, repeats), equal)
    return results


def busy_us(trace):
    """The device's busy time in a profiler trace, in us: the union of
    its kernels' intervals. Where kernels overlap (cuDNN runs a grouped
    convolution's groups side by side) the sum of their durations
    exceeds it. None when the trace holds no kernel interval."""
    from torch.autograd import DeviceType

    spans = sorted((event.time_range.start, event.time_range.end) for event in trace.events()
                   if event.device_type == DeviceType.CUDA)
    if not spans:
        return None
    (total, (start, end)) = (0.0, spans[0])
    for (lo, hi) in spans[1:]:
        if lo > end:
            (total, start, end) = (total + end - start, lo, hi)
        else:
            end = max(end, hi)
    return total + end - start


def kernel_split(run, steps=3):
    """Device ms a call of ``run`` from a profiler trace, split by kernel
    name: ``({"cuDNN": ms, "GDN": ms, "other": ms}, the trace's largest
    kernels [(name, ms a call, launches a call)], the device's busy ms a
    call)``; the split sums the kernels' durations, which exceeds the
    busy time where kernels overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    split = {"cuDNN": 0.0, "GDN": 0.0, "other": 0.0}
    rows = []
    for event in trace.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0))
        name = event.key
        if "gdn_f32_kernel" in name or "gdn_bf16_kernel" in name:
            part = "GDN"
        elif any(tag in name.lower() for tag in ("cudnn", "xmma", "implicit_gemm", "conv",
                                                 "dgrad", "wgrad", "fprop", "cutlass")):
            part = "cuDNN"
        else:
            part = "other"
        split[part] += 1e-3 * us / steps
        rows.append((name[:70], 1e-3 * us / steps, event.count / steps))
    rows.sort(key=lambda row: -row[1])
    busy = busy_us(trace)
    return (split, rows, None if busy is None else 1e-3 * busy / steps)


def main():
    from autoencoder_based_image_compression_tpu_torch.eval import workload

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    print("conv sites of a ladder step (7 models, 10 x 256 x 256), ms fprop / dgrad / wgrad:")
    for (site, forms) in conv_site_times().items():
        print(f"  {site:8s} " + "; ".join(
            f"{form} " + " / ".join("-" if t is None else f"{t:.4f}" for t in times)
            for (form, times) in forms.items()))
    params = {name: value.cuda() for (name, value) in
              workload.load_model(workload.LEARNED)[0].items()}
    for batch in (4, 24):
        for (form, (ms, equal)) in decode_times(params, batch).items():
            print(f"  fp32 decode, batch of {batch}, {form}: {ms:.4f} ms, "
                  f"{'repeats its bits' if equal else 'does NOT repeat its bits'}")


if __name__ == "__main__":
    main()
