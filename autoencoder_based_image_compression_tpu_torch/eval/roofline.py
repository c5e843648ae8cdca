"""Roofline accounting: analytic codec FLOPs against the device's
measured matmul ceiling.

Counterpart of the reference's ``eval/roofline.py``:

- :func:`conv_eae_flops`: exact MAC counts of the conv entropy
  autoencoder's transforms (convs and GDN channel matmuls, the only
  FLOP-dense operations).
- :func:`measure_matmul_peak`: the matmul ceiling of the device in a
  dtype, measured with a chain of large square products, not read from
  a data sheet.
- :func:`roofline_report`: achieved FLOP/s of the codec round trip
  against that ceiling.
"""

import time

import torch

from autoencoder_based_image_compression_tpu_torch import constants as csts
from autoencoder_based_image_compression_tpu_torch.eval.throughput import (
    parity_and_throughput,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device


def _conv_macs(out_height, out_width, kernel_height, kernel_width, nb_in, nb_out):
    return out_height * out_width * kernel_height * kernel_width * nb_in * nb_out


def conv_eae_flops(height, width, learn_bin_widths=True):
    """FLOPs (2 * MACs) of one image through encoder + decoder.

    Counts the three strided convs (9/5/5, strides 4/2/2), their
    transposed mirrors, and the GDN / IGDN channel matmuls (``x^2 @
    gamma``, a ``(HW, 128) @ (128, 128)`` product per normalisation).
    Elementwise work (bias, sqrt, divide, quantise) is left out: it is
    orders of magnitude below the matmul term.
    """
    nb_maps = csts.NB_MAPS_3
    (h4, w4) = (height // 4, width // 4)
    (h8, w8) = (height // 8, width // 8)
    (h16, w16) = (height // 16, width // 16)

    macs = 0
    # Encoder convs (SAME padding keeps out = in / stride).
    macs += _conv_macs(h4, w4, 9, 9, 1, csts.NB_MAPS_1)
    macs += _conv_macs(h8, w8, 5, 5, csts.NB_MAPS_1, csts.NB_MAPS_2)
    macs += _conv_macs(h16, w16, 5, 5, csts.NB_MAPS_2, nb_maps)
    # Decoder transposed convs: MACs = (input extent) x kernel x channels.
    macs += _conv_macs(h16, w16, 5, 5, nb_maps, csts.NB_MAPS_2)
    macs += _conv_macs(h8, w8, 5, 5, csts.NB_MAPS_2, csts.NB_MAPS_1)
    macs += _conv_macs(h4, w4, 9, 9, csts.NB_MAPS_1, 1)
    # GDN/IGDN channel matmuls: two in the encoder, two in the decoder,
    # plus the GDN_3 / IGDN_4 bottleneck pair iff bin widths are fixed.
    macs += h4 * w4 * csts.NB_MAPS_1 ** 2      # GDN_1
    macs += h8 * w8 * csts.NB_MAPS_2 ** 2      # GDN_2
    macs += h8 * w8 * csts.NB_MAPS_2 ** 2      # IGDN_5
    macs += h4 * w4 * csts.NB_MAPS_1 ** 2      # IGDN_6
    if not learn_bin_widths:
        macs += 2 * h16 * w16 * nb_maps ** 2   # GDN_3 + IGDN_4
    return 2 * macs


def measure_matmul_peak(size=4096, dtype=torch.bfloat16, repeats=5, nb_chained=16,
                        device="cuda"):
    """Achievable matmul FLOP/s of ``device`` in ``dtype``.

    Chains ``nb_chained`` dependent ``(size, size)`` products
    (``torch.matmul``: a plain large matrix product, the library's
    work), renormalising between them so that the chain stays finite.
    Only the products are timed (a CUDA event before and after each on
    the card, the host clock on the CPU): the renormalisation is a few
    elementwise passes that would otherwise count against the ceiling.
    fp32 products run with TF32 off, as the parity path's convs do.
    Returns FLOP/s, best of ``repeats``.
    """
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    a = torch.randn((size, size), generator=generator).to(device=device, dtype=dtype)
    b = torch.randn((size, size), generator=generator).to(device=device, dtype=dtype)
    on_card = device.type == "cuda"

    def chain():
        (carry, seconds, events) = (a, 0.0, [])
        for _ in range(nb_chained):
            if on_card:
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
                product = torch.matmul(carry, b)
                events[-1][1].record()
            else:
                start = time.perf_counter()
                product = torch.matmul(carry, b)
                seconds += time.perf_counter() - start
            product = product.to(torch.float32)
            scale = torch.rsqrt(torch.mean(torch.square(product)) + 1e-30)
            carry = (product * scale).to(dtype)
        if on_card:
            torch.cuda.synchronize(device)
            seconds = 1e-3 * sum(start.elapsed_time(end) for (start, end) in events)
        if not bool(torch.isfinite(carry.to(torch.float32).sum())):
            raise FloatingPointError("the matmul chain left the finite range.")
        return seconds

    chain()  # warm-up: the library picks its kernel
    return nb_chained * 2.0 * size ** 3 / min(chain() for _ in range(repeats))


def roofline_report(params, images_uint8, bin_widths, learn_bin_widths=True, repeats=5,
                    peak_flops=None, nb_in_flight=4, weight_mode="bf16w", device="cuda"):
    """Achieved codec FLOP/s against the measured matmul ceiling.

    Times the fp32 parity path and the serving variant ``weight_mode``
    over the given batch with ``nb_in_flight`` batches queued back to
    back (``throughput.parity_and_throughput``), converts to FLOP/s with
    the analytic count of :func:`conv_eae_flops`, and reports each
    path's share of the ceiling of its dtype: the parity path against
    the true-fp32 matmul peak (TF32 off, CUDA cores), the serving
    variant against the bf16 peak (tensor cores). ``peak_flops``, when
    given, is a ``{"parity": x, "fast": y}`` override. The keys are the
    reference's, with its ``mxu_utilization_*`` named
    ``tensor_core_utilization_*`` here (for the parity path that is the
    share of the fp32 ceiling, which no tensor core serves).
    """
    (nb_images, height, width) = images_uint8.shape[:3]
    flops_per_batch = nb_images * conv_eae_flops(height, width, learn_bin_widths)
    measured = parity_and_throughput(params, images_uint8, bin_widths, repeats=repeats,
                                     nb_in_flight=nb_in_flight, weight_mode=weight_mode,
                                     device=device)
    nb_pixels = nb_images * height * width
    flops_per_pixel = flops_per_batch / nb_pixels
    if peak_flops is None:
        peak_flops = {"parity": measure_matmul_peak(dtype=torch.float32, device=device),
                      "fast": measure_matmul_peak(dtype=torch.bfloat16, device=device)}
    achieved_parity = measured["mpix_per_s_parity"] * 1e6 * flops_per_pixel
    achieved_fast = measured["mpix_per_s_fast"] * 1e6 * flops_per_pixel
    return {
        "flops_per_pixel": flops_per_pixel,
        "peak_flops_per_s_parity": peak_flops["parity"],
        "peak_flops_per_s_fast": peak_flops["fast"],
        "achieved_flops_per_s_parity": achieved_parity,
        "achieved_flops_per_s_fast": achieved_fast,
        "tensor_core_utilization_parity": achieved_parity / peak_flops["parity"],
        "tensor_core_utilization_fast": achieved_fast / peak_flops["fast"],
        "mpix_per_s_parity": measured["mpix_per_s_parity"],
        "mpix_per_s_fast": measured["mpix_per_s_fast"],
        "psnr_fast_vs_parity_db": measured["psnr_fast_vs_parity_db"],
        "weight_mode": weight_mode,
    }
