"""Batched and pipelined inference on one device.

Counterpart of the reference's ``parallel/inference.py`` without its
mesh: :func:`roundtrip_batched` (encode + quantise + decode, batch by
batch) and :class:`PipelinedCompressor` (device transforms overlapped
with the host C++ arithmetic coder). Both run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

import collections
import time

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.coding.compression import (
    compress_lossless_images,
)
from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops.kernels.gdn_kernel import (
    gdn_quantize_nhwc,
)
from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
    cast_bt601,
    quantize_per_map,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device


def _to_device(params, device):
    return {name: value.to(device) for (name, value) in params.items()}


def _as_f32(array, device):
    return torch.tensor(numpy.asarray(array, numpy.float32), device=device)


def roundtrip_batched(params, images_uint8, bin_widths, learn_bin_widths,
                      batch_size, device="cuda"):
    """Encode + quantise + decode a uint8 ``(N, H, W, 1)`` image stack.

    ``params`` is the dict of ``train.checkpoint.params_from_jax``.
    Batches are queued on the device back to back and fetched at the
    end. In the fixed-bin-width variant, GDN_3 and the quantiser after
    it are one launch of the fused GDN+quantise kernel (uncentred,
    ``bw * round(gdn(x) / bw)``). Returns float32 reconstructions (the
    caller applies ``cast_bt601``).
    """
    device = resolve_device(device)
    params = _to_device(params, device)
    bin_widths = _as_f32(bin_widths, device)
    outputs = []
    for start in range(0, images_uint8.shape[0], batch_size):
        batch = torch.from_numpy(
            numpy.ascontiguousarray(images_uint8[start:start + batch_size])
        ).to(device).to(torch.float32)
        if learn_bin_widths:
            quantized = quantize_per_map(conv_eae.encode(params, batch, True),
                                         bin_widths)
        else:
            quantized = gdn_quantize_nhwc(conv_eae.analysis(params, batch),
                                          params["gamma_3"], params["beta_3"],
                                          bin_widths)
        outputs.append(conv_eae.decode(params, quantized, learn_bin_widths))
    return numpy.concatenate([out.cpu().numpy() for out in outputs], axis=0)


class _Fetch:
    """A device->host copy in flight: into pinned memory with
    ``non_blocking`` on the card, waited on through a CUDA event when the
    host needs it; a plain copy on the CPU."""

    def __init__(self, *tensors):
        self.host = []
        self.event = None
        for tensor in tensors:
            if tensor.device.type == "cuda":
                host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
                host.copy_(tensor, non_blocking=True)
            else:
                host = tensor.clone()
            self.host.append(host)
        if any(t.device.type == "cuda" for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host


class PipelinedCompressor:
    """Overlaps device encode/decode with host arithmetic coding.

    Drives the full true-rate pipeline over an image stack: the device
    runs up to ``max_in_flight`` batches ahead while the C++ coder
    thread pool compresses the symbols of the oldest one.
    """

    def __init__(self, params, bin_widths, learn_bin_widths, binary_probabilities,
                 map_mean, idx_map_exception=-1, batch_size=4, fast_path=None,
                 reconstruct=True, verify=True, max_in_flight=4, device="cuda"):
        """``params`` is the dict of ``train.checkpoint.params_from_jax``.

        ``fast_path``: None runs the fp32 transforms; "bf16w+" the
        serving engine's (fp32 analysis transform, bf16 synthesis
        transform whose tconv_4 takes the latents unrounded and gives an
        fp32 output, ``engine.BF16WPLUS_*``;
        learned-bin-width architecture only).

        ``reconstruct=False`` is the compress-only mode: no decode, and
        ``__call__`` returns ``(None, nb_bits_per_image)``.
        ``verify=True`` round-trips and asserts every coded map;
        ``verify=False`` encodes only (same bit counts).
        ``max_in_flight`` bounds the dispatched-but-uncoded batches.
        """
        self.device = resolve_device(device)
        self._fp32_tail = 0
        self._fp32_head = False
        self._exact_latents = False
        self._fp32_enc_tail = 0
        if fast_path is not None:
            if fast_path != "bf16w+":
                raise ValueError(
                    f"unknown fast_path {fast_path!r} (use 'bf16w+' or None).")
            if not learn_bin_widths:
                raise ValueError(
                    "fast_path requires the learned-bin-width architecture.")
            self._fp32_tail = engine.BF16WPLUS_DEC_TAIL
            self._fp32_head = engine.BF16WPLUS_DEC_HEAD
            self._exact_latents = engine.BF16WPLUS_DEC_EXACT_LATENTS
            self._fp32_enc_tail = engine.BF16WPLUS_ENC_TAIL
            params = engine.bf16_weight_params(
                params, fp32_tail=self._fp32_tail,
                fp32_enc_tail=self._fp32_enc_tail)
        if max_in_flight < 1:
            raise ValueError("`max_in_flight` must be >= 1.")
        self.fast_path = fast_path
        self.params = _to_device(params, self.device)
        self.bin_widths = _as_f32(bin_widths, self.device)
        self.map_mean = _as_f32(map_mean, self.device)
        self.learn_bin_widths = learn_bin_widths
        self.binary_probabilities = (
            numpy.load(binary_probabilities)
            if isinstance(binary_probabilities, str) else binary_probabilities)
        self.idx_map_exception = idx_map_exception
        self.batch_size = batch_size
        self.reconstruct = reconstruct
        self.verify = verify
        self.max_in_flight = max_in_flight
        # Deepest window observed during the last __call__.
        self.peak_in_flight = 0
        # Phase breakdown (wall/coder/fetch_wait seconds) of the last __call__.
        self.last_timing = None

    def encode_symbols(self, batch_uint8):
        """uint8 ``(B, H, W, 1)`` device batch -> ``(sym16, sym8, max_abs)``.

        The uint8 -> fp32 cast, the centring by the map means and the
        quantisation ``round((y - mean) / bw)`` (fp32, true division)
        run on the device. Both narrow images are clamped before the
        cast, so the casts are defined; each is used only when the
        magnitude check on ``max_abs`` says it is exact.
        """
        batch = batch_uint8.to(torch.float32)
        if self.fast_path is not None:
            y = engine.fast_encode(self.params, batch, learn_bin_widths=True,
                                   fp32_enc_tail=self._fp32_enc_tail)
        else:
            y = conv_eae.encode(self.params, batch, self.learn_bin_widths)
        sym = torch.round((y - self.map_mean) / self.bin_widths)
        sym16 = sym.clamp(-32768.0, 32767.0).to(torch.int16)
        sym8 = sym.clamp(-128.0, 127.0).to(torch.int8)
        return (sym16, sym8, sym.abs().amax())

    def decode_symbols(self, symbols16):
        """int16 symbols -> BT.601 uint8 reconstructions, on the device."""
        quantized = symbols16.to(torch.float32) * self.bin_widths + self.map_mean
        if self.fast_path is not None:
            reconstruction = engine.fast_decode(self.params, quantized,
                                                fp32_tail=self._fp32_tail,
                                                fp32_head=self._fp32_head,
                                                exact_latents=self._exact_latents)
        else:
            reconstruction = conv_eae.decode(self.params, quantized,
                                             self.learn_bin_widths)
        return cast_bt601(reconstruction)

    def _dispatch(self, images_uint8, start):
        """Queues one batch's encode, the narrow symbol fetch, and the
        optional decode with its fetch."""
        batch = torch.from_numpy(numpy.ascontiguousarray(
            images_uint8[start:start + self.batch_size])).to(self.device)
        (symbols16, symbols8, max_abs) = self.encode_symbols(batch)
        symbols_fetch = _Fetch(symbols8, max_abs)
        reconstruction_fetch = None
        if self.reconstruct:
            reconstruction_fetch = _Fetch(self.decode_symbols(symbols16))
        return (start, symbols16, symbols_fetch, reconstruction_fetch)

    def __call__(self, images_uint8):
        """Returns ``(reconstructions_uint8, nb_bits_per_image)``.

        A sliding window of ``max_in_flight`` dispatched batches runs
        ahead of the coder. The symbols come back as int8 when the
        batch's max magnitude fits, else as int16; a magnitude above the
        int16 range (or NaN) raises before anything is coded.
        """
        nb = images_uint8.shape[0]
        starts = list(range(0, nb, self.batch_size))
        bits_per_start = {}
        recs_per_start = {}
        inflight = collections.deque()
        self.peak_in_flight = 0
        timing = {"wall": 0.0, "coder": 0.0, "fetch_wait": 0.0}
        t_call = time.perf_counter()
        next_idx = 0
        while next_idx < len(starts) or inflight:
            while (next_idx < len(starts)
                   and len(inflight) < self.max_in_flight):
                inflight.append(self._dispatch(images_uint8, starts[next_idx]))
                next_idx += 1
                self.peak_in_flight = max(self.peak_in_flight, len(inflight))
            (start, symbols16, symbols_fetch, reconstruction_fetch) = (
                inflight.popleft())
            t0 = time.perf_counter()
            (symbols8_host, max_abs_host) = symbols_fetch.wait()
            max_abs = float(max_abs_host)
            if not max_abs <= 32767.0:
                raise OverflowError(
                    "A symbol magnitude exceeds the int16 range.")
            if max_abs <= 127.0:
                symbols_host = symbols8_host.numpy().astype(numpy.int16)
            else:
                symbols_host = symbols16.cpu().numpy()
            timing["fetch_wait"] += time.perf_counter() - t0
            del symbols16
            t0 = time.perf_counter()
            bits_per_start[start] = compress_lossless_images(
                symbols_host, self.binary_probabilities,
                self.idx_map_exception, verify=self.verify)
            timing["coder"] += time.perf_counter() - t0
            if reconstruction_fetch is not None:
                t0 = time.perf_counter()
                (recs_per_start[start],) = reconstruction_fetch.wait()
                timing["fetch_wait"] += time.perf_counter() - t0
        timing["wall"] = time.perf_counter() - t_call
        self.last_timing = timing
        bits = numpy.concatenate([bits_per_start[s] for s in starts])
        if not self.reconstruct:
            return (None, bits)
        recs = numpy.concatenate([recs_per_start[s].numpy() for s in starts], axis=0)
        return (recs, bits)
