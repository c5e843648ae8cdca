"""Batched and pipelined inference, on one device or over a mesh.

Counterpart of the reference's ``parallel/inference.py``:
:func:`make_codec_fns` (encode and quantise + decode as two device
functions), :func:`roundtrip_batched` (encode + quantise + decode, batch
by batch) and :class:`PipelinedCompressor` (device transforms overlapped
with the host C++ arithmetic coder, over the fp32 transforms or one of
the serving variants "bf16w+", "bf16w" and "int8"; on an H100 only
"bf16w+" holds the 0.05 dB gate against the fp32 path).

With a ``mesh`` (``parallel.mesh``) each batch is split over its
``data`` axis, and each process runs its own blocks; with
``spatial=True`` each image's height is also cut into bands over the
``model`` axis, whose halos ``parallel.spatial`` exchanges. Every
process gets the whole result back, in image order. Without a mesh all
run on ``device``: ``cuda`` unless the caller passes ``"cpu"``.
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
from autoencoder_based_image_compression_tpu_torch.parallel import spatial as bands_mod
from autoencoder_based_image_compression_tpu_torch.parallel.sharding import (
    gather_pieces,
    split_batch,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device
from autoencoder_based_image_compression_tpu_torch.utils.tracing import phase


def _to_device(params, device):
    """The parameter dict on ``device``; an int8 entry is a dict itself."""
    return {name: (_to_device(value, device) if isinstance(value, dict)
                   else value.to(device)) for (name, value) in params.items()}


def _as_f32(array, device):
    return torch.tensor(numpy.asarray(array, numpy.float32), device=device)


class _Placed:
    """Replicated operands (a parameter dict, a tensor) on each device
    that asks, copied once a device and a value."""

    def __init__(self):
        self._copies = {}

    def __call__(self, value, device):
        key = (id(value), device)
        if key not in self._copies:
            placed = (_to_device(value, device) if isinstance(value, dict)
                      else torch.as_tensor(numpy.asarray(value, numpy.float32)
                                           if not torch.is_tensor(value) else value).to(device))
            self._copies[key] = (value, placed)  # holds `value`, so its id stays its own
        return self._copies[key][1]


def _quantize(params, images_f32, bin_widths, learn_bin_widths):
    """Encode + quantise (uncentred) on one device. In the fixed-bin-width
    variant GDN_3 and the quantiser are one fused kernel launch."""
    if learn_bin_widths:
        return quantize_per_map(conv_eae.encode(params, images_f32, True), bin_widths)
    return gdn_quantize_nhwc(conv_eae.analysis(params, images_f32), params["gamma_3"],
                             params["beta_3"], bin_widths)


def make_codec_fns(learn_bin_widths, mesh=None, spatial=False, device="cuda"):
    """The fp32 codec as two device functions and an upload.

    Returns ``(encode_fn, decode_fn, device_put_batch)``:
    ``encode_fn(params, images_f32) -> latents``,
    ``decode_fn(params, latents, bin_widths) -> reconstruction`` with the
    quantiser inside it, and ``device_put_batch(batch)``.

    Without a mesh, ``device_put_batch`` puts a numpy array or a tensor
    on ``device``, and ``params`` and ``bin_widths`` are tensors there.
    With a mesh, it returns this process's
    :class:`parallel.sharding.ShardedBatch` (split over ``data``, and
    over ``model`` by height when ``spatial``); the two functions take
    and return such batches (``.gather()`` assembles one whole) and
    place ``params`` and ``bin_widths`` on each shard's device, once.
    """
    if mesh is None:
        device = resolve_device(device)

        def device_put_batch(batch):
            return torch.as_tensor(batch).to(device)

        def encode_fn(params, images_f32):
            return conv_eae.encode(params, images_f32, learn_bin_widths)

        def decode_fn(params, latents, bin_widths):
            return conv_eae.decode(params, quantize_per_map(latents, bin_widths),
                                   learn_bin_widths)

        return (encode_fn, decode_fn, device_put_batch)

    placed = _Placed()

    def device_put_batch(batch):
        return split_batch(batch, mesh, spatial)

    def encode_fn(params, batch):
        return batch.map_blocks(
            lambda x: conv_eae.encode(placed(params, x.device), x, learn_bin_widths),
            lambda bands, d: bands_mod.encode_bands(
                placed(params, next(iter(bands.values())).device), bands, learn_bin_widths,
                bands_mod.HaloExchange(mesh, d)))

    def decode_fn(params, latents, bin_widths):
        def whole(y):
            return conv_eae.decode(placed(params, y.device), quantize_per_map(
                y, placed(bin_widths, y.device)), learn_bin_widths)

        def bands(latent_bands, d):
            device = next(iter(latent_bands.values())).device
            quantized = {m: quantize_per_map(y, placed(bin_widths, device))
                         for (m, y) in latent_bands.items()}
            return bands_mod.decode_bands(placed(params, device), quantized,
                                          learn_bin_widths, bands_mod.HaloExchange(mesh, d))

        return latents.map_blocks(whole, bands)

    return (encode_fn, decode_fn, device_put_batch)


def roundtrip_batched(params, images_uint8, bin_widths, learn_bin_widths,
                      batch_size, mesh=None, spatial=False, device="cuda"):
    """Encode + quantise + decode a uint8 ``(N, H, W, 1)`` image stack.

    ``params`` is the dict of ``train.checkpoint.params_from_jax``.
    Batches are queued on the device back to back and fetched at the
    end. In the fixed-bin-width variant, GDN_3 and the quantiser after
    it are one launch of the fused GDN+quantise kernel (uncentred,
    ``bw * round(gdn(x) / bw)``), one a shard over a mesh. With a
    ``mesh``, each batch splits over its ``data`` axis (and, when
    ``spatial``, each image's height over ``model``; see
    :func:`make_codec_fns`), and every process returns the whole stack.
    Returns float32 reconstructions (the caller applies ``cast_bt601``).
    """
    if mesh is None:
        device = resolve_device(device)
        params = _to_device(params, device)
        bin_widths = _as_f32(bin_widths, device)
    placed = _Placed()
    outputs = []
    for start in range(0, images_uint8.shape[0], batch_size):
        batch = images_uint8[start:start + batch_size]
        if mesh is None:
            images = torch.from_numpy(numpy.ascontiguousarray(batch)).to(device).to(
                torch.float32)
            quantized = _quantize(params, images, bin_widths, learn_bin_widths)
            outputs.append(conv_eae.decode(params, quantized, learn_bin_widths))
            continue

        def whole(x):
            (p, bw) = (placed(params, x.device), placed(bin_widths, x.device))
            return conv_eae.decode(p, _quantize(p, x.to(torch.float32), bw, learn_bin_widths),
                                   learn_bin_widths)

        def bands(image_bands, d):
            device = next(iter(image_bands.values())).device
            (p, bw) = (placed(params, device), placed(bin_widths, device))
            exchange = bands_mod.HaloExchange(mesh, d)
            quantized = bands_mod.quantize_bands(
                p, {m: x.to(torch.float32) for (m, x) in image_bands.items()}, bw,
                learn_bin_widths, exchange)
            return bands_mod.decode_bands(p, quantized, learn_bin_widths, exchange)

        outputs.append(split_batch(batch, mesh, spatial).map_blocks(whole, bands))
    if mesh is not None:
        outputs = [out.gather() for out in outputs]
    return numpy.concatenate([out.cpu().numpy() for out in outputs], axis=0)


class Fetch:
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
    thread pool compresses the symbols of the oldest one. Over a mesh,
    each batch splits over its ``data`` axis: each process encodes,
    codes and decodes its own blocks, each on its shard's device, and
    the bit counts and reconstructions are gathered in image order.
    """

    def __init__(self, params, bin_widths, learn_bin_widths, binary_probabilities,
                 map_mean, idx_map_exception=-1, mesh=None, batch_size=4, fast_path=None,
                 reconstruct=True, verify=True, max_in_flight=4, device="cuda"):
        """``params`` is the dict of ``train.checkpoint.params_from_jax``.

        ``fast_path``: None runs the fp32 transforms; "bf16w+", "bf16w"
        or "int8" the serving engine's (learned-bin-width architecture
        only). "bf16w+" is the serving default and the one variant that
        holds the 0.05 dB gate on an H100: fp32 analysis transform, bf16
        synthesis transform whose tconv_4 takes the latents unrounded
        and gives an fp32 output (``engine.BF16WPLUS_*``). "bf16w" is
        the reference's all-bf16 mix as it is (kernels rounded to bf16,
        no fp32 stage) and "int8" the int8 weight store
        (``engine.quantize_params_int8``, all-bf16 activations); both
        decode ``sym * bw + mean`` with unfolded kernels.

        ``reconstruct=False`` is the compress-only mode: no decode, and
        ``__call__`` returns ``(None, nb_bits_per_image)``.
        ``verify=True`` round-trips and asserts every coded map;
        ``verify=False`` encodes only (same bit counts).
        ``max_in_flight`` bounds the dispatched-but-uncoded batches.
        ``mesh`` (``parallel.mesh``): data-parallel over its ``data``
        axis; every batch must split evenly over it, and ``device`` is
        then the mesh's.
        """
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device_of("data", mesh.local_indices("data")[0])
        self.device = resolve_device(device)
        self._fp32_tail = 0
        self._fp32_head = False
        self._exact_latents = False
        self._fp32_enc_tail = 0
        if fast_path is not None:
            if fast_path not in ("bf16w+", "bf16w", "int8"):
                raise ValueError(
                    f"unknown fast_path {fast_path!r} (use 'bf16w+', 'bf16w', "
                    "'int8' or None).")
            if not learn_bin_widths:
                raise ValueError(
                    "fast_path requires the learned-bin-width architecture.")
            if fast_path == "int8":
                params = engine.quantize_params_int8(params)
            else:
                if fast_path == "bf16w+":
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
        self._placed = _Placed()
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
        # Calls so far: a request's number in its spans.
        self.requests = 0

    def encode_symbols(self, batch_uint8):
        """uint8 ``(B, H, W, 1)`` device batch -> ``(sym16, sym8, max_abs)``.

        The uint8 -> fp32 cast, the centring by the map means and the
        quantisation ``round((y - mean) / bw)`` (fp32, true division)
        run on the device. Both narrow images are clamped before the
        cast, so the casts are defined; each is used only when the
        magnitude check on ``max_abs`` says it is exact.
        """
        batch = batch_uint8.to(torch.float32)
        (params, bin_widths, map_mean) = self._operands(batch.device)
        if self.fast_path is not None:
            y = engine.fast_encode(params, batch, learn_bin_widths=True,
                                   fp32_enc_tail=self._fp32_enc_tail)
        else:
            y = conv_eae.encode(params, batch, self.learn_bin_widths)
        sym = torch.round((y - map_mean) / bin_widths)
        sym16 = sym.clamp(-32768.0, 32767.0).to(torch.int16)
        sym8 = sym.clamp(-128.0, 127.0).to(torch.int8)
        return (sym16, sym8, sym.abs().amax())

    def decode_symbols(self, symbols16):
        """int16 symbols -> BT.601 uint8 reconstructions, on the device."""
        (params, bin_widths, map_mean) = self._operands(symbols16.device)
        quantized = symbols16.to(torch.float32) * bin_widths + map_mean
        if self.fast_path is not None:
            reconstruction = engine.fast_decode(params, quantized,
                                                fp32_tail=self._fp32_tail,
                                                fp32_head=self._fp32_head,
                                                exact_latents=self._exact_latents)
        else:
            reconstruction = conv_eae.decode(params, quantized, self.learn_bin_widths)
        return cast_bt601(reconstruction)

    def _operands(self, device):
        """``(params, bin_widths, map_mean)`` on ``device``."""
        if device == self.device:
            return (self.params, self.bin_widths, self.map_mean)
        return tuple(self._placed(value, device)
                     for value in (self.params, self.bin_widths, self.map_mean))

    def _units(self, nb):
        """``(first, stop, device)`` of the blocks this process runs:
        each batch whole, or over a mesh its data blocks held here."""
        if self.mesh is None:
            return [(start, min(start + self.batch_size, nb), self.device)
                    for start in range(0, nb, self.batch_size)]
        n_data = self.mesh.size("data")
        units = []
        for start in range(0, nb, self.batch_size):
            size = min(self.batch_size, nb - start)
            if size % n_data:
                raise ValueError(f"a batch of {size} images does not split evenly over the "
                                 f"{n_data} data shards of the mesh.")
            per = size // n_data
            units += [(start + d * per, start + (d + 1) * per, self.mesh.device_of("data", d))
                      for d in self.mesh.local_indices("data")]
        return units

    def _dispatch(self, images_uint8, unit):
        """Queues one block's encode, the narrow symbol fetch, and the
        optional decode with its fetch."""
        (start, stop, device) = unit
        batch = torch.from_numpy(numpy.ascontiguousarray(images_uint8[start:stop])).to(device)
        (symbols16, symbols8, max_abs) = self.encode_symbols(batch)
        symbols_fetch = Fetch(symbols8, max_abs)
        reconstruction_fetch = None
        if self.reconstruct:
            reconstruction_fetch = Fetch(self.decode_symbols(symbols16))
        return (start, symbols16, symbols_fetch, reconstruction_fetch)

    def __call__(self, images_uint8):
        """Returns ``(reconstructions_uint8, nb_bits_per_image)``.

        A sliding window of ``max_in_flight`` dispatched batches runs
        ahead of the coder. The symbols come back as int8 when the
        batch's max magnitude fits, else as int16; a magnitude above the
        int16 range (or NaN) raises before anything is coded.

        Host spans (``utils/tracing.py``) go around the brackets that fill
        ``last_timing``: ``pipeline.request`` the call's wall,
        ``pipeline.fetch_wait`` each wait for a copy and ``pipeline.coder``
        each unit's coding, and ``pipeline.dispatch`` each unit's dispatch;
        their ``args`` give the request's number (this compressor's calls,
        from 1) and the unit's index.
        """
        self.requests += 1
        request = {"request": self.requests}
        units = self._units(images_uint8.shape[0])
        bits_per_start = {}
        recs_per_start = {}
        inflight = collections.deque()
        self.peak_in_flight = 0
        timing = {"wall": 0.0, "coder": 0.0, "fetch_wait": 0.0}
        with phase("pipeline.request", request):
            t_call = time.perf_counter()
            next_idx = 0
            while next_idx < len(units) or inflight:
                while (next_idx < len(units)
                       and len(inflight) < self.max_in_flight):
                    with phase("pipeline.dispatch", dict(request, unit=next_idx)):
                        inflight.append((next_idx,
                                         self._dispatch(images_uint8, units[next_idx])))
                    next_idx += 1
                    self.peak_in_flight = max(self.peak_in_flight, len(inflight))
                (unit, (start, symbols16, symbols_fetch, reconstruction_fetch)) = (
                    inflight.popleft())
                args = dict(request, unit=unit)
                with phase("pipeline.fetch_wait", args):
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
                with phase("pipeline.coder", args):
                    t0 = time.perf_counter()
                    bits_per_start[start] = compress_lossless_images(
                        symbols_host, self.binary_probabilities,
                        self.idx_map_exception, verify=self.verify)
                    timing["coder"] += time.perf_counter() - t0
                if reconstruction_fetch is not None:
                    with phase("pipeline.fetch_wait", args):
                        t0 = time.perf_counter()
                        (recs_per_start[start],) = reconstruction_fetch.wait()
                        recs_per_start[start] = recs_per_start[start].numpy()
                        timing["fetch_wait"] += time.perf_counter() - t0
            if self.mesh is not None:
                bits_per_start = gather_pieces(bits_per_start, self.mesh)
                recs_per_start = gather_pieces(recs_per_start, self.mesh)
            timing["wall"] = time.perf_counter() - t_call
        self.last_timing = timing
        starts = sorted(bits_per_start)
        bits = numpy.concatenate([bits_per_start[s] for s in starts])
        if not self.reconstruct:
            return (None, bits)
        recs = numpy.concatenate([recs_per_start[s] for s in starts], axis=0)
        return (recs, bits)
