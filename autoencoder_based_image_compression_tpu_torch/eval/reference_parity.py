"""End-to-end PSNR parity against the reference TensorFlow graph.

Runs encode -> quantise -> decode through the reference's own
graph-building functions (``kodak_tensorflow/eae/graph/components.py`` and
``tfutils/tfutils.py``, imported unmodified under ``tf.compat.v1``) with
this package's parameters installed as TF variables, and through this
package's model (on the card unless ``device="cpu"``), then reports the
per-image PSNR deltas: the measured number behind the 0.05 dB parity
gate.

The reference modules are read from ``_REF_ROOT`` at run time; nothing
is copied. TensorFlow is imported only inside the functions that run the
reference graph.
"""

import importlib.util
import os
import sys

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu_torch.ops.quantization import (
    cast_bt601,
    quantize_per_map,
)
from autoencoder_based_image_compression_tpu_torch.train.checkpoint import params_to_jax
from autoencoder_based_image_compression_tpu_torch.train.loop import (
    decode_mini_batches,
    encode_mini_batches,
)
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

# Where the reference checkout lives: the reference package's location for it.
_REF_ROOT = "/root/reference/kodak_tensorflow"


def reference_available():
    return os.path.isfile(os.path.join(_REF_ROOT, "eae", "graph", "components.py"))


def _load_reference_modules():
    """Imports the reference's components/constants/tfutils with
    ``tensorflow`` resolving to ``tf.compat.v1``.

    Returns ``(components_module, tf1)``.
    """
    import tensorflow as tf

    tf1 = tf.compat.v1
    names = {
        "tfutils": os.path.join(_REF_ROOT, "tfutils", "__init__.py"),
        "tfutils.tfutils": os.path.join(_REF_ROOT, "tfutils", "tfutils.py"),
        "eae": os.path.join(_REF_ROOT, "eae", "__init__.py"),
        "eae.graph": os.path.join(_REF_ROOT, "eae", "graph", "__init__.py"),
        "eae.graph.constants": os.path.join(_REF_ROOT, "eae", "graph", "constants.py"),
        "eae.graph.components": os.path.join(_REF_ROOT, "eae", "graph", "components.py"),
    }
    original_tf = sys.modules.get("tensorflow")
    inserted = []
    sys.modules["tensorflow"] = tf1
    try:
        for (name, path) in names.items():
            if name in sys.modules:
                continue
            if not os.path.isfile(path):  # namespace packages have no __init__
                import types

                module = types.ModuleType(name)
                module.__path__ = [os.path.dirname(path)]
                sys.modules[name] = module
                inserted.append(name)
                continue
            spec = importlib.util.spec_from_file_location(name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            inserted.append(name)
            spec.loader.exec_module(module)
    except BaseException:
        for name in inserted:
            sys.modules.pop(name, None)
        raise
    finally:
        if original_tf is not None:
            sys.modules["tensorflow"] = original_tf
    return (sys.modules["eae.graph.components"], tf1)


def reference_roundtrip_tf(params_numpy, bin_widths, images_f32, learn_bin_widths):
    """encode -> quantise -> decode through the reference's TF graph functions.

    ``params_numpy`` is in the reference's naming (weights_1..6,
    biases_1..5, gamma/beta per GDN; the names of its variables inside
    the 'encoder'/'decoder' scopes, ``EntropyAutoencoder.py:130-224``)
    and layouts (conv filters HWIO), as
    ``train/checkpoint.py::params_to_jax`` gives them. ``images_f32`` is
    NHWC. Returns ``(latents, reconstruction_f32)`` as numpy arrays.
    """
    (components, tf1) = _load_reference_modules()
    graph = tf1.Graph()
    with graph.as_default():
        with tf1.variable_scope("encoder"):
            for name in ("weights_1", "biases_1", "gamma_1", "beta_1",
                         "weights_2", "biases_2", "gamma_2", "beta_2",
                         "weights_3", "biases_3") + (
                             () if learn_bin_widths else ("gamma_3", "beta_3")):
                tf1.get_variable(name, initializer=params_numpy[name])
        with tf1.variable_scope("decoder"):
            for name in (() if learn_bin_widths else ("gamma_4", "beta_4")) + (
                    "weights_4", "biases_4", "gamma_5", "beta_5",
                    "weights_5", "biases_5", "gamma_6", "beta_6", "weights_6"):
                tf1.get_variable(name, initializer=params_numpy[name])
        visible = tf1.placeholder(tf1.float32, shape=images_f32.shape)
        node_y = components.encoder(visible, learn_bin_widths)
        latent_shape = [images_f32.shape[0], images_f32.shape[1] // 16,
                        images_f32.shape[2] // 16, 128]
        quantized = tf1.placeholder(tf1.float32, shape=latent_shape)
        node_rec = components.decoder(quantized, learn_bin_widths)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            y = sess.run(node_y, feed_dict={visible: images_f32})
            q = bin_widths.reshape(1, 1, 1, -1) * numpy.round(
                y / bin_widths.reshape(1, 1, 1, -1))
            rec = sess.run(node_rec, feed_dict={quantized: q})
    return (y, rec)


def measure_psnr_parity(params, bin_widths, images_uint8, learn_bin_widths, batch_size=4,
                        device="cuda"):
    """Max per-image |PSNR(ours) - PSNR(reference TF)| over a stack.

    ``params`` are this package's parameter tensors (any device; they run
    on ``device``); the reference side gets them in its layouts through
    ``params_to_jax``. ``images_uint8`` is ``(N, H, W)`` or
    ``(N, H, W, 1)``. Returns a dict with the per-image PSNRs of both
    paths, the max absolute delta (the 0.05 dB gate quantity) and the
    smallest PSNR between the two uint8 reconstructions.
    """
    device = resolve_device(device)
    if images_uint8.ndim == 3:
        images_uint8 = images_uint8[..., None]
    params = {name: value.to(device) for (name, value) in params.items()}
    params_numpy = params_to_jax(params)
    bin_widths = numpy.asarray(bin_widths, numpy.float32)

    # Ours (the fp32 parity path).
    y_ours = encode_mini_batches(images_uint8, params, learn_bin_widths, batch_size)
    q_ours = quantize_per_map(torch.from_numpy(y_ours), bin_widths).numpy()
    rec_ours = decode_mini_batches(q_ours, params, learn_bin_widths, batch_size)[..., 0]

    # The reference TF graph, batched the same way.
    rec_ref_chunks = []
    for i in range(0, images_uint8.shape[0], batch_size):
        chunk = images_uint8[i:i + batch_size].astype(numpy.float32)
        (_, rec) = reference_roundtrip_tf(params_numpy, bin_widths, chunk, learn_bin_widths)
        rec_ref_chunks.append(rec)
    rec_ref = cast_bt601(numpy.concatenate(rec_ref_chunks, axis=0)[..., 0])

    psnrs_ours = numpy.array([psnr_2d(images_uint8[i, :, :, 0], rec_ours[i])
                              for i in range(images_uint8.shape[0])])
    psnrs_ref = numpy.array([psnr_2d(images_uint8[i, :, :, 0], rec_ref[i])
                             for i in range(images_uint8.shape[0])])
    cross = numpy.array([
        psnr_2d(rec_ours[i], rec_ref[i]) if not numpy.array_equal(rec_ours[i], rec_ref[i])
        else numpy.inf
        for i in range(images_uint8.shape[0])])
    return {
        "psnrs_ours": psnrs_ours,
        "psnrs_reference": psnrs_ref,
        "max_abs_delta_db": float(numpy.max(numpy.abs(psnrs_ours - psnrs_ref))),
        "cross_psnr_db": float(numpy.min(cross)),
    }
