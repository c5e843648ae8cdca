"""Which precision mix holds the worst-image 0.05 dB gate, on this device.

Counterpart of the reference's ``scripts/gate_probe.py``. For each mix
and each bin-width multiplier of 1, 4 and 10: the PSNR of every image
against its original through the mix, less the same through the fp32
transforms; the gate binds the worst image. Two ways through the codec:

- ``through="pipeline"``: what ``PipelinedCompressor`` runs. Symbols
  centred by the map means, ``sym * bw + mean`` into unfolded kernels.
- ``through="scan"``: what ``engine.fast_roundtrip_scan`` and the bench
  run. ``round(y / bw)`` without map means, integer symbols into a
  decoder whose first kernel holds the bin widths.

Run as ``python -m autoencoder_based_image_compression_tpu_torch.eval.gate_probe
[--through scan] [--out build/gate_probe_torch.json] [--device cuda]``
it prints both tables on the trained learned-bin-width model and 24
Kodak-shaped images and writes them as JSON.
"""

import argparse
import json
import os

import numpy
import torch

from autoencoder_based_image_compression_tpu_torch.engine import quantized as engine
from autoencoder_based_image_compression_tpu_torch.models import conv_eae
from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d
from autoencoder_based_image_compression_tpu_torch.ops.quantization import cast_bt601
from autoencoder_based_image_compression_tpu_torch.utils.device import resolve_device

GATE_DB = 0.05
GATE_MULTIPLIERS = (1.0, 4.0, 10.0)
# A mix: (weight store, keywords). Through the pipeline the keywords are
# ``fast_decode``'s plus ``fp32_enc_tail``; a mix whose analysis
# transform is all fp32 (``fp32_enc_tail=3``) takes the fp32 encoder's
# latents, so that such rows differ in the decoder alone.
_FP32_ENC = {"fp32_enc_tail": engine.BF16WPLUS_ENC_TAIL}
GATE_MIXES = {
    "pipeline": {
        "bf16w (the reference's mix as it is)": ("bf16", {}),
        "int8": ("int8", {}),
        "a: fp32 head, rounded latents": ("bf16", dict(_FP32_ENC, fp32_head=True)),
        "c: fp32 head, exact latents (bf16w+)": (
            "bf16", dict(_FP32_ENC, fp32_head=True, exact_latents=True)),
        "d: c + fp32 IGDN_6": (
            "bf16", dict(_FP32_ENC, fp32_head=True, exact_latents=True, fp32_igdn6=True)),
        "tail 0": ("bf16", dict(_FP32_ENC)),
        "tail 1": ("bf16", dict(_FP32_ENC, fp32_tail=1)),
        "tail 2": ("bf16", dict(_FP32_ENC, fp32_tail=2)),
        "tail 3 (all fp32)": ("bf16", dict(_FP32_ENC, fp32_tail=3)),
    },
    # Through the scan the keywords are ``fast_roundtrip_scan``'s;
    # cheapest first.
    "scan": {
        "bf16w (the reference's mix as it is)": ("bf16", {}),
        "int8": ("int8", {}),
        "b: fp32 encoder, tail 0 (the reference's bf16w+)": ("bf16", dict(_FP32_ENC)),
        "b+: fp32 head": ("bf16", dict(_FP32_ENC, fp32_head=True)),
        "e: fp32 tconv_4, folded kernel left fp32": ("bf16", dict(_FP32_ENC, fp32_tconv4=True)),
        "f: fp32 head + fp32 IGDN_6": ("bf16", dict(_FP32_ENC, fp32_head=True,
                                                     fp32_igdn6=True)),
        "g: e + fp32 IGDN_6": ("bf16", dict(_FP32_ENC, fp32_tconv4=True, fp32_igdn6=True)),
        "tail 1 + fp32 head": ("bf16", dict(_FP32_ENC, fp32_tail=1, fp32_head=True)),
        "tail 2 + fp32 head": ("bf16", dict(_FP32_ENC, fp32_tail=2, fp32_head=True)),
        "tail 3 (all fp32)": ("bf16", dict(_FP32_ENC, fp32_tail=3)),
    },
}


def mix_label(through, store, knobs):
    """The label of the row of ``GATE_MIXES[through]`` that holds this mix."""
    knobs = {key: value for (key, value) in knobs.items() if value}
    (label,) = [label for (label, (row_store, row_knobs)) in GATE_MIXES[through].items()
                if row_store == store and row_knobs == knobs]
    return label


def _pipeline_params(params, store, knobs):
    if store == "int8":
        return engine.quantize_params_int8(params)
    return engine.bf16_weight_params(params, fp32_tail=knobs.get("fp32_tail", 0),
                                     fp32_enc_tail=knobs.get("fp32_enc_tail", 0))


def gate_details(params, bin_widths, map_mean, images, through="pipeline", batch_size=4,
                 mixes=None, multipliers=GATE_MULTIPLIERS, device="cuda"):
    """Per mix and multiplier, against the fp32 transforms on the same
    images: ``{"deltas": per-image PSNR delta (dB), "rec_psnr": mean
    PSNR between the two uint8 reconstructions (99 where equal)}``.

    ``params`` is the dict of ``train.checkpoint.params_from_jax``
    (learned-bin-width architecture); ``images`` uint8 ``(N, H, W, 1)``;
    ``mixes`` a subset of ``GATE_MIXES[through]`` (default: all of it).
    """
    if through not in GATE_MIXES:
        raise ValueError(f"unknown way through the codec {through!r} (use 'pipeline' or "
                         "'scan').")
    device = resolve_device(device)
    mixes = GATE_MIXES[through] if mixes is None else mixes
    params = {name: value.to(device) for (name, value) in params.items()}
    mean = torch.tensor(numpy.asarray(map_mean, numpy.float32)).to(device)
    batches = [torch.from_numpy(numpy.ascontiguousarray(images[i:i + batch_size])
                                ).to(device).to(torch.float32)
               for i in range(0, images.shape[0], batch_size)]
    latents = [conv_eae.encode(params, batch, True) for batch in batches]
    originals = images[..., 0]

    def measure(reconstructions, reference):
        recs = numpy.concatenate([cast_bt601(rec).cpu().numpy()[..., 0]
                                  for rec in reconstructions])
        psnrs = numpy.array([psnr_2d(originals[i], recs[i]) for i in range(recs.shape[0])])
        if reference is None:
            return (recs, psnrs)
        (reference_recs, reference_psnrs) = reference
        between = [99.0 if numpy.array_equal(reference_recs[i], recs[i])
                   else psnr_2d(reference_recs[i], recs[i]) for i in range(recs.shape[0])]
        return {"deltas": psnrs - reference_psnrs, "rec_psnr": float(numpy.mean(between))}

    def dequantised(y, bw):
        if through == "scan":
            return torch.round(y / bw) * bw
        return torch.round((y - mean) / bw) * bw + mean

    details = {label: {} for label in mixes}
    for multiplier in multipliers:
        bw = torch.tensor(numpy.asarray(bin_widths, numpy.float32) * multiplier).to(device)
        reference = measure([conv_eae.decode(params, dequantised(y, bw), True)
                             for y in latents], None)
        for (label, (store, knobs)) in mixes.items():
            if through == "scan":
                (qparams, qfolded) = engine.scan_params(params, bw, store, **knobs)
                recs = [engine.fast_roundtrip_scan(qparams, qfolded, batch[None], bw,
                                                   **knobs)[0][0] for batch in batches]
            else:
                qparams = _pipeline_params(params, store, knobs)
                enc_tail = knobs.get("fp32_enc_tail", 0)
                decode_knobs = {key: value for (key, value) in knobs.items()
                                if key != "fp32_enc_tail"}
                own = (latents if enc_tail >= 3 else
                       [engine.fast_encode(qparams, batch, fp32_enc_tail=enc_tail)
                        for batch in batches])
                recs = [engine.fast_decode(qparams, dequantised(y, bw), **decode_knobs)
                        for y in own]
            details[label][multiplier] = measure(recs, reference)
    return details


def gate_table(params, bin_widths, map_mean, images, through="pipeline", batch_size=4,
               mixes=None, device="cuda", show=print):
    """Worst-image PSNR delta against the fp32 transforms for each mix
    at multipliers 1, 4 and 10: ``{label: {multiplier: worst delta}}``,
    each row handed to ``show`` as a line."""
    details = gate_details(params, bin_widths, map_mean, images, through=through,
                           batch_size=batch_size, mixes=mixes, device=device)
    table = {label: {multiplier: float(cell["deltas"].min())
                     for (multiplier, cell) in row.items()}
             for (label, row) in details.items()}
    for (label, row) in table.items():
        show(f"  gate table through the {through}, worst-image delta (dB), {label}: "
             + "; ".join(f"x{m:g} {d:+.4f}" for (m, d) in row.items()))
    return table


def holds_gate(row):
    """True when a row of :func:`gate_table` is inside the gate at every multiplier."""
    return all(delta >= -GATE_DB for delta in row.values())


def main(args=None):
    from autoencoder_based_image_compression_tpu_torch.eval import workload

    parser = argparse.ArgumentParser(description="Gate probe of the serving precision mixes.")
    parser.add_argument("--through", choices=["pipeline", "scan", "both"], default="both")
    parser.add_argument("--out", default=os.path.join("build", "gate_probe_torch.json"))
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(args)
    (params, bin_widths, map_mean, _, _) = workload.load_model(workload.LEARNED)
    images = workload.kodak_images()
    results = {}
    for through in (("pipeline", "scan") if args.through == "both" else (args.through,)):
        table = gate_table(params, bin_widths, map_mean, images, through=through,
                           batch_size=args.batch_size, device=args.device)
        results[through] = {
            label: {"worst_delta_db": {f"x{m:g}": round(d, 4) for (m, d) in row.items()},
                    "gate_pass": holds_gate(row)} for (label, row) in table.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as file:
        json.dump(results, file, indent=2)
    print("written", args.out)


if __name__ == "__main__":
    main()
