"""HEVC anchor via the vendored HM reference encoder binary.

Reference ``kodak_tensorflow/hevc/hevc.py``: luminance -> raw YUV 4:0:0
file (``write_400`` ``:370``), shell out to HM ``TAppEncoderStatic``
with an all-intra config + QP (``:90-115``), read the reconstructed YUV
(``read_400`` ``:313``), rate = 8 * bitstream_bytes / (H*W)
(``:211-212``). HM itself is a third-party benchmark binary - not
re-implemented (SURVEY.md section 2.3 item 6); its path is injected.
"""

import os
import subprocess
import tempfile

import numpy

from autoencoder_based_image_compression_tpu_torch.codecs.common import CodecUnavailableError
from autoencoder_based_image_compression_tpu_torch.ops.metrics import psnr_2d

# The full all-intra main-RExt operating point of the reference's
# hevc/configuration/intra.cfg (itself HM's encoder_intra_main_rext
# example): every behavior-affecting setting is reproduced - RDOQ, SAO,
# deblocking, AMP, CU/TU geometry, search, transform skip - because the
# anchor numbers (and hence the Bjontegaard deltas) depend on them.
# Bit depth / chroma format / frame count / QP are passed on the
# command line like the reference does (hevc/hevc.py:89-107).
INTRA_CFG = """\
FrameRate: 25
Profile: main-RExt
Tier: main
Level: 5.2
MaxCUWidth: 64
MaxCUHeight: 64
MaxPartitionDepth: 4
QuadtreeTULog2MaxSize: 5
QuadtreeTULog2MinSize: 2
QuadtreeTUMaxDepthInter: 3
QuadtreeTUMaxDepthIntra: 3
IntraPeriod: 1
DecodingRefreshType: 1
GOPSize: 1
ReWriteParamSetsFlag: 1
FastSearch: 1
SearchRange: 64
HadamardME: 1
FEN: 1
FDM: 1
MaxDeltaQP: 0
MaxCuDQPDepth: 0
DeltaQpRD: 0
RDOQ: 1
RDOQTS: 1
LoopFilterOffsetInPPS: 1
LoopFilterDisable: 0
LoopFilterBetaOffset_div2: 0
LoopFilterTcOffset_div2: 0
DeblockingFilterMetric: 0
SAO: 1
AMP: 1
TransformSkip: 1
TransformSkipFast: 1
SAOLcuBoundary: 0
SliceMode: 0
SliceArgument: 1500
LFCrossSliceBoundaryFlag: 1
PCMEnabledFlag: 0
PCMLog2MaxSize: 5
PCMLog2MinSize: 3
PCMInputBitDepthFlag: 1
PCMFilterDisableFlag: 0
TileUniformSpacing: 0
NumTileColumnsMinus1: 0
TileColumnWidthArray: 2 3
NumTileRowsMinus1: 0
TileRowHeightArray: 2
LFCrossTileBoundaryFlag: 1
WaveFrontSynchro: 0
ScalingList: 0
TransquantBypassEnable: 0
CUTransquantBypassFlagForce: 0
SEIDecodedPictureHash: 3
"""


def write_400(path, luminance_uint8):
    """Writes a luminance image as a raw YUV 4:0:0 frame."""
    luminance_uint8.astype(numpy.uint8).tofile(path)


def read_400(path, height, width):
    """Reads a raw YUV 4:0:0 frame back into a luminance image."""
    data = numpy.fromfile(path, dtype=numpy.uint8)
    return data[:height * width].reshape(height, width)


def compress_hevc(luminance_uint8, qp, path_to_encoder, work_dir):
    """One image through HM at one QP; returns (rate_bpp, reconstruction)."""
    if not (path_to_encoder and os.path.isfile(path_to_encoder)):
        raise CodecUnavailableError(
            f"HM encoder binary not found at {path_to_encoder!r}; build "
            "HM-16.15 TAppEncoderStatic and pass its path.")
    (height, width) = luminance_uint8.shape
    path_cfg = os.path.join(work_dir, "intra.cfg")
    path_in = os.path.join(work_dir, "in.yuv")
    path_bin = os.path.join(work_dir, "out.bin")
    path_rec = os.path.join(work_dir, "rec.yuv")
    with open(path_cfg, "w") as file:
        file.write(INTRA_CFG)
    write_400(path_in, luminance_uint8)
    subprocess.check_call(
        [path_to_encoder, "-c", path_cfg,
         "-i", path_in, "-b", path_bin, "-o", path_rec,
         "-wdt", str(width), "-hgt", str(height),
         "--InputBitDepth=8", "--InputChromaFormat=400",
         "--FramesToBeEncoded=1", f"--QP={qp}"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    rate = 8.0 * os.path.getsize(path_bin) / (height * width)
    reconstruction = read_400(path_rec, height, width)
    return (rate, reconstruction)


def evaluate_hevc(luminances_uint8, qps, path_to_encoder):
    """QP sweep over an image stack; returns (rates, psnrs) per image/QP
    (reference ``hevc/hevc.py:223-311``)."""
    nb_images = luminances_uint8.shape[0]
    rates = numpy.zeros((nb_images, len(qps)))
    psnrs = numpy.zeros((nb_images, len(qps)))
    with tempfile.TemporaryDirectory() as work_dir:
        for i in range(nb_images):
            luminance = luminances_uint8[i]
            if luminance.ndim == 3:
                luminance = luminance[:, :, 0]
            for (j, qp) in enumerate(qps):
                (rates[i, j], reconstruction) = compress_hevc(
                    luminance, qp, path_to_encoder, work_dir)
                psnrs[i, j] = psnr_2d(luminance, reconstruction)
    return (rates, psnrs)
