#!/bin/bash
# Finalises a training campaign on the card: statistics, params exports
# and the Kodak RD study, the BSDS study, the per-gamma stability
# protocol, then the serving bench on the refreshed weights. Run it
# after the campaign's training parts have stopped.
#
#   bash autoencoder_based_image_compression_tpu_torch/scripts/finalize_study.sh \
#       <last_model_idx> [hm_encoder]
#
# <last_model_idx> = highest model_N index complete across ALL
# experiment dirs (part p writes model_{p+1}). [hm_encoder] is the HM
# TAppEncoderStatic binary (default build/HM-16.15/bin/TAppEncoderStatic);
# without it the studies run without the HEVC anchor. Add
# DEVICE=cpu to the environment to run on the CPU.

set -euo pipefail
cd "$(dirname "$0")/../.."

LAST=${1:?usage: finalize_study.sh <last_model_idx> [hm_encoder]}
HM=${2:-build/HM-16.15/bin/TAppEncoderStatic}
DEVICE=${DEVICE:-cuda}
PKG=autoencoder_based_image_compression_tpu_torch
QPS="22 27 32 37 42 47 51"

# 1. Stats + exports + Kodak study with true coded rates (rd_campaign
#    skips finished training parts).
python -m "$PKG.scripts.rd_campaign" --nb_parts "$LAST" \
    --out results/eae/kodak_rd --hevc_encoder "$HM" --hevc_qps $QPS --device "$DEVICE"

# 2. BSDS study (the reference's second test set).
python -m "$PKG.cli.reconstruct_kodak" \
    --use_bsds --path_to_bsds data/campaign/bsds.npy --code_lossless \
    --idx_training "$LAST" --results_root results/eae \
    --cache_dir results/eae/bsds_rd --hevc_encoder "$HM" --hevc_qps $QPS --device "$DEVICE"

# 3. Per-gamma family stability protocol (K-checkpoint averaging).
python -m "$PKG.scripts.stability_study" --k 3 --hevc_encoder "$HM" \
    --hevc_qps $QPS --device "$DEVICE"

# 4. The serving bench on the refreshed weights.
mkdir -p build
python bench_torch.py --device "$DEVICE" | tee build/bench_final.json
