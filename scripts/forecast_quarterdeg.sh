#!/usr/bin/env bash
# One-command 0.25-degree 30-step (7.5-day) GenCast forecast on one GPU,
# with the memory-safe recipe:
#   * bf16 compute (f32 master weights)  -> --bf16 (preset default)
#   * NaNCleaner on sea_surface_temperature (NaNs reintroduced over land,
#     reference semantics)               -> --clean_sst_nans
#   * chunked rollout, one step per compiled chunk, predictions copied to
#     host after each chunk              -> --chunk_size 1
#   * device compute and host copies serialized
#                                        -> --no_overlap_offload
#
# Usage: scripts/forecast_quarterdeg.sh DATA_DIR CKPT_DIR [OUT_DIR] [STEPS]
set -euo pipefail

DATA_DIR=${1:?usage: forecast_quarterdeg.sh DATA_DIR CKPT_DIR [OUT_DIR] [STEPS]}
CKPT_DIR=${2:?usage: forecast_quarterdeg.sh DATA_DIR CKPT_DIR [OUT_DIR] [STEPS]}
OUT_DIR=${3:-/tmp/gencast_qdeg_forecast}
STEPS=${4:-30}

cd "$(dirname "$0")/.."
exec python -m gencast_tpu.training.evaluate \
  --preset 0.25deg \
  --data "$DATA_DIR" \
  --ckpt_dir "$CKPT_DIR" \
  --out_dir "$OUT_DIR" \
  --max_rollout_steps "$STEPS" \
  --chunk_size 1 \
  --no_overlap_offload \
  --clean_sst_nans
