#!/usr/bin/env bash
# Real-checkpoint runbook of the port on one H100: the port's counterpart
# of scripts/run_real_checkpoint.sh. ITS SHAPE ONLY: it needs a real
# InternVL snapshot, which cannot be fetched where the port is built and
# checked, so no run of it has been made; every step below runs on random
# weights in chip_smoke.py (phase_checkpoint_eval exports and reloads a
# random 2.2B checkpoint and evaluates it).
#
#   1. (once, on a machine with network access)
#        huggingface-cli download OpenGVLab/InternVL2-2B \
#            --local-dir /data/InternVL2-2B
#   2. v2pe_tpu_torch/scripts/run_real_checkpoint.sh /data/InternVL2-2B \
#          photo.jpg
#   3. (optional) one MM-NIAH shard:
#        MMNIAH_DATA=/data/mm-niah/retrieval-text-test.jsonl \
#        MMNIAH_ROOT=/data/mm-niah \
#        v2pe_tpu_torch/scripts/run_real_checkpoint.sh /data/InternVL2-2B
#
# The architecture comes from the snapshot's config.json
# (core/config.py:load_vlm_config), the weights through
# models/params.py:load_safetensors_checkpoint.
set -euo pipefail

SNAPSHOT=${1:?usage: run_real_checkpoint.sh <hf_snapshot_dir> [image] }
IMAGE=${2:-}
TOKENIZER=${TOKENIZER:-$SNAPSHOT}   # InternVL snapshots embed the tokenizer
OUT=${OUT:-work_dirs/real_ckpt_run}
mkdir -p "$OUT"

echo "== [1/3] converter: HF snapshot -> VLMConfig + weights on the card =="
python - "$SNAPSHOT" <<'PY'
import sys

import torch

from v2pe_tpu_torch.core.config import load_vlm_config
from v2pe_tpu_torch.models.params import load_safetensors_checkpoint

snap = sys.argv[1]
cfg = load_vlm_config(f"{snap}/config.json")
print(f"config: llm={cfg.llm.arch} L={cfg.llm.num_hidden_layers} "
      f"H={cfg.llm.hidden_size} rope={cfg.rope_pos_id_version}"
      f"/{cfg.rope_pos_id_stride} template={cfg.template}")
model = load_safetensors_checkpoint(snap, cfg, torch.bfloat16,
                                    device="cuda")
print(f"loaded {sum(p.numel() for p in model.parameters()) / 1e9:.2f}B "
      f"parameters")
PY

if [ -n "$IMAGE" ]; then
  echo "== [2/3] single-image chat =="
  python -m v2pe_tpu_torch.tools.inference_test \
    --checkpoint "$SNAPSHOT" --tokenizer "$TOKENIZER" --image "$IMAGE"
else
  echo "== [2/3] skipped (no image argument) =="
fi

if [ -n "${MMNIAH_DATA:-}" ]; then
  echo "== [3/3] MM-NIAH shard (rank 0/8 of ${MMNIAH_DATA}) =="
  python -m v2pe_tpu_torch.evalkit.cli --benchmark mm_niah \
    --checkpoint "$SNAPSHOT" --tokenizer "$TOKENIZER" \
    --data "$MMNIAH_DATA" \
    --data-root "${MMNIAH_ROOT:-$(dirname "$MMNIAH_DATA")}" \
    --outputs-dir "$OUT/mm_niah" --task "${MMNIAH_TASK:-retrieval-text-test}" \
    --rank 0 --world 8
  echo "outputs and scores under $OUT/mm_niah"
else
  echo "== [3/3] skipped (set MMNIAH_DATA=<questions.jsonl> to run) =="
fi
echo "runbook complete"
