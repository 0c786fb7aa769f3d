#!/usr/bin/env bash
# InternVL2-2B V2PE 32k SFT recipe on H100s: the port's counterpart of
# scripts/train_2b_v2pe_32k.sh (the reference's
# shell/internlm2_2b/internvl_chat_v2_internlm2_2b_dynamic_res_v2pe_32k.sh),
# one process a card under torchrun (parallel/bootstrap.py reads RANK,
# WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).
#   --deepspeed zero_stage3  -> --mesh_fsdp WORLD: FSDP2 over every card
#   GPUS=32, global batch 1024 packed rows -> WORLD cards x 1 row x ACCUM
# The mesh: every card on fsdp. 8 H100s (one host): --mesh_fsdp 8 and
# --grad_accum_steps 128; 4 hosts of 8: --mesh_fsdp 32, ACCUM 32.
set -euo pipefail

MODEL_PATH=${MODEL_PATH:-pretrained/InternVL2-2B}
META_PATH=${META_PATH:-shell/data/annotation_train_32k.json}
OUTPUT_DIR=${OUTPUT_DIR:-work_dirs/v2pe_32k}
GPUS=${GPUS:-8}                 # cards a host
NNODES=${NNODES:-1}
WORLD=$((GPUS * NNODES))
ACCUM=${ACCUM:-$((1024 / WORLD))}
mkdir -p "$OUTPUT_DIR"

torchrun --nnodes "$NNODES" --nproc_per_node "$GPUS" \
  --node_rank "${NODE_RANK:-0}" --master_addr "${MASTER_ADDR:-127.0.0.1}" \
  --master_port "${MASTER_PORT:-29500}" \
  -m v2pe_tpu_torch.train.cli \
  --model_name_or_path "$MODEL_PATH" \
  --model_preset internvl2_2b \
  --tokenizer "$MODEL_PATH" \
  --dtype bfloat16 \
  --meta_path "$META_PATH" \
  --output_dir "$OUTPUT_DIR" \
  --force_image_size 448 \
  --drop_path_rate 0.1 \
  --max_packed_tokens 34000 \
  --max_tiles 135 \
  --rows_per_batch 1 \
  --rope_pos_id_version v2pe_rnd \
  --loss_reduction square \
  --mesh_data 1 \
  --mesh_fsdp "$WORLD" \
  --grad_accum_steps "$ACCUM" \
  --learning_rate 5e-6 \
  --weight_decay 0.05 \
  --warmup_steps 600 \
  --max_steps 20000 \
  --save_steps 2500 \
  --save_total_limit 5 \
  --report_to jsonl tensorboard \
  "$@" 2>&1 | tee -a "$OUTPUT_DIR/training_log.txt"
