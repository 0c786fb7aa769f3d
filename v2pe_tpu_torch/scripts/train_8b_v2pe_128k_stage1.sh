#!/usr/bin/env bash
# InternVL2.5-8B V2PE stage-1 long-context recipe on H100s: the port's
# counterpart of scripts/train_8b_v2pe_128k_stage1.sh (the reference's
# shell/internlm2_5_8b/internvl2_5_8b_dynamic_res_v2pe_stage1.sh: 128k
# packed rows, v2pe_rnd, --chunk_num 4 --attn_type ring, zero-3,
# drop_path 0.1, lr 5e-6, cosine, square loss reduction), one process a
# card under torchrun. Ring group = the seq axis (SEQ_SHARDS cards a 128k
# row, zigzag, the scan ring); zero-3 = fsdp over the rest.
# The mesh: 8 H100s are --mesh_seq 4 --mesh_fsdp 2; 4 hosts of 8 are
# --mesh_seq 4 --mesh_fsdp 8. Stage 2 (32k re-pack) is this launcher with
# SEQ_LEN=34000 SEQ_SHARDS=1 SAVE_STEPS=2000.
set -euo pipefail

MODEL_PATH=${MODEL_PATH:-pretrained/InternVL2_5-8B}
META_PATH=${META_PATH:-shell/data/annotation_train_1M.json}
OUTPUT_DIR=${OUTPUT_DIR:-work_dirs/v2pe_8b_128k_stage1}
GPUS=${GPUS:-8}                 # cards a host
NNODES=${NNODES:-1}
WORLD=$((GPUS * NNODES))
SEQ_SHARDS=${SEQ_SHARDS:-4}     # reference chunk_num 4
SEQ_LEN=${SEQ_LEN:-131072}
SAVE_STEPS=${SAVE_STEPS:-2500}
FSDP=$((WORLD / SEQ_SHARDS))
mkdir -p "$OUTPUT_DIR"

torchrun --nnodes "$NNODES" --nproc_per_node "$GPUS" \
  --node_rank "${NODE_RANK:-0}" --master_addr "${MASTER_ADDR:-127.0.0.1}" \
  --master_port "${MASTER_PORT:-29500}" \
  -m v2pe_tpu_torch.train.cli \
  --model_name_or_path "$MODEL_PATH" \
  --model_preset internvl2_5_8b \
  --tokenizer "$MODEL_PATH" \
  --dtype bfloat16 \
  --meta_path "$META_PATH" \
  --output_dir "$OUTPUT_DIR" \
  --force_image_size 448 \
  --drop_path_rate 0.1 \
  --max_packed_tokens "$SEQ_LEN" \
  --max_tiles 500 \
  --rows_per_batch 1 \
  --rope_pos_id_version v2pe_rnd \
  --loss_reduction square \
  --mesh_data 1 \
  --mesh_fsdp "$FSDP" \
  --mesh_seq "$SEQ_SHARDS" \
  --ring_mode scan \
  --learning_rate 5e-6 \
  --weight_decay 0.05 \
  --warmup_steps 600 \
  --max_steps 20000 \
  --save_steps "$SAVE_STEPS" \
  --save_total_limit 5 \
  --report_to jsonl tensorboard \
  "$@" 2>&1 | tee -a "$OUTPUT_DIR/training_log.txt"
