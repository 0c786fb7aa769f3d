#!/usr/bin/env bash
# InternVL2-2B V2PE 256k ring-attention recipe on H100s: the port's
# counterpart of scripts/train_2b_v2pe_256k_ring.sh (the reference's
# shell/internlm2_2b/internvl_chat_v2_internlm2_2b_dynamic_res_v2pe_256k.sh,
# --attn_type ring --chunk_num 8), one process a card under torchrun.
# The ring group is the mesh's seq axis: each group of SEQ_SHARDS cards
# holds one 256k row in the zigzag layout and passes K/V chunks by P2P
# (the scan ring; --ring_mode fused stays on one card, ROADMAP Queue 1
# item 6.5); the cards left over stack on fsdp. int8 Adam's moments are
# sharded with the parameters over fsdp (train/optimizer.py).
# The mesh: a 256k ring row on 8 H100s is --mesh_seq 8 --mesh_fsdp 1;
# 4 hosts of 8 are --mesh_seq 8 --mesh_fsdp 4.
set -euo pipefail

MODEL_PATH=${MODEL_PATH:-pretrained/InternVL2-2B}
META_PATH=${META_PATH:-shell/data/annotation_train_256k.json}
OUTPUT_DIR=${OUTPUT_DIR:-work_dirs/v2pe_256k_ring}
GPUS=${GPUS:-8}                 # cards a host
NNODES=${NNODES:-1}
WORLD=$((GPUS * NNODES))
SEQ_SHARDS=${SEQ_SHARDS:-8}     # reference chunk_num
FSDP=$((WORLD / SEQ_SHARDS))
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
  --max_packed_tokens 262144 \
  --max_tiles 1024 \
  --rows_per_batch 1 \
  --rope_pos_id_version v2pe_rnd \
  --loss_reduction square \
  --mesh_data 1 \
  --mesh_fsdp "$FSDP" \
  --mesh_seq "$SEQ_SHARDS" \
  --ring_mode scan \
  --use_8bit_optimizer \
  --learning_rate 5e-6 \
  --weight_decay 0.05 \
  --warmup_steps 600 \
  --max_steps 20000 \
  --save_steps 2500 \
  --save_total_limit 5 \
  --report_to jsonl tensorboard \
  "$@" 2>&1 | tee -a "$OUTPUT_DIR/training_log.txt"
