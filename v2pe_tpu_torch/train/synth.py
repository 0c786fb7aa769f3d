"""Synthetic packed batches (the port's copy of
``v2pe_tpu/train/synth.py``, numpy only): the batch of the bench recipe and
the unit tests. Produces exactly the train-step batch contract
(train/train_step.py) including V2PE position ids, pre-shifted targets,
host-computed ViT gather indices, and optional zigzag sequence layout for
ring sharding."""

from __future__ import annotations

import numpy as np

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.positional import build_v2pe_pos_ids

IMG_START_ID = 92544
IMG_END_ID = 92545
IMG_CONTEXT_ID = 92546


def zigzag_permutation(S: int, world: int) -> np.ndarray:
    """perm such that x[perm] lays out contiguous shards in zigzag order."""
    idx = np.arange(S).reshape(2 * world, -1)
    out = []
    for r in range(world):
        out.append(idx[r])
        out.append(idx[2 * world - 1 - r])
    return np.concatenate(out)


def make_synthetic_batch(
    cfg: VLMConfig,
    batch: int,
    seq_len: int,
    tiles_per_row: int = 1,
    stride: int = 64,
    seq_shards: int = 1,
    seed: int = 0,
    dtype=np.float32,
):
    rng = np.random.RandomState(seed)
    nit = cfg.num_image_token
    img_span = tiles_per_row * nit + 2  # <img> ctx... </img>

    input_ids = np.zeros((batch, seq_len), np.int32)
    rope_pos = np.zeros((batch, seq_len), np.float32)
    seg = np.zeros((batch, seq_len), np.int32)
    labels = np.full((batch, seq_len), -100, np.int64)
    gather_idx = np.full((batch, seq_len), -1, np.int32)

    tile_counter = 0
    for b in range(batch):
        text_pre = rng.randint(5, 1000, size=16)
        remaining = seq_len - 16 - img_span
        assert remaining > 0, "seq_len too small for the image span"
        text_post = rng.randint(5, 1000, size=remaining)
        ids = np.concatenate([
            text_pre, [IMG_START_ID],
            [IMG_CONTEXT_ID] * (tiles_per_row * nit),
            [IMG_END_ID], text_post,
        ]).astype(np.int64)
        mask = np.ones_like(ids)
        pos = build_v2pe_pos_ids(
            ids, mask, [tiles_per_row],
            img_start_id=IMG_START_ID, img_end_id=IMG_END_ID,
            num_image_token=nit,
            version=cfg.rope_pos_id_version
            if cfg.rope_pos_id_version != "v2pe_rnd" else "v2pe_fix",
            stride=stride,
        )
        input_ids[b] = ids
        rope_pos[b] = pos
        seg[b] = 1
        labels[b] = ids  # next-token over everything (synthetic)
        ctx_slots = np.where(ids == IMG_CONTEXT_ID)[0]
        gather_idx[b, ctx_slots] = (
            np.arange(len(ctx_slots)) + tile_counter * nit)
        tile_counter += tiles_per_row

    # pre-shift: targets[t] = labels[t+1]; last position ignored
    targets = np.full_like(labels, -100)
    targets[:, :-1] = labels[:, 1:]
    targets[input_ids == IMG_CONTEXT_ID] = -100  # don't predict image tokens
    loss_weight = (targets != -100).astype(np.float32)
    token_positions = np.broadcast_to(
        np.arange(seq_len, dtype=np.int32), (batch, seq_len)).copy()

    if seq_shards > 1:
        perm = zigzag_permutation(seq_len, seq_shards)
        for arr in (input_ids, rope_pos, seg, targets, loss_weight,
                    gather_idx, token_positions):
            arr[:] = arr[:, perm]

    n_tiles = batch * tiles_per_row
    pixel_values = rng.randn(
        n_tiles, 3, cfg.vision.image_size, cfg.vision.image_size
    ).astype(dtype)

    return {
        "input_ids": input_ids.astype(np.int32),
        "rope_pos_ids": rope_pos,
        "token_positions": token_positions,
        "segment_ids": seg,
        "targets": targets.astype(np.int32),
        "loss_weight": loss_weight,
        "pixel_values": pixel_values,
        "image_flags": np.ones((n_tiles,), np.int32),
        "vit_gather_idx": gather_idx,
    }
